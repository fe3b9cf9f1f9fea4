"""The frozen counts against hand counts and against the reference
modules' own shapes."""

import pytest
import torch
from torch import nn

from pb import counts, spec
from reference import model as ref

FPC = spec.load_json(spec.BENCH_DIR / "configs" / "graspldm-fpc-z4-pc64.json")
PPC = spec.load_json(spec.BENCH_DIR / "configs" / "graspldm-ppc-z16-pc256.json")


def test_fpc_denoiser_stage0_by_hand():
    n = counts.denoiser(FPC)  # L 4, C 4 -> 32, E 16, 4 heads x 32
    res = 16 * 2 * 4 + 2 * 4 * 3 * 4 * 4  # FiLM MLP + two k3 convs = 512
    attn = 4 * 4 * 3 * 128 + 2 * 4 * 4 * 128 + 4 * 128 * 4  # qkv, L x L products, out = 12288
    assert counts.stage_macs(n, 0) == 2 * res + attn + 4 * 3 * 4 * 32 == 14848
    assert counts.final_macs(n) == 16 * 2 * 256 + 2 * 4 * 3 * 256 * 256 + 4 * 256


def test_attention_takes_the_cheaper_order():
    # L = 16 < dim_head = 32: L x L scores (2 L^2 hd) beat the d x d context (2 L hd d)
    n = counts.decoder(FPC)
    assert counts.attention_macs(n, 32) == 16 * 32 * 384 + 2 * 16 * 16 * 128 + 16 * 128 * 32


def test_float32_peak_is_the_split():
    assert counts.PEAK_F32_FLOPS == pytest.approx(989e12 / 6)
    assert counts.least_time_s(989e12 / 6, 0) == pytest.approx(1.0)
    assert counts.least_time_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("cfg", [FPC, PPC], ids=["fpc", "ppc"])
def test_core_params_match_the_reference_modules(cfg):
    vae, ddm = ref.build(cfg, "cpu")

    def core(net):
        skip = ("time_mlp", "input_emb_layers")
        return sum(p.numel() for k, p in net.named_parameters() if not k.startswith(skip))

    assert counts.core_params(counts.denoiser(cfg)) == core(ddm)
    assert counts.core_params(counts.decoder(cfg)) == core(vae.decoder.net)


def _hooked_macs(module, x):
    """Multiply-adds of every Conv/Linear, from the shapes they produced."""
    total = [0]

    def hook(m, inp, out):
        w = m.weight
        total[0] += out.numel() // out.shape[0] * (w[0].numel() if not isinstance(m, nn.Linear)
                                                   else w.shape[1])

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, (nn.Conv1d, nn.Conv3d, nn.Linear))]
    with torch.no_grad():
        module(x)
    for h in hs:
        h.remove()
    return total[0]


@pytest.mark.parametrize("cfg", [FPC, PPC], ids=["fpc", "ppc"])
def test_pvcnn_flops_match_the_modules_shapes(cfg):
    vae, _ = ref.build(cfg, "cpu", with_denoiser=False)
    for p in vae.parameters():
        p.data.normal_()
    for b in vae.buffers():
        b.data.fill_(1)
    enc = vae.encoder.pc_encoder
    macs = _hooked_macs(enc, torch.randn(1, cfg["pc_num_points"], 3) * 0.01)
    N, extra = cfg["pc_num_points"], 0
    for m in enc.pvcnn_modules.point_features:
        if isinstance(m, ref.PVConv):
            conv = m.voxel_layers[0]
            cin, cout, r = conv.in_channels, conv.out_channels, m.resolution
            extra += N * cin + r ** 3 * cin + 2 * 8 * N * cout  # scatter-mean, devoxelize
    assert counts.pvcnn_flops(cfg) == 2 * macs + extra


def test_sampler_launch_counts():
    flops, nbytes = counts.sampler_launch(FPC, 16384, 100)
    n = counts.denoiser(FPC)
    assert flops == 2 * 100 * 16384 * (7 * 16 + counts.core_macs(n))
    assert nbytes > 4 * counts.core_params(n)


def test_call_flops_add_up():
    ldm = counts.call_flops(FPC, 16, 1024, 100)
    vae = counts.call_flops(FPC, 16, 1024, 0)
    den = counts.denoiser(FPC)
    assert ldm - vae == 2 * (16 * counts.cond_emb_macs(den) + 100 * counts.time_emb_macs(den)
                             + 100 * 16 * 1024 * counts.net_macs(den))
