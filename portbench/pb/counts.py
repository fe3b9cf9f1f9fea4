"""Operations and bytes of the generation path, from a configuration's
shapes alone (frozen yardstick; the arithmetic of ``chip_smoke.py``'s
``stage_macs`` / ``final_macs`` / ``bound``, computed from the
configuration's dims, not from the program's packed weights).

A product counts as 2 FLOPs (multiply and add). Where the algorithm leaves
the order of a product free, the cheaper order counts: the FiLM MLP runs
once on the sum of the conditioning channels (it is linear), and linear
attention's ``v (k^T q)`` takes ``min(2 L^2 hd, 2 L hd d)`` multiply-adds.
The time embedding counts once per timestep and the conditioning
embedding once per cloud, as neither depends on the grasp row.

The least time of float32 work is taken over the two ways the card can
compute a float32 product, for every product whatever computes it: one
FMA at the float32 rate, or the six bf16 products of the exact three-piece
bf16 split at the bf16 tensor-core rate. The split is the faster, so the
float32 peak is 989 / 6 = 164.8 TFLOP/s. Bytes count each input read once
and each output written once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SPLIT_PRODUCTS = 6
PEAK_F32_FLOPS = max(PEAK_FP32_FMA_FLOPS, PEAK_BF16_FLOPS / SPLIT_PRODUCTS)
F32 = 4  # bytes


@dataclasses.dataclass(frozen=True)
class Net:
    """Shapes of one conditional 1-D ResNet core."""

    L: int  # sequence length, also the init conv's output channels
    block_channels: Tuple[int, ...]
    E: int  # embedding width, 4 L
    Ce: int  # conditioning channels
    cond_dim: int
    time: bool  # a time MLP (the denoiser) or none (the decoder)
    fourier_dim: int = 16
    heads: int = 4
    dim_head: int = 32

    @property
    def cins(self) -> Tuple[int, ...]:
        return (self.L,) + tuple(self.block_channels[:-1])

    @property
    def hd(self) -> int:
        return self.heads * self.dim_head


def denoiser(cfg: dict) -> Net:
    L = cfg["grasp_latent_size"]
    return Net(L, tuple(cfg["block_channels"]), 4 * L, cfg["pc_latent_channels"],
               cfg["pc_latent_size"], True, cfg["learned_sinusoidal_dim"])


def decoder(cfg: dict) -> Net:
    L = cfg["intermediate_feature_resolution"]
    return Net(L, tuple(cfg["block_channels"]), 4 * L, cfg["pc_latent_channels"],
               cfg["pc_latent_size"], False)


def resblock_macs(n: Net, C: int) -> int:
    """FiLM MLP on the summed embedding, two k3 convs (per row)."""
    return n.E * 2 * C + 2 * n.L * 3 * C * C


def attention_macs(n: Net, C: int) -> int:
    """qkv projection, the cheaper order of the two attention products,
    output projection (per row)."""
    return n.L * C * 3 * n.hd + min(2 * n.L * n.L * n.hd, 2 * n.L * n.hd * n.dim_head) \
        + n.L * n.hd * C


def stage_macs(n: Net, i: int) -> int:
    C, Co = n.cins[i], n.block_channels[i]
    return 2 * resblock_macs(n, C) + attention_macs(n, C) + n.L * 3 * C * Co


def final_macs(n: Net) -> int:
    C = n.block_channels[-1]
    return resblock_macs(n, C) + n.L * C


def core_macs(n: Net) -> int:
    """Every stage and the final block, per row (the decode's kernels)."""
    return sum(stage_macs(n, i) for i in range(len(n.block_channels))) + final_macs(n)


def net_macs(n: Net) -> int:
    """One evaluation per row: the init conv (1 -> L channels, k7) and the core."""
    return 7 * n.L * n.L + core_macs(n)


def cond_emb_macs(n: Net) -> int:
    """The conditioning embedding, per cloud."""
    return n.Ce * n.cond_dim * n.E


def time_emb_macs(n: Net) -> int:
    """The time MLP, per timestep."""
    return (n.fourier_dim + 1) * n.E + n.E * n.E if n.time else 0


def core_params(n: Net) -> int:
    """Float32 parameters the core reads (init conv to final conv)."""
    p = 7 * n.L + n.L

    def resblock(C):
        return n.E * 2 * C + 2 * C + 2 * (3 * C * C + C + 2 * C)

    for C, Co in zip(n.cins, n.block_channels):
        p += 2 * resblock(C) + C + C * 3 * n.hd + n.hd * C + C + C + 3 * C * Co + Co
    C = n.block_channels[-1]
    return p + resblock(C) + C + 1


def pvcnn_flops(cfg: dict) -> int:
    """One cloud through the PVCNN encoder: Conv3d, the squeeze-and-excite
    MLP, 1x1 convs and the out layers as products; the scatter-mean as one
    add a point and channel and one divide a voxel and channel; trilinear
    devoxelization as 8 multiply-adds a point and channel."""
    N = cfg["pc_num_points"]
    chans = [int(b * cfg["pc_scale_channels"]) for b in (64, 128, 1024, 2048)]
    sv = cfg["pc_scale_voxel_resolution"]
    res = [int(32 * sv), int(16 * sv), None, None]
    flops, cin = 0, 3
    for cout, blocks, r in zip(chans, cfg["pc_num_blocks"], res):
        for _ in range(blocks):
            if r is not None:
                V = r ** 3
                macs = V * 27 * cin * cout + V * 27 * cout * cout + 2 * cout * (cout // 8) \
                    + 8 * N * cout
                flops += N * cin + V * cin
            else:
                macs = 0
            flops += 2 * (macs + N * cin * cout)
            cin = cout
    half, Ce = cin // 2, cfg["pc_latent_channels"]
    return flops + 2 * (N * cin * half + N * half * Ce + Ce * N * cfg["pc_latent_size"])


def decode_row_macs(cfg: dict) -> int:
    """One latent decoded: in-layer, core, heads (tmrp 6, logit 1)."""
    n = decoder(cfg)
    return cfg["grasp_latent_size"] * n.L + net_macs(n) + n.L * 7


def call_flops(cfg: dict, clouds: int, grasps: int, steps: int) -> int:
    """Model FLOPs of one generation call: encode, the conditioning
    embeddings, ``steps`` denoiser evaluations a row (0: VAE-prior mode,
    no denoiser), decode."""
    rows = clouds * grasps
    dec = decoder(cfg)
    macs = clouds * cond_emb_macs(dec) + rows * decode_row_macs(cfg)
    if steps:
        den = denoiser(cfg)
        macs += clouds * cond_emb_macs(den) + steps * time_emb_macs(den) \
            + steps * rows * net_macs(den)
    return clouds * pvcnn_flops(cfg) + 2 * macs


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time of float32 work: operations at ``PEAK_F32_FLOPS`` or
    bytes at ``PEAK_BYTES``, whichever is longer."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def sampler_launch(cfg: dict, rows: int, steps: int, draws: int = 0) -> Tuple[int, int]:
    """(FLOPs, bytes) of one whole-trajectory sampler launch: ``steps``
    evaluations of the network over ``rows`` rows; reads x_T, ``draws``
    noise draws a row, the per-row embedding, the per-step time rows and
    coefficients and the weights, writes x_0."""
    n = denoiser(cfg)
    flops = 2 * steps * rows * net_macs(n)
    nbytes = F32 * (rows * n.L * (1 + draws) + rows * n.Ce * n.E + steps * n.Ce * n.E
                    + steps * 8 + core_params(n) + rows * n.L)
    return flops, nbytes


def decode_core(cfg: dict, rows: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of the decoder core's kernels over ``rows`` rows:
    reads the init conv's output, the embedding and the weights, writes
    ``[rows, L]``."""
    n = decoder(cfg)
    flops = 2 * rows * core_macs(n)
    nbytes = F32 * (rows * n.L * n.L + rows * n.Ce * n.E + core_params(n) - 8 * n.L
                    + rows * n.L)
    return flops, nbytes
