#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's LDM grasp-generation path.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports only ``graspldm_tpu_torch`` (never JAX) and exits non-zero if
any phase fails:

1. print the card's name and power limit (``nvidia-smi``); CUDA is required;
2. build the kernels from ``graspldm_tpu_torch/csrc`` with ``nvcc``;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in float32 (TF32 off) and bfloat16, and time both
   with CUDA events;
4. drive the full-width fpc flagship (random weights from a seeded
   ``torch.Generator``): ``ldm_generate`` for 4 clouds x 1024 points, 1024
   grasps each, 100 DDIM steps, bfloat16 kernels (twice: the first call
   pays the one-time set-up), then ``vae_generate``;
5. serve 3 ``POST /v1/generate`` requests through ``GraspServer`` on an
   ephemeral localhost port;
6. hold a small float32 ``ldm_generate`` on the card against the same call
   on the CPU, where every kernel wrapper runs its plain version.

The kernel launch counts are zeroed just before phase 4 and read just after
phase 5. The second-to-last line is the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
B, N_POINTS, G, STEPS = 4, 1024, 1024, 100
BG = B * G  # rows every kernel sees on the main path
# float32: the kernel and the plain version do the same float32 math and
# differ only in summation order (~1e-6 relative measured); 1e-4 relative
# is far above that and far below any error in the math itself.
TOL_FP32 = 1e-4
# bfloat16 stage/final: both round activations to bf16 at the same points,
# but an fp32 sum that lands next to a rounding boundary can round the other
# way in one of them (1 ulp) and move what follows by about as much again:
# 4 ulps (2^-5 relative) of the output's largest magnitude.
TOL_BF16 = 2.0 ** -5
# bfloat16 sampler: such 1-ulp flips in eps recur over 100 steps and carry
# through the update; x_0 is clipped to [-1, 1]. 8 ulps at 1.0, absolute.
TOL_BF16_SAMPLER = 2.0 ** -4
# float32 end to end, card vs CPU: PVCNN (cuDNN vs CPU convolutions) and
# 100 sampler steps reorder sums; grasp entries are O(1).
TOL_E2E = 1e-3


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, tol_rel: float,
            absolute: bool = False) -> float:
    err = (got.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    tol = tol_rel if absolute else tol_rel * max(1.0, top)
    max_err = err.max().item()
    ok = bool(torch.isfinite(got.float()).all()) and max_err <= tol
    log(f"  {name}: max_abs_err {max_err:.3e} (rel {max_err / max(top, 1e-30):.3e}, "
        f"mean {err.mean().item():.3e}, max|ref| {top:.3f}) tol {tol:.3e} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_err


def build_models(dtype: str, seed: int = SEED):
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship

    gen = torch.Generator().manual_seed(seed)
    return build_flagship(FlagshipConfig(denoiser_dtype=dtype), generator=gen)


def kernel_phase(vae, ddm, diffusion, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.cuda_sampler import (
        sampler_apply, sampler_plain, sampler_tables,
    )
    from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for
    from graspldm_tpu_torch.models.stacked_cuda import (
        PackedNet, final_apply, final_plain, init_conv, stage_apply, stage_plain,
    )
    from graspldm_tpu_torch.models.stacked_denoiser import (
        compute_emb_s_stacked, compute_input_emb, pack_math_weights,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    z_pc = torch.randn((BG, 3, 64), generator=gen, device=dev)
    z_h = torch.randn((BG, 4), generator=gen, device=dev)
    x_T = torch.randn((BG, 4), generator=gen, device=dev)
    res = {k: {} for k in ("stage_kernel", "final_kernel", "ddim_sampler_kernel")}

    ddims = decoder_dims_for(vae)
    dec_math = pack_math_weights(vae.decoder.net, ddims)
    den_dims = _denoiser_dims(ddm)
    den_math = pack_math_weights(ddm, den_dims)
    dec = vae.decoder
    for dt in (torch.float32, torch.bfloat16):
        tag = "fp32" if dt == torch.float32 else "bf16"
        log(f"[kernels] {tag}, BG={BG}")
        w = PackedNet(dec_math, ddims, dt, dev)
        emb = compute_emb_s_stacked(w.aux, None, z_pc).to(dt)
        x_in = dec.in_layer(z_h)  # [BG, 16]
        x = init_conv(w, x_in).reshape(BG, -1).to(dt)
        errs, k_ms, p_ms = [], 0.0, 0.0
        stages = []
        for i in range(len(ddims.block_channels)):
            ref = stage_plain(w, i, x, emb)
            got = stage_apply(w, i, x, emb)
            torch.cuda.synchronize()
            C, Co = ddims.cins[i], ddims.block_channels[i]
            errs.append(compare(f"stage_kernel L=16 {C}->{Co}", got, ref,
                                TOL_FP32 if tag == "fp32" else TOL_BF16))
            stages.append((i, x))
            x = ref
        for i, xi in stages:
            k_ms += cuda_ms(lambda: stage_apply(w, i, xi, emb), 10)
            p_ms += cuda_ms(lambda: stage_plain(w, i, xi, emb), 3)
        res["stage_kernel"][tag] = dict(err=max(errs), ms=k_ms, plain_ms=p_ms)
        log(f"  stage_kernel, 4 launches of one decode: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms")

        ref = final_plain(w, x, emb)
        got = final_apply(w, x, emb)
        torch.cuda.synchronize()
        err = compare("final_kernel L=16 256->1", got, ref,
                      TOL_FP32 if tag == "fp32" else TOL_BF16)
        k_ms = cuda_ms(lambda: final_apply(w, x, emb), 10)
        p_ms = cuda_ms(lambda: final_plain(w, x, emb), 3)
        res["final_kernel"][tag] = dict(err=err, ms=k_ms, plain_ms=p_ms)
        log(f"  final_kernel: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")

        wd = PackedNet(den_math, den_dims, dt, dev)
        input_emb = compute_input_emb(wd.aux, z_pc)
        sched = diffusion.schedule
        for sampler in ("ddim", "ddpm"):
            embin, trows, coefs = sampler_tables(
                wd, sched, input_emb, STEPS, sampler, diffusion.variance_type)
            noise = (torch.randn((STEPS, BG, 4), generator=gen, device=dev)
                     if sampler == "ddpm" else None)
            args = (wd, x_T, embin, trows, coefs, noise)
            clip = (sched.clip_sample, sched.clip_sample_range)
            ref = sampler_plain(*args, *clip)
            got = sampler_apply(*args, *clip)
            torch.cuda.synchronize()
            err = compare(f"ddim_sampler_kernel {sampler} L=4 x {STEPS} steps", got, ref,
                          TOL_FP32 if tag == "fp32" else TOL_BF16_SAMPLER,
                          absolute=tag == "bf16")
            if sampler == "ddim":
                k_ms = cuda_ms(lambda: sampler_apply(*args, *clip), 3)
                p_ms = cuda_ms(lambda: sampler_plain(*args, *clip), 2)
                res["ddim_sampler_kernel"][tag] = dict(err=err, ms=k_ms, plain_ms=p_ms)
                log(f"  ddim_sampler_kernel ddim: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
            else:
                res["ddim_sampler_kernel"][tag]["err"] = max(
                    res["ddim_sampler_kernel"][tag]["err"], err)
    return res


def check_grasps(out: dict, b: int, g: int) -> None:
    H = out["grasps"]
    if tuple(H.shape) != (b, g, 4, 4):
        raise AssertionError(f"grasps shape {tuple(H.shape)} != {(b, g, 4, 4)}")
    if tuple(out["grasp_tmrp"].shape) != (b, g, 6) or tuple(out["confidence"].shape) != (b, g):
        raise AssertionError("grasp_tmrp / confidence shapes are wrong")
    for k, v in out.items():
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise AssertionError(f"{k} has non-finite values")
    H = torch.as_tensor(H).double().cpu()
    R = H[..., :3, :3]
    ortho = (R @ R.transpose(-1, -2) - torch.eye(3, dtype=R.dtype)).abs().max().item()
    det = (torch.linalg.det(R) - 1.0).abs().max().item()
    bottom = (H[..., 3, :] - torch.tensor([0, 0, 0, 1.0], dtype=H.dtype)).abs().max().item()
    conf = torch.as_tensor(out["confidence"])
    log(f"  |R R^T - I| {ortho:.2e}, |det R - 1| {det:.2e}, bottom row {bottom:.1e}, "
        f"confidence in [{conf.min().item():.3f}, {conf.max().item():.3f}]")
    if ortho > 1e-4 or det > 1e-4 or bottom != 0.0:
        raise AssertionError("rotation blocks are not orthonormal")


def counts() -> dict:
    from graspldm_tpu_torch.models.cuda_sampler import SAMPLER_KERNEL
    from graspldm_tpu_torch.models.stacked_cuda import FINAL_KERNEL, STAGE_KERNEL

    return {c.name: c.launches for c in (STAGE_KERNEL, FINAL_KERNEL, SAMPLER_KERNEL)}


def reset_counts() -> None:
    from graspldm_tpu_torch.models.cuda_sampler import SAMPLER_KERNEL
    from graspldm_tpu_torch.models.stacked_cuda import FINAL_KERNEL, STAGE_KERNEL

    for c in (STAGE_KERNEL, FINAL_KERNEL, SAMPLER_KERNEL):
        c.launches = 0


def expect_counts(phase: str, stage: int, final: int, sampler: int) -> None:
    c = counts()
    log(f"  launches so far: {c}")
    want = {"stage_kernel": stage, "final_kernel": final, "ddim_sampler_kernel": sampler}
    if c != want:
        raise AssertionError(f"{phase}: launch counts {c}, expected {want}")


def clouds(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """Metric clouds: a noisy box surface around a random centre."""
    pts = rng.uniform(-1.0, 1.0, size=(b, n, 3))
    axis = rng.integers(0, 3, size=(b, n))
    np.put_along_axis(pts, axis[..., None], np.sign(rng.uniform(-1, 1, (b, n, 1))), axis=-1)
    pts = pts * np.array([0.04, 0.03, 0.08]) + rng.normal(0.0, 0.001, size=pts.shape)
    return (pts + rng.uniform(-0.3, 0.3, size=(b, 1, 3))).astype(np.float32)


def generation_phase(vae, ddm, diffusion, dev) -> None:
    from graspldm_tpu_torch.inference.pipeline import ldm_generate, vae_generate
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    rng = np.random.default_rng(SEED)
    pc = torch.from_numpy(clouds(rng, B, N_POINTS)).to(dev)
    pc_n, _, meta = normalize_pc_and_grasps(pc, torch.zeros((B, 1, 6), device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    log(f"[ldm_generate] B={B} x N={N_POINTS}, G={G}, {STEPS} DDIM steps, bf16 kernels")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ldm_generate(vae, ddm, diffusion, pc_n, G, gen, num_inference_steps=STEPS,
                       sampler="ddim", meta=meta)
    torch.cuda.synchronize()
    log(f"  wall {time.perf_counter() - t0:.3f} s (first call: packing included)")
    check_grasps(out, B, G)
    expect_counts("ldm_generate", 4, 1, 1)
    t0 = time.perf_counter()
    ldm_generate(vae, ddm, diffusion, pc_n, G, gen, num_inference_steps=STEPS,
                 sampler="ddim", meta=meta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: vae.encode_pc(pc_n), 5)
    log(f"  second call: wall {wall:.3f} s (packing included); encode_pc alone "
        f"{enc_ms:.3f} ms (CUDA events)")
    expect_counts("ldm_generate x2", 8, 2, 2)

    log(f"[vae_generate] B={B}, G={G}")
    out = vae_generate(vae, pc_n, G, gen, meta=meta)
    torch.cuda.synchronize()
    check_grasps(out, B, G)
    expect_counts("vae_generate", 12, 3, 2)


def _post(url: str, body: dict, results: list, i: int) -> None:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = (r.status, json.loads(r.read()))
    except Exception as e:  # reported by the caller
        results[i] = (None, repr(e))


def server_phase(vae, ddm, diffusion, dev) -> None:
    from graspldm_tpu_torch.serving import (
        DynamicBatcher, GraspServer, make_batch_generate_from_parts,
    )

    log(f"[server] GraspServer, LDM mode, up to {G} grasps, {STEPS} DDIM steps")
    fn = make_batch_generate_from_parts(vae, ddm, diffusion, device=dev, num_grasps=G,
                                        num_inference_steps=STEPS, sampler="ddim", seed=SEED)
    batcher = DynamicBatcher(fn, num_points=N_POINTS, max_batch=4, max_wait_ms=50.0)
    server = GraspServer(batcher, host="127.0.0.1", port=0, info={"num_grasps": G})
    server.start_background()
    try:
        host, port = server.address[:2]
        url = f"http://{host}:{port}/v1/generate"
        rng = np.random.default_rng(SEED + 2)
        reqs = [(N_POINTS, G), (2 * N_POINTS, G // 4), (N_POINTS // 2, G // 16)]
        results = [None] * len(reqs)
        threads = [
            threading.Thread(target=_post, args=(
                url, {"points": clouds(rng, 1, n)[0].tolist(), "num_grasps": g}, results, i))
            for i, (n, g) in enumerate(reqs)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        log(f"  3 requests answered in {time.perf_counter() - t0:.3f} s wall")
        for (n, g), (status, body) in zip(reqs, results):
            if status != 200:
                raise AssertionError(f"request N={n}, G={g}: {status} {body}")
            out = {k: torch.tensor(body[k]) for k in ("grasps", "grasp_tmrp", "confidence")}
            if body["num_grasps"] != g:
                raise AssertionError("num_grasps echoed wrongly")
            check_grasps({k: v[None] for k, v in out.items()}, 1, g)
        log(f"  batcher stats: {json.dumps(batcher.stats())}")
    finally:
        server.shutdown()


def reference_phase(dev) -> None:
    """Small float32 generation on the card against the CPU's plain path."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    b, g = 1, 16
    log(f"[reference] fp32 ldm_generate B={b}, G={g}, {STEPS} DDIM steps: card vs CPU")
    vae, ddm, diffusion = build_models("float32")
    rng = np.random.default_rng(SEED + 3)
    pc = torch.from_numpy(clouds(rng, b, N_POINTS))
    pc_n, _, meta = normalize_pc_and_grasps(pc, torch.zeros((b, 1, 6)))
    x_T = torch.randn((b * g, 4), generator=torch.Generator().manual_seed(SEED + 4))
    want = ldm_generate(vae, ddm, diffusion, pc_n, g, num_inference_steps=STEPS,
                        meta=meta, x_T=x_T)
    vae_d, ddm_d = copy.deepcopy(vae).to(dev), copy.deepcopy(ddm).to(dev)
    meta_d = type(meta)(*(m.to(dev) for m in meta))
    got = ldm_generate(vae_d, ddm_d, diffusion, pc_n.to(dev), g, num_inference_steps=STEPS,
                       meta=meta_d, x_T=x_T.to(dev))
    for k in ("grasps", "grasp_tmrp", "confidence"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        log(f"  {k}: max_abs_err {err:.3e} tol {TOL_E2E:.0e}")
        if not err <= TOL_E2E:
            raise AssertionError(f"{k}: card and CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    from graspldm_tpu_torch.cuda_build import load_library

    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    vae, ddm, diffusion = build_models("bfloat16")
    vae, ddm = vae.to(dev), ddm.to(dev)
    kres = kernel_phase(vae, ddm, diffusion, dev)

    reset_counts()
    generation_phase(vae, ddm, diffusion, dev)
    server_phase(vae, ddm, diffusion, dev)
    launches = counts()
    log(f"[main path] launches: {launches}")
    if launches["final_kernel"] < 4 or launches["ddim_sampler_kernel"] < 3 \
            or launches["stage_kernel"] != 4 * launches["final_kernel"]:
        raise AssertionError(f"server requests did not run through the kernels: {launches}")

    reference_phase(dev)

    replaces = {
        "stage_kernel": "graspldm_tpu/models/stacked_pallas.py:900",
        "final_kernel": "graspldm_tpu/models/stacked_pallas.py:914",
        "ddim_sampler_kernel": "graspldm_tpu/models/pallas_sampler.py:482",
    }
    record = {"kernels": [
        {
            "name": name, "route": "cuda", "source": "graspldm_tpu_torch/csrc/kernels.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": kres[name]["bf16"]["err"],
            "ms": kres[name]["bf16"]["ms"], "plain_ms": kres[name]["bf16"]["plain_ms"],
            "dtype": "bfloat16", "BG": BG,
            "max_abs_err_fp32": kres[name]["fp32"]["err"],
            "ms_fp32": kres[name]["fp32"]["ms"], "plain_ms_fp32": kres[name]["fp32"]["plain_ms"],
        }
        for name in replaces
    ]}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
