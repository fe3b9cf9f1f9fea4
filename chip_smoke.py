#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's grasp-generation paths.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports only ``graspldm_tpu_torch`` (never JAX) and exits non-zero if
any phase fails (every phase runs; the failures are listed at the end):

1. print the card's name and power limit (``nvidia-smi``); CUDA is required;
2. build the kernels from ``graspldm_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card, in
   float32 (TF32 off) and bfloat16, and time both with CUDA events: the
   stage/final/DDIM kernels at the fpc flagship's shapes (BG = 4096 rows),
   ``dpmpp_sampler_kernel`` (32 steps) and ``churn_sampler_kernel`` (100
   steps) at fpc, and all three sampler kernels at the ppc denoiser's
   L = 16 (checked at BG = 1021 over 8 steps, then checked and timed at
   BG = 1024 with their full step counts); the EDM kernels' bf16 rounding
   points are also held over 2 steps at both, against bf16's own spread.
   Then the control: ``ddim_sampler_kernel``'s bf16 ms a step (its
   products on the tensor cores) beside ``dpmpp_sampler_kernel``'s (the
   same network on the CUDA cores), at fpc and ppc.
   The per-step kernels of the trajectory path (``ddim_step_kernel``,
   ``dpmpp_step_kernel``, ``churn_step_kernel``) are held the same way:
   over their first few chained steps against their plain steps at fpc
   (BG = 4096) and ppc (BG = 1024), both also at a ragged BG = 1021, timed
   per launch at BG = 4096 / 1024, and their whole chains (one launch per
   step) against the whole-trajectory kernels at the main paths' shapes;
4. the DDIM main path: the full-width fpc flagship (random weights from a
   seeded ``torch.Generator``), ``ldm_generate`` for 4 clouds x 1024
   points, 1024 grasps each, 100 DDIM steps, bf16 kernels (twice: the first
   call pays the one-time set-up), ``vae_generate``, 3
   ``POST /v1/generate`` requests through ``GraspServer`` on an ephemeral
   localhost port, and the ppc flagship (``z_pc [3, 256]``, latent 16)
   with DDIM at 100 steps for one cloud x 1024 grasps;
5. the EDM main path: the EDM fpc flagship, ``ldm_generate`` with
   DPM-Solver++(2M) at 32 steps and with churn at 100 steps (each twice),
   the EDM ppc flagship with DPM++ at 32 and churn at 100 steps for one
   cloud x 1024 grasps, and 3 requests through a second ``GraspServer``
   (DPM++, 32 steps);
6. the trajectory main path: ``ldm_generate(return_trajectory=True)`` on
   the fpc flagships (4 clouds x 1024 grasps; DDIM 100, DPM++ 32, churn
   100; each twice) and the ppc flagships (one cloud x 1024 grasps, the
   same samplers), bf16 kernels: every decoded state is checked, and each
   call's wall time is split into sampler, decode and the rest;
7. the guided and conditioned main path: the class-conditioned fpc
   flagship (``denoiser_dtype="bfloat16"``: a float32 denoiser, as
   conditioned denoisers always are, and a bf16 decoder), 4 clouds x 1024
   grasps, DDIM 100, once unguided (``ddim_sampler_kernel`` with the class
   embedding folded in) and once with ``cfg_scale=2`` (one ``full_kernel``
   launch per step over the doubled batch); the unconditional bf16 fpc
   flagship with success guidance (DDIM 100) and the EDM fpc flagship with
   success guidance (DPM++ 32); the region-conditioned EDM ppc flagship
   (128 region points) with ``cfg_scale=2`` (DPM++ 32, one cloud x 1024
   grasps); each call twice, its wall time split into denoiser launches,
   guidance VJPs and the rest; and 3 requests with a ``cls`` field to a
   class-conditioned ``GraspServer``; the success-guided calls take the
   decoder's VJP in bf16, as the JAX package does. Before the main paths,
   ``full_kernel`` is held against ``full_plain`` and against the chain of
   4 ``stage_kernel`` + ``final_kernel`` launches on the same operands, in
   float32 and bfloat16, at fpc BG = 4096 and 8192 (CFG), ppc BG = 1024
   and 2048 and a ragged BG = 1021, and once on a class-conditioned pack;
   the three are timed at the main path's shapes. Its float32 instance
   runs its products on the tensor cores through the exact bf16 split and
   is held against two controls on the same operands: its error within
   ``SPLIT_VS_CUDA_CORES`` times the float32 stage chain's (the CUDA
   cores), and a bf16 network's error above ``TOL_FP32``;
8. the PVCNN2 encoder path: ``fps_kernel`` against its plain version
   (equal indices) at the four SA shapes of ``PVCNN2Encoder`` (N -> M =
   1024 -> 1024, 1024 -> 256, 256 -> 64, 64 -> 16) at B = 16 and 128, at a
   ragged N and on clouds with duplicated points, each timed; then
   ``PVCNN2Encoder()`` at its defaults (seeded weights, BatchNorm running
   statistics drawn from the seed) on B = 16 clouds x 1024 points in
   float32, twice (4 ``fps_kernel`` launches a forward), then timed and
   profiled (device time by kernel); then the same weights on 2 of the
   clouds on the card against the CPU, selections first (see
   ``TOL_PVCNN2``), and once more with TF32 convolutions, a control the
   limit must fail;
9. the route with attention between launches
   (``stacked_cuda.XLA_ATTENTION``, patched on as a user would set it):
   before the main paths, ``hybrid_stage_kernel`` and
   ``hybrid_final_kernel`` against their plain versions at the decoder's
   BG = 4096 (float32 and bf16; ragged 1021 in bf16) and the ppc
   denoiser's BG = 1024 / 2048 / 1021 (region-conditioned in float32,
   unconditioned in bf16), timed, with each
   attention between launches timed, and the hybrid chain against the
   unsplit chain on the decoder's operands (bf16 limit: twice bf16's own
   spread), both timed; then the main path: the fpc flagship with DDIM
   100 (its decode is the hybrid chain) and the region-conditioned EDM
   ppc flagship with DPM++ 32 and CFG 2 (each evaluation one hybrid chain
   over 2048 rows), each twice, its wall time split into hybrid launches,
   attention between launches and the rest;
10. hold small float32 ``ldm_generate`` calls (DDIM, DPM++, churn, a DDIM
   trajectory; class CFG DDIM, success-guided DDPM, success-guided churn,
   region CFG DPM++, and CFG with success guidance; the hybrid region CFG
   DPM++) on the card against the same calls on the CPU, where every
   kernel wrapper runs its plain version; check that ``"auto"`` takes the
   kernels for every flagship above, and hold the plain-module route
   (``denoiser_impl="module"``, and a learned-sinusoidal denoiser) card
   against CPU with no denoiser kernel launched; and
   ``PVCNNEncoder(use_global_attention=True)`` at the fpc width, B = 4 x
   1024, card against CPU within ``TOL_PVCNN2``;
11. the micro-benchmark path (``graspldm_tpu_torch/tools``): before the
   main paths, ``mm_chain_kernel``, ``silu_chain_kernel`` and
   ``bcast_chain_kernel`` in each of their three forms against their
   plain versions at the tools' default R = 8192 (SiLU width 2048) and a
   ragged R = 1021, each timed beside its plain version, its one-rep time
   and one PyTorch library call (times the reps), after the SASS of every
   built library is read for tensor-core (HMMA) instructions: the three
   forms of ``mm_chain_kernel``, ``bcast_chain_kernel`` matmul, the bf16
   ``ddim_sampler_kernel`` and ``stage_kernel`` and both ``full_kernel``
   instances issue them, every other kernel none, and no kernel a TF32
   one; then the main
   path: each tool's timing function (the one its ``main()`` calls) at
   its defaults, its lines printed as ``main()`` prints them, every form's
   output held against its plain version.

The kernel launch counts are zeroed just before each main path (4 to 9
and 11) and read just after it; every call inside checks its exact counts, and
each launch is booked to the configuration (fpc or ppc) of its call. The
script prints its wall time, then the kernels' JSON record, then as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from unittest import mock

import numpy as np
import torch

SEED = 0
B, N_POINTS, G, STEPS = 4, 1024, 1024, 100
BG = B * G  # rows every kernel sees on the fpc main path
EDM_STEPS = {"dpmpp": 32, "churn": 100}
EDM_SHORT_STEPS = 2  # the EDM kernels' rounding-point check (see TOL_BF16_EDM_STEP_MEAN)
PPC = dict(pc_latent_size=256, grasp_latent_size=16)
PPC_BG_CHECK, PPC_STEPS_CHECK = 1021, 8  # ragged at 4 rows per block (bf16) and 2 (fp32)
PPC_BG = 1024
PPC_STEPS = {"ddim": 100, "dpmpp": 32, "churn": 100}
TRAJ_STEPS = {"ddim": 100, "dpmpp": 32, "churn": 100}  # the trajectory main path's
STEP_CHAIN = 3  # chained steps each per-step kernel is held over against its plain steps
RAGGED_BG = 1021  # ragged at every block size of the step kernels (16, 9, 4, 2 rows)
FULL_BG = {"fpc": (BG, 2 * BG), "ppc": (PPC_BG, 2 * PPC_BG)}  # guided rows: plain and CFG
CFG_SCALE, GUIDANCE_SCALE, REGION_POINTS = 2.0, 1.0, 128
# the hybrid kernels' main-path rows: the fpc decode, the ppc CFG evaluation
HYBRID_BG = {"fpc": BG, "ppc": 2 * PPC_BG}
HYBRID_WHAT = {"fpc": "decoder, attention between launches (4 stage launches)",
               "ppc": "ppc denoiser, attention between launches (main path: the "
                      "region-conditioned one in float32 with CFG; bf16: unconditioned)"}

# float32: the kernel and the plain version do the same float32 math and
# differ only in summation order (~1e-6 relative measured); 1e-4 relative
# is far above that and far below any error in the math itself.
TOL_FP32 = 1e-4
# bfloat16 stage/final: both round activations to bf16 at the same points,
# but an fp32 sum that lands next to a rounding boundary can round the other
# way in one of them (1 ulp) and move what follows by about as much again:
# 4 ulps (2^-5 relative) of the output's largest magnitude.
TOL_BF16 = 2.0 ** -5
# bfloat16 DDIM sampler: such 1-ulp flips in eps recur over 100 steps and
# carry through the update; x_0 is clipped to [-1, 1]. 8 ulps at 1.0,
# absolute.
TOL_BF16_SAMPLER = 2.0 ** -4
# bfloat16 EDM samplers, relative to max|x_0| (no clip). x starts at
# sigma_max = 80 and each step mixes the network's output into it. Where
# the kernel and its plain version round an fp32 sum to the other side of
# a bf16 boundary (1 ulp), that row's later roundings no longer match, and
# over a whole trajectory its distance grows toward the spread of bf16
# itself (plain bf16 vs plain fp32 on the same inputs; both are printed).
# On an H100 80GB HBM3 at 700 W the kernel read max 4.3e-3 / 1.2e-2
# (DPM++ 32 / churn 100, fpc), 3.8e-3 / 2.9e-3 (ppc) and up to 8.7e-3 over
# 8 steps at BG = 1021; mean 5.9e-5 / 1.7e-4 (fpc), 3.9e-4 / 4.0e-4 (ppc),
# up to 4.9e-4. The spread read max 2.6e-2 / 1.9e-2 and 6.4e-3 / 5.1e-3,
# mean 1.3e-3 / 1.6e-3 and 9.0e-4 / 8.4e-4. So at L = 16 the two come
# within a factor of about 2 over a whole trajectory, and no limit there
# separates the kernel from one that ran its network in fp32. These two
# catch a wrong update, table or row (O(1)) and keep the kernel inside
# bf16's own noise:
TOL_BF16_EDM = 2.0 ** -4  # largest error (5x the largest reading)
TOL_BF16_EDM_MEAN = 2.0 ** -9  # mean error (4x the largest reading)
# The rounding points are held on EDM_SHORT_STEPS-step trajectories,
# before flips spread. On an H100 80GB HBM3 at 700 W the kernel's mean
# error read 2.8e-5 / 4.3e-5 (DPM++ / churn, fpc) and 1.2e-4 / 2.9e-4
# (ppc) there, the spread 4.7e-3 / 2.1e-3 and 3.1e-3 / 1.9e-3. The
# script fails if a spread is not above this limit, i.e. if a kernel that
# ran its network in fp32 would pass. (Only bf16 is held there: a 2-step
# churn divides by sigma_min = 0.002 in its Heun step, so x_0 carries
# about 2e4 times any difference in the network's output, fp32's too.)
TOL_BF16_EDM_STEP_MEAN = 2.0 ** -10.5  # mean error
# The per-step kernels in bfloat16, over their first STEP_CHAIN chained
# steps against their plain steps: largest error TOL_BF16_SAMPLER
# (DDIM/DDPM) or TOL_BF16_EDM, and a mean error relative to max|state|
# that only the same rounding points meet. On an H100 80GB HBM3 at 700 W
# the kernels' mean read at most 4.6e-7 / 2.1e-7 / 4.3e-8 (DDIM / DPM++ /
# churn) and bf16's own spread over the same steps at least 7.0e-6 /
# 4.2e-6 / 9.3e-7 (churn's first steps at sigma_max barely move x, so
# both are smaller there). Each limit lies 4-9x above the kernel and 2-4x
# below the spread; as above, the script fails unless the spread lies
# above it.
TOL_BF16_STEP_MEAN = {"ddim": 2.0 ** -19, "dpmpp": 2.0 ** -19, "churn": 2.0 ** -22}
# full_kernel<float> runs its products on the tensor cores through the exact
# bf16 split (csrc/tc_blocks.cuh). Its error against full_plain must stay
# within this many times the error of the float32 stage chain (the same
# function on the CUDA cores: stage_kernel<float> x 4 + final_kernel<float>)
# on the same operands, the CUDA-core control; and a plain version with its
# weights and stored activations rounded to bf16 must land above TOL_FP32
# against full_plain, or TOL_FP32 would not tell a bf16 network from a
# float32 one.
SPLIT_VS_CUDA_CORES = 4.0
# float32 end to end, card vs CPU: PVCNN (cuDNN vs CPU convolutions) and
# the sampler's steps reorder sums; grasp entries are O(1).
TOL_E2E = 1e-3

# PVCNN2Encoder's set-abstraction stages (N -> M), each one fps_kernel launch
FPS_SHAPES = ((1024, 1024), (1024, 256), (256, 64), (64, 16))
FPS_B = (16, 128)
PVCNN2_B, PVCNN2_CHECK_B = 16, 2
# PVCNN2Encoder, card vs CPU (float32, TF32 off), on the same weights and
# clouds. The discrete selections are compared first, and the CPU run then
# follows the card's selections, so the features compare the arithmetic:
# * FPS and ball query do the same IEEE float32 operations (subtract,
#   multiply, add, compare; fps_kernel without FMA contraction) on the same
#   raw coordinates on both sides, so their indices must be equal: no flip
#   is allowed;
# * the 3-NN picks come from the |a|^2 - 2ab + |b|^2 expansion, whose
#   products are summed in another order on the card: a pick may flip
#   only at a true near-tie, where the two candidates' exact (float64)
#   squared distances differ by at most NEAR_TIE_3NN;
# * the voxel coordinates (mean and radius are reductions) must agree to
#   TOL_VOX voxel units, and avg_voxelize's rounding may flip only where
#   the coordinate lies within TOL_VOX of a half-integer.
# Every flip is counted and printed. The output must then agree to
# TOL_PVCNN2 of its largest magnitude: PVConv's Conv3d (cuDNN vs the CPU),
# the 1x1 convolutions and BatchNorm reorder float32 sums through 8 PVConvs
# and 8 SA/FP MLPs; on the H100 this read 9.0e-6. The same run with TF32
# convolutions, the nearest lower precision, read 1.1e-3 (both NVIDIA H100
# 80GB HBM3, 700 W). 1e-4 lies 11x from each, and the phase runs that TF32
# control and fails unless it lands above the limit.
NEAR_TIE_3NN = 1e-5
TOL_VOX = 1e-4
TOL_PVCNN2 = 1e-4

# The micro-benchmark entry points at the JAX tools' defaults (R rows, SiLU
# width), a ragged R that the TPU grid (R // 512 blocks) would cut short,
# and the tools' timed calls a form.
MB_R, MB_RAGGED, MB_W, MB_ITERS = 8192, 1021, 2048, 10
# mm_chain_kernel against its plain version, relative to max|ref|: the same
# exact products summed in float32 in another order (the reps inside the K
# loop in the kernel, rep by rep in the plain version). On an H100 80GB
# HBM3 at 700 W this read up to 7.8e-7 (f32), 4.2e-7 (bf16) and 7.1e-7
# (split), every form on the tensor cores.
# The bf16 chains (silu_chain_kernel, bcast_chain_kernel) are held bitwise:
# every op is one rounding of the same float32 value in the kernel and in
# the plain version (measured: no entry differs, at R = 8192 and 1021).
TOL_MM = 1e-5
# mm_chain_kernel on a dense normal pool (pb = bf16(pf)), relative to
# max|ref|: the terms have both signs, so the sums cancel (max|ref| about
# 4800 against 23700 for the sum of |terms|), and the kernel adds 12 x 1024
# products (split: twice as many, f32: five times) into one float32
# accumulator an output and K half, rep inside the K loop. On an H100 80GB
# HBM3 at 700 W this read up to 5.3e-5 (f32), 1.9e-5 (bf16) and 3.4e-5
# (split); a k-mapping fault inside an mma k-step (x's k = 2t read twice,
# or the a0 and a2 fragments swapped) reads 0.9 and 1.1 (float64 on the
# CPU, R = 1021). 2e-4 lies 4x above the first and 4500x below the second.
# Each run also logs the kernel's and the plain version's (cuBLAS float32
# products) error against the float64 product.
TOL_MM_DENSE = 2e-4
# A chain whose reps the compiler folded would take about its one-rep time:
# the full chain must take at least this many times as long (the least
# ratio read was 1.8, mm_chain_kernel bf16, whose one rep is mostly loads).
MIN_REPS_RATIO = 1.3
# Hopper's special-function units: 16 exp / reciprocal results per SM and
# clock (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0; the data sheet gives no such peak). The SiLU
# chains do 2 such operations an element and rep; their bound counts them
# at this rate times the SMs and the card's top SM clock.
SFU_PER_SM_CLK = 16

# the card's published peaks (NVIDIA H100 SXM data sheet, dense) for the
# bound: bf16 products on the tensor cores, fp32 on the CUDA cores, and HBM
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

_PS = "graspldm_tpu/models/pallas_sampler.py"
REPLACES = {
    "fps_kernel": "graspldm_tpu/ops/pallas_fps.py:27",
    "stage_kernel": "graspldm_tpu/models/stacked_pallas.py:900",
    "final_kernel": "graspldm_tpu/models/stacked_pallas.py:914",
    "full_kernel": "graspldm_tpu/models/stacked_pallas.py:826",
    "hybrid_stage_kernel": "graspldm_tpu/models/stacked_pallas.py:1004",
    "hybrid_final_kernel": "graspldm_tpu/models/stacked_pallas.py:1019",
    "ddim_sampler_kernel": f"{_PS}:482",
    "dpmpp_sampler_kernel": f"{_PS}:513",
    "churn_sampler_kernel": f"{_PS}:535",
    # each per-step kernel stands for the one-launch step and for the chain
    "ddim_step_kernel": f"{_PS}:156 _full_step_kernel; {_PS}:79 _stage0_kernel, "
                        f"{_PS}:94 _mid_stage_kernel, {_PS}:181 _final_step_kernel",
    "dpmpp_step_kernel": f"{_PS}:270 _full_dpmpp_kernel; {_PS}:210 _stage0_dpmpp_kernel, "
                         f"{_PS}:94 _mid_stage_kernel, {_PS}:253 _final_dpmpp_kernel",
    "churn_step_kernel": f"{_PS}:441 _full_churn_kernel; {_PS}:320 _stage0_churn_a_kernel, "
                         f"{_PS}:94 _mid_stage_kernel, {_PS}:358 _final_churn_a_kernel, "
                         f"{_PS}:210 _stage0_dpmpp_kernel, {_PS}:399 _final_churn_b_kernel",
    "mm_chain_kernel": "tools/bench_mm.py:35 make_kernel (pallas_call :84)",
    "silu_chain_kernel": "tools/bench_silu.py:31 make_kernel (pallas_call :60)",
    "bcast_chain_kernel": "tools/bench_repeat.py:46 make_kernel (pallas_call :94)",
}
SOURCES = {
    "fps_kernel": "graspldm_tpu_torch/csrc/fps.cu",
    "stage_kernel": "graspldm_tpu_torch/csrc/kernels.cu",
    "final_kernel": "graspldm_tpu_torch/csrc/kernels.cu",
    "full_kernel": "graspldm_tpu_torch/csrc/full_net.cu",
    "hybrid_stage_kernel": "graspldm_tpu_torch/csrc/hybrid.cu",
    "hybrid_final_kernel": "graspldm_tpu_torch/csrc/hybrid.cu",
    "ddim_sampler_kernel": "graspldm_tpu_torch/csrc/kernels.cu",
    "dpmpp_sampler_kernel": "graspldm_tpu_torch/csrc/dpmpp_sampler.cu",
    "churn_sampler_kernel": "graspldm_tpu_torch/csrc/churn_sampler.cu",
    "ddim_step_kernel": "graspldm_tpu_torch/csrc/step_samplers.cu",
    "dpmpp_step_kernel": "graspldm_tpu_torch/csrc/step_samplers.cu",
    "churn_step_kernel": "graspldm_tpu_torch/csrc/step_samplers.cu",
    "mm_chain_kernel": "graspldm_tpu_torch/csrc/microbench.cu",
    "silu_chain_kernel": "graspldm_tpu_torch/csrc/microbench.cu",
    "bcast_chain_kernel": "graspldm_tpu_torch/csrc/microbench.cu",
}
STEP_KERNEL = {"ddim": "ddim_step_kernel", "dpmpp": "dpmpp_step_kernel",
               "churn": "churn_step_kernel"}


def log(*a) -> None:
    print(*a, flush=True)


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


def counters():
    from graspldm_tpu_torch.models import cuda_sampler as cs
    from graspldm_tpu_torch.models import stacked_cuda as sc
    from graspldm_tpu_torch.ops import cuda_fps

    tools = mb_tools()
    return (sc.STAGE_KERNEL, sc.FINAL_KERNEL, sc.FULL_KERNEL, sc.HYBRID_STAGE_KERNEL,
            sc.HYBRID_FINAL_KERNEL, cs.SAMPLER_KERNEL,
            cs.DPMPP_KERNEL, cs.CHURN_KERNEL, cs.DDIM_STEP_KERNEL, cs.DPMPP_STEP_KERNEL,
            cs.CHURN_STEP_KERNEL, cuda_fps.FPS_KERNEL, tools["mm"].MM_CHAIN_KERNEL,
            tools["silu"].SILU_CHAIN_KERNEL, tools["repeat"].BCAST_CHAIN_KERNEL)


def counts() -> dict:
    return {c.name: c.launches for c in counters()}


class Run:
    """What one run of this script gathers: the checks that failed, the
    kernels' measurements (one record per kernel and shape) and the launch
    counts the current main path must have reached."""

    def __init__(self):
        self.failures: list = []
        self.records: dict = {}  # (name, config) -> {"L", "BG", "steps", "fp32": {}, "bf16": {}}
        self.expected: dict = {}
        self.paths: list = []
        self.launches: dict = {}  # (main path, kernel, config) -> launches
        self.per_call: dict = {}  # (kernel, config) -> {checked call: launches per call}

    def compare(self, name: str, got: torch.Tensor, ref: torch.Tensor, tol_rel: float,
                tol_mean: float | None = None, absolute: bool = False) -> float:
        """Max and (given ``tol_mean``) mean error against limits relative
        to max|ref| (``absolute``: the limit itself); returns the max."""
        err = (got.float() - ref.float()).abs()
        top = ref.float().abs().max().item()
        scale = 1.0 if absolute else max(1.0, top)
        max_err, mean_err = err.max().item(), err.mean().item()
        ok = bool(torch.isfinite(got.float()).all()) and max_err <= tol_rel * scale
        if tol_mean is not None:
            ok = ok and mean_err <= tol_mean * scale
        log(f"  {name}: max_abs_err {max_err:.3e} (rel {max_err / max(top, 1e-30):.3e}, "
            f"mean {mean_err:.3e}, mean rel {mean_err / max(top, 1e-30):.3e}, "
            f"max|ref| {top:.3f}) tol {tol_rel * scale:.3e}"
            + (f", mean tol {tol_mean * scale:.3e}" if tol_mean is not None else "")
            + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name}: kernel disagrees with its plain version")
        return max_err

    def record(self, name: str, config: str, L: int, BG_: int, steps, tag: str,
               what: str | None = None, **res) -> dict:
        r = self.records.setdefault((name, config), dict(L=L, BG=BG_, steps=steps, what=what))
        r.setdefault(tag, {}).update(res)
        return r[tag]

    def reset_counts(self, path: str) -> None:
        for c in counters():
            c.launches = 0
        self.paths.append(path)
        self.expected = counts()
        self.seen = counts()

    def expect_more(self, phase: str, config: str, calls: int = 1, **more) -> None:
        """Exact counts: the ones so far plus ``more`` (every other count
        unchanged) for ``calls`` calls of ``phase``; the launches since the
        last check are booked to ``config``, and ``more / calls`` is kept
        as each kernel's launches per call of ``phase``."""
        for k, v in more.items():
            self.expected[k] += v
            if v:
                self.per_call.setdefault((k, config), {})[phase] = v // calls
        c = counts()
        log(f"  launches so far: {c}")
        for k, n in c.items():
            key = (self.paths[-1], k, config)
            self.launches[key] = self.launches.get(key, 0) + n - self.seen[k]
        self.seen = c
        if c != self.expected:
            raise AssertionError(f"{phase}: launch counts {c}, expected {self.expected}")

    def phase(self, name: str, fn, *args) -> None:
        """Run one phase; a failure is logged and listed, and the run goes on."""
        try:
            fn(self, *args)
        except Exception:
            log(f"[{name}] FAILED:\n{traceback.format_exc()}")
            self.failures.append(f"phase {name} raised")


def spread(run: Run, name: str, bf16: torch.Tensor, fp32: torch.Tensor,
           mean_limit: float | None = None) -> dict:
    """How far bf16 itself moves a result: plain bf16 vs plain fp32, max and
    mean, relative to max|fp32|. Given ``mean_limit`` (a kernel's bf16
    mean limit), the mean must lie above it: else a kernel that ran its
    network in fp32 would pass."""
    top = max(fp32.abs().max().item(), 1e-30)
    d = (bf16 - fp32).abs()
    res = dict(max_rel=d.max().item() / top, mean_rel=d.mean().item() / top)
    caught = mean_limit is None or res["mean_rel"] > mean_limit
    log(f"  {name}: plain bf16 vs plain fp32 max rel {res['max_rel']:.3e}, mean rel "
        f"{res['mean_rel']:.3e} of max|fp32| {top:.3f}"
        + ("" if mean_limit is None else
           f"; above the mean limit {mean_limit:.3e}: {'yes' if caught else 'NO'}"))
    if not caught:
        run.failures.append(f"{name}: the bf16 limit would pass an fp32 network")
    return res


# ---------------------------------------------------------------------------
# work and bytes from the shapes, for the bound
# ---------------------------------------------------------------------------

HD = 4 * 32  # heads x head channels of every attention


def stage_macs(d, i: int) -> int:
    """Multiply-adds of network stage ``i`` for one row (products only)."""
    L, E, C, Co = d.seq_len, d.emb_dim, d.cins[i], d.block_channels[i]
    res = E * 2 * C + 2 * L * 3 * C * C
    attn = L * C * 3 * HD + 2 * L * L * HD + L * HD * C
    return 2 * res + attn + L * 3 * C * Co


def final_macs(d) -> int:
    L, E, C = d.seq_len, d.emb_dim, d.block_channels[-1]
    return E * 2 * C + 2 * L * 3 * C * C + L * C


def full_macs(d) -> int:
    """Every stage and the final block for one row: ``full_kernel``'s work."""
    return sum(stage_macs(d, i) for i in range(len(d.block_channels))) + final_macs(d)


def tc_macs(d) -> int:
    """The multiply-adds of ``full_macs`` that the tensor-core network body
    runs on the tensor cores (the k3 convs and projections, wqkv and wo);
    the FiLM MLPs, the L x L scores and values and the head stay on the CUDA
    cores."""
    L, n = d.seq_len, 0
    for C, Co in zip(d.cins, d.block_channels):
        n += 4 * L * 3 * C * C + L * C * 3 * HD + L * HD * C + L * 3 * C * Co
    return n + 2 * L * 3 * d.block_channels[-1] ** 2


def full_bound(w, bg: int, nbytes_: int) -> dict:
    """``full_kernel``'s bound over ``bg`` rows. bf16: every product at the
    bf16 peak. float32: the least over the two ways the card can compute the
    float32 function (``mb_bound``): every product as float32 FMAs, or the
    tensor-core products as the six exact bf16 products of the split with
    the rest as float32 FMAs."""
    flops, tc = 2.0 * full_macs(w.dims) * bg, 2.0 * tc_macs(w.dims) * bg
    if w.dtype == torch.bfloat16:
        return bound(flops, nbytes_, "bf16")
    return mb_bound([{"fp32": flops}, {"bf16": 6 * tc, "fp32": flops - tc}], nbytes_, PEAK_FLOPS)


def net_macs(d) -> int:
    """One evaluation of the whole network for one row (init conv included)."""
    return 7 * d.seq_len * d.cins[0] + full_macs(d)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(flops: float, nbytes_: int, tag: str) -> dict:
    t_ops, t_mem = flops / PEAK_FLOPS[tag], nbytes_ / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes", flops=flops,
                bytes=nbytes_)


def sampler_bound(w, evals: int, BG_: int, tag: str, *operands) -> dict:
    """``evals`` network evaluations per row over BG_ rows; each operand
    (and the weights, and the [BG_, L] fp32 output) moved once."""
    out = BG_ * w.dims.seq_len * 4
    return bound(2.0 * net_macs(w.dims) * evals * BG_,
                 nbytes(w.math_flat, w.layout, *operands) + out, tag)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def build_models(dtype: str, device, seed: int = SEED, **cfg):
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship

    gen = torch.Generator().manual_seed(seed)
    return build_flagship(FlagshipConfig(denoiser_dtype=dtype, **cfg), generator=gen,
                          device=device)


def tag_of(dt) -> str:
    return "fp32" if dt == torch.float32 else "bf16"


def kernel_phase(run: Run, vae, ddm, diffusion, dev) -> None:
    """stage/final/DDIM kernels against their plain versions at fpc shapes."""
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

    ddims = decoder_dims_for(vae)
    dec_math = pack_math_weights(vae.decoder.net, ddims)
    den_dims = _denoiser_dims(ddm)
    den_math = pack_math_weights(ddm, den_dims)
    dec = vae.decoder
    for dt in (torch.float32, torch.bfloat16):
        tag = tag_of(dt)
        log(f"[kernels] fpc {tag}, BG={BG}")
        w = PackedNet(dec_math, ddims, dt, dev)
        emb = compute_emb_s_stacked(w.aux, None, z_pc).to(dt)
        x_in = dec.in_layer(z_h)  # [BG, 16]
        x = init_conv(w, x_in).reshape(BG, -1).to(dt)
        errs, k_ms, p_ms = [], 0.0, 0.0
        stages, flops, moved = [], 0.0, 0
        for i in range(len(ddims.block_channels)):
            ref = stage_plain(w, i, x, emb)
            got = stage_apply(w, i, x, emb)
            torch.cuda.synchronize()
            C, Co = ddims.cins[i], ddims.block_channels[i]
            errs.append(run.compare(f"stage_kernel L=16 {C}->{Co}", got, ref,
                                    TOL_FP32 if tag == "fp32" else TOL_BF16))
            stages.append((i, x))
            flops += 2.0 * stage_macs(ddims, i) * BG
            moved += nbytes(x, emb, ref, *(t for k, t in w.w.items() if k.startswith(f"b{i}")))
            x = ref
        for i, xi in stages:
            k_ms += cuda_ms(lambda: stage_apply(w, i, xi, emb), 10)
            p_ms += cuda_ms(lambda: stage_plain(w, i, xi, emb), 3)
        run.record("stage_kernel", "fpc", 16, BG, None, tag, what="decoder, 4 launches",
                   err=max(errs), ms=k_ms, plain_ms=p_ms, **bound(flops, moved, tag))
        log(f"  stage_kernel, 4 launches of one decode: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms")

        ref = final_plain(w, x, emb)
        got = final_apply(w, x, emb)
        torch.cuda.synchronize()
        err = run.compare("final_kernel L=16 256->1", got, ref,
                          TOL_FP32 if tag == "fp32" else TOL_BF16)
        k_ms = cuda_ms(lambda: final_apply(w, x, emb), 10)
        p_ms = cuda_ms(lambda: final_plain(w, x, emb), 3)
        moved = nbytes(x, emb, ref, *(t for k, t in w.w.items() if k.startswith("final")))
        run.record("final_kernel", "fpc", 16, BG, None, tag, what="decoder", err=err, ms=k_ms,
                   plain_ms=p_ms, **bound(2.0 * final_macs(ddims) * BG, moved, tag))
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
            err = run.compare(f"ddim_sampler_kernel {sampler} L=4 x {STEPS} steps", got, ref,
                              TOL_FP32 if tag == "fp32" else TOL_BF16_SAMPLER,
                              absolute=tag == "bf16")
            if sampler == "ddim":
                k_ms = cuda_ms(lambda: sampler_apply(*args, *clip), 3)
                p_ms = cuda_ms(lambda: sampler_plain(*args, *clip), 2)
                run.record("ddim_sampler_kernel", "fpc", 4, BG, STEPS, tag, err=err, ms=k_ms,
                           plain_ms=p_ms, **sampler_bound(wd, STEPS, BG, tag, x_T, embin,
                                                           trows, coefs))
                log(f"  ddim_sampler_kernel ddim: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
            else:
                r = run.records[("ddim_sampler_kernel", "fpc")][tag]
                r["err"] = max(r["err"], err)


def control_phase(run: Run) -> None:
    """bf16 ``ddim_sampler_kernel`` (tensor cores) beside
    ``dpmpp_sampler_kernel`` (the same network on the CUDA cores), ms a
    step, at fpc and ppc, from the kernel phases' timings of this run."""
    steps = {("ddim_sampler_kernel", "fpc"): STEPS, ("ddim_sampler_kernel", "ppc"): PPC_STEPS["ddim"],
             ("dpmpp_sampler_kernel", "fpc"): EDM_STEPS["dpmpp"],
             ("dpmpp_sampler_kernel", "ppc"): PPC_STEPS["dpmpp"]}
    for config in ("fpc", "ppc"):
        ddim, dpmpp = (run.records[(k, config)]["bf16"] for k in
                       ("ddim_sampler_kernel", "dpmpp_sampler_kernel"))
        a = ddim["ms"] / steps[("ddim_sampler_kernel", config)]
        b = dpmpp["ms"] / steps[("dpmpp_sampler_kernel", config)]
        ddim["vs_dpmpp_per_step"] = a / b
        log(f"[control] {config} bf16: ddim_sampler_kernel {a:.4f} ms a step (tensor cores), "
            f"dpmpp_sampler_kernel {b:.4f} ms a step (CUDA cores): {a / b:.3f} of it")


def sampler_runs(w, ed, input_emb, x_unit, noise, steps: dict, sched=None):
    """(name, kind, kernel call, plain call, evaluations per row, operands)
    for the EDM kernels and, given a DDPM schedule, the DDIM kernel, over
    the rows of ``x_unit`` (unit normals; EDM starts at sigma_max times it).
    Churn needs 2N - 1 network evaluations: the last step's second one
    cannot reach x_0 (sigma_next = 0). The kernel runs it anyway
    (csrc/churn_sampler.cu says why); the bound counts only what is needed."""
    from graspldm_tpu_torch.models import cuda_sampler as cs

    x_edm = (ed.sigma_max * x_unit).contiguous()
    dp = cs.dpmpp_tables(w, ed, input_emb, steps["dpmpp"])
    ch = cs.churn_tables(w, ed, input_emb, steps["churn"])
    nz = noise[: steps["churn"]]
    runs = [
        ("dpmpp_sampler_kernel", "dpmpp", lambda: cs.dpmpp_sampler_apply(w, x_edm, *dp),
         lambda: cs.dpmpp_sampler_plain(w, x_edm, *dp, False), steps["dpmpp"], (x_edm, *dp)),
        ("churn_sampler_kernel", "churn", lambda: cs.churn_sampler_apply(w, x_edm, *ch, nz),
         lambda: cs.churn_sampler_plain(w, x_edm, *ch, nz, False), 2 * steps["churn"] - 1,
         (x_edm, *ch, nz)),
    ]
    if sched is not None and "ddim" in steps:
        S = steps["ddim"]
        tb = cs.sampler_tables(w, sched, input_emb, S, "ddim", "fixed_large")
        runs.insert(0, ("ddim_sampler_kernel", "ddim", lambda: cs.sampler_apply(w, x_unit, *tb),
                        lambda: cs.sampler_plain(w, x_unit, *tb, None, True, 1.0), S,
                        (x_unit, *tb)))
    return runs


def hold(run: Run, w, runs, steps: dict, config: str, bg: int, mode: str, refs: dict,
         full_bg: int, full_steps: dict) -> None:
    """Each sampler kernel of ``runs`` (from :func:`sampler_runs` over ``bg``
    rows, ``steps`` per kind) against its plain version. ``mode``: "full"
    (the record's own shape: also timed, and the bf16 spread printed),
    "ragged" (a ragged BG) or "short" (the EDM rounding-point check, bf16
    only). float32 runs first and leaves its plain results in ``refs``."""
    L, tag = w.dims.seq_len, tag_of(w.dtype)
    for name, kind, kern, plain, evals, ops in runs:
        ref = plain()
        if mode == "short" and tag == "fp32":
            refs[(name, mode)] = ref  # the spread's reference only (see TOL_BF16_EDM_STEP_MEAN)
            continue
        got = kern()
        torch.cuda.synchronize()
        ddim = kind == "ddim"
        if tag == "fp32":
            tols = (TOL_FP32, None)
        elif ddim:
            tols = (TOL_BF16_SAMPLER, None)
        else:
            tols = (TOL_BF16_EDM, TOL_BF16_EDM_STEP_MEAN if mode == "short" else TOL_BF16_EDM_MEAN)
        err = run.compare(f"{name} {config} L={L} BG={bg} x {steps[kind]} steps", got, ref,
                          *tols, absolute=tag == "bf16" and ddim)
        r = run.record(name, config, L, full_bg, full_steps[kind], tag)
        r.setdefault("err_checked_at", []).append(dict(BG=bg, steps=steps[kind], max_abs_err=err))
        if mode == "full":
            r["err"] = err
        if tag == "fp32":
            refs[(name, mode)] = ref
        elif mode != "ragged":
            key = "bf16_vs_fp32_plain" + ("_short" if mode == "short" else "")
            r[key] = spread(run, name, ref, refs[(name, mode)],
                            TOL_BF16_EDM_STEP_MEAN if mode == "short" else None)
        if mode == "full":
            k_ms = cuda_ms(kern, 3)
            p_ms = cuda_ms(plain, 2)
            r.update(ms=k_ms, plain_ms=p_ms, **sampler_bound(w, evals, bg, tag, *ops))
            log(f"  {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")


def edm_kernel_phase(run: Run, ddm, ed, dev) -> None:
    """The two EDM kernels against their plain versions at fpc shapes."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet
    from graspldm_tpu_torch.models.stacked_denoiser import compute_input_emb, pack_math_weights

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    dims = _denoiser_dims(ddm)
    math_w = pack_math_weights(ddm, dims)
    z_pc = torch.randn((BG, 3, dims.cond_dim), generator=gen, device=dev)
    x_unit = torch.randn((BG, dims.seq_len), generator=gen, device=dev)
    noise = torch.randn((EDM_STEPS["churn"], BG, dims.seq_len), generator=gen, device=dev)
    short = dict.fromkeys(EDM_STEPS, EDM_SHORT_STEPS)
    refs = {}
    for dt in (torch.float32, torch.bfloat16):
        w = PackedNet(math_w, dims, dt, dev)
        input_emb = compute_input_emb(w.aux, z_pc)
        for steps, mode in ((EDM_STEPS, "full"), (short, "short")):
            log(f"[kernels] EDM fpc {tag_of(dt)}, BG={BG}, {mode}")
            hold(run, w, sampler_runs(w, ed, input_emb, x_unit, noise, steps), steps, "fpc", BG,
                 mode, refs, BG, EDM_STEPS)


def ppc_kernel_phase(run: Run, ddm, ed, sched, dev) -> None:
    """All three sampler kernels at the ppc denoiser's L = 16 against their
    plain versions: over a ragged BG for a few steps, at BG = PPC_BG with
    their full step counts (timed there), and the EDM kernels' rounding
    points over their first steps."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet
    from graspldm_tpu_torch.models.stacked_denoiser import compute_input_emb, pack_math_weights

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    dims = _denoiser_dims(ddm)
    L = dims.seq_len
    math_w = pack_math_weights(ddm, dims)
    z_pc = torch.randn((PPC_BG, 3, dims.cond_dim), generator=gen, device=dev)
    x_unit = torch.randn((PPC_BG, L), generator=gen, device=dev)
    noise = torch.randn((max(PPC_STEPS.values()), PPC_BG, L), generator=gen, device=dev)
    checks = ((PPC_BG_CHECK, dict.fromkeys(PPC_STEPS, PPC_STEPS_CHECK), "ragged"),
              (PPC_BG, PPC_STEPS, "full"),
              (PPC_BG, dict.fromkeys(EDM_STEPS, EDM_SHORT_STEPS), "short"))
    refs = {}
    for dt in (torch.float32, torch.bfloat16):
        w = PackedNet(math_w, dims, dt, dev)
        for bg, steps, mode in checks:
            log(f"[kernels] ppc {tag_of(dt)}, L={L}, BG={bg}, {mode}")
            input_emb = compute_input_emb(w.aux, z_pc[:bg])
            runs = sampler_runs(w, ed, input_emb, x_unit[:bg].contiguous(),
                                noise[:, :bg].contiguous(), steps, sched)
            hold(run, w, runs, steps, "ppc", bg, mode, refs, PPC_BG, PPC_STEPS)


def steppers(w, kind: str, sched, ed, input_emb, x_unit, noise, n: int):
    """One step of sampler ``kind`` (n steps; its tables at that count) as
    ``(x_start, carry0, kernel step, plain step, evaluations per launch,
    operands of one launch)``; a step is ``(s, x, carry) -> (x_new,
    carry)``, the carry being DPM++'s previous denoised estimate."""
    from graspldm_tpu_torch.models import cuda_sampler as cs

    if kind == "ddim":
        embin, trows, coefs = cs.sampler_tables(w, sched, input_emb, n, "ddim", "fixed_large")

        def k(s, x, c):
            return cs.ddim_step_apply(w, x, embin, trows[s], coefs[s]), None

        def p(s, x, c):
            return cs.ddim_step_plain(w, x, embin, trows[s], coefs[s], None, True, 1.0), None

        return x_unit, None, k, p, 1, (x_unit, embin, trows[0], coefs[0])
    x_T = (ed.sigma_max * x_unit).contiguous()
    if kind == "dpmpp":
        embin, trows, coefs = cs.dpmpp_tables(w, ed, input_emb, n)

        def k(s, x, old):
            return cs.dpmpp_step_apply(w, x, old, embin, trows[s], coefs[s])

        def p(s, x, old):
            return cs.dpmpp_step_plain(w, x, old, embin, trows[s], coefs[s], False)

        # in: x, old and one step's tables; out: x_new and the denoised estimate
        return (x_T, torch.zeros_like(x_T), k, p, 1,
                (x_T, x_T, embin, trows[0], coefs[0], x_T))
    embin, tA, tB, cA, cB = cs.churn_tables(w, ed, input_emb, n)

    def k(s, x, c):
        return cs.churn_step_apply(w, x, embin, tA[s], tB[s], cA[s], cB[s], noise[s]), None

    def p(s, x, c):
        return cs.churn_step_plain(w, x, embin, tA[s], tB[s], cA[s], cB[s], noise[s],
                                   False), None

    return x_T, None, k, p, 2, (x_T, noise[0], embin, tA[0], tB[0], cA[0], cB[0])


def step_tols(tag: str, kind: str):
    """(max limit, mean limit) of a step kernel's few chained steps,
    relative to max(1, max|state|): TOL_FP32; in bf16 the sampler limit
    (TOL_BF16_SAMPLER for DDIM, TOL_BF16_EDM) and TOL_BF16_STEP_MEAN."""
    if tag == "fp32":
        return TOL_FP32, None
    return (TOL_BF16_SAMPLER if kind == "ddim" else TOL_BF16_EDM), TOL_BF16_STEP_MEAN[kind]


def chain_vs_whole(w, kind: str, sched, ed, input_emb, x_unit, noise, n: int):
    """x_0 of n step-kernel launches (``fused_sample*(return_trajectory=
    True)``) and of the whole-trajectory kernel, on the same inputs."""
    from graspldm_tpu_torch.models import cuda_sampler as cs

    if kind == "ddim":
        def run(traj):
            return cs.fused_sample(w, sched, input_emb, x_unit, n, "ddim",
                                   return_trajectory=traj)
    elif kind == "dpmpp":
        def run(traj):
            return cs.fused_sample_dpmpp(w, ed, input_emb, ed.sigma_max * x_unit, n,
                                         return_trajectory=traj)
    else:
        def run(traj):
            return cs.fused_sample_churn(w, ed, input_emb, ed.sigma_max * x_unit, n,
                                         noise=noise[:n], return_trajectory=traj)
    chain = run(True)[0]
    return chain[:, 0], run(False)[:, 0]


def step_kernel_phase(run: Run, config: str, ddm, ed, sched, dev, bg_full: int) -> None:
    """The three per-step kernels at ``config``'s denoiser against their
    plain steps: STEP_CHAIN chained steps of each at BG = ``bg_full`` and
    RAGGED_BG, one launch timed at ``bg_full`` (mid-trajectory), and the
    whole chain of TRAJ_STEPS launches against the whole-trajectory kernel
    at ``bg_full``."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet
    from graspldm_tpu_torch.models.stacked_denoiser import compute_input_emb, pack_math_weights

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    dims = _denoiser_dims(ddm)
    L = dims.seq_len
    math_w = pack_math_weights(ddm, dims)
    z_pc = torch.randn((bg_full, 3, dims.cond_dim), generator=gen, device=dev)
    x_unit = torch.randn((bg_full, L), generator=gen, device=dev)
    noise = torch.randn((max(TRAJ_STEPS.values()), bg_full, L), generator=gen, device=dev)
    fp32_states = {}  # (kind, bg) -> the plain fp32 state after STEP_CHAIN steps
    for dt in (torch.float32, torch.bfloat16):
        w = PackedNet(math_w, dims, dt, dev)
        tag = tag_of(dt)
        for bg in (RAGGED_BG, bg_full):
            log(f"[kernels] step kernels {config} {tag}, L={L}, BG={bg}")
            input_emb = compute_input_emb(w.aux, z_pc[:bg])
            for kind, n in TRAJ_STEPS.items():
                name = STEP_KERNEL[kind]
                x0, c0, kstep, pstep, evals, ops = steppers(
                    w, kind, sched, ed, input_emb, x_unit[:bg].contiguous(),
                    noise[:, :bg].contiguous(), n)
                tol, tol_mean = step_tols(tag, kind)
                xk, ck, xp, cp, err = x0, c0, x0, c0, 0.0
                for s in range(STEP_CHAIN):
                    xk, ck = kstep(s, xk, ck)
                    torch.cuda.synchronize()
                    xp, cp = pstep(s, xp, cp)
                    err = max(err, run.compare(f"{name} {kind} {config} BG={bg} step {s}", xk, xp,
                                               tol, tol_mean))
                r = run.record(name, config, L, bg_full, 1, tag, what=f"one {kind} step per launch")
                r.setdefault("err_checked_at", []).append(
                    dict(BG=bg, steps=STEP_CHAIN, max_abs_err=err))
                if tag == "fp32":
                    fp32_states[(kind, bg)] = xp
                else:
                    r.setdefault("bf16_vs_fp32_plain_steps", []).append(dict(
                        BG=bg, **spread(run, f"{name} {config} BG={bg} x {STEP_CHAIN} steps", xp,
                                        fp32_states[(kind, bg)], TOL_BF16_STEP_MEAN[kind])))
                if bg != bg_full:
                    continue
                r["err"] = err
                s_mid = n // 2
                k_ms = cuda_ms(lambda: kstep(s_mid, x0, c0), 10)
                p_ms = cuda_ms(lambda: pstep(s_mid, x0, c0), 3)
                r.update(ms=k_ms, plain_ms=p_ms, **sampler_bound(w, evals, bg, tag, *ops))
                log(f"  {name} {kind}: kernel {k_ms:.3f} ms per launch, plain {p_ms:.3f} ms; "
                    f"bound {r['bound_ms']:.4f} ms")
                chain, whole = chain_vs_whole(w, kind, sched, ed, input_emb, x_unit, noise, n)
                torch.cuda.synchronize()
                cw = (TOL_FP32, None, False) if tag == "fp32" else (
                    (TOL_BF16_SAMPLER, None, True) if kind == "ddim"
                    else (TOL_BF16_EDM, TOL_BF16_EDM_MEAN, False))
                e = run.compare(f"{name} x {n} launches vs the whole-trajectory kernel "
                                f"{config} BG={bg}", chain, whole, *cw)
                bitwise = bool(torch.equal(chain, whole))
                log(f"  bitwise equal to the whole-trajectory kernel: {bitwise}")
                r["chain_vs_whole"] = dict(steps=n, max_abs_err=e, bitwise_equal=bitwise)


def full_operands(w, bg: int, gen, dev):
    """``full_kernel``'s operands for ``bg`` rows, as the guided path makes
    them: the init conv's output for random latents and the FiLM input at
    random timesteps, with a class embedding for a class-conditioned pack."""
    from graspldm_tpu_torch.models.stacked_cuda import init_conv
    from graspldm_tpu_torch.models.stacked_denoiser import (
        compute_emb_s_stacked, compute_extra_emb, compute_input_emb,
    )

    d = w.dims
    z = torch.randn((bg, d.cond_channels, d.cond_dim), generator=gen, device=dev)
    t = torch.randint(0, 1000, (bg,), generator=gen, device=dev)
    x_T = torch.randn((bg, d.seq_len), generator=gen, device=dev)
    input_emb = compute_input_emb(w.aux, z)
    if "cls_w" in w.aux:  # folded into the conditioning rows, as the pipeline does
        cls = torch.randint(0, 4, (bg,), generator=gen, device=dev).float()
        input_emb = input_emb + compute_extra_emb(w.aux, cls_cond=cls)[:, None, :]
    emb = compute_emb_s_stacked(w.aux, t, input_emb=input_emb).to(w.dtype).contiguous()
    return init_conv(w, x_T).reshape(bg, -1).to(w.dtype).contiguous(), emb


def stage_chain(w, x, emb):
    """The 5-launch lowering of the same function: every ``stage_kernel``,
    then ``final_kernel``."""
    from graspldm_tpu_torch.models.stacked_cuda import final_apply, stage_apply

    for i in range(len(w.dims.block_channels)):
        x = stage_apply(w, i, x, emb)
    return final_apply(w, x, emb)


def full_kernel_phase(run: Run, nets: list, dev) -> None:
    """``full_kernel`` against ``full_plain`` and the stage chain on the same
    operands, for each ``(config, label, denoiser)`` of ``nets``: an
    unconditioned denoiser in float32 and bfloat16 at a ragged BG and at
    the guided main path's row counts (timed there), a conditioned one (it
    runs float32) at the CFG row count. Both dtypes run their products on
    the tensor cores, float32 through the exact bf16 split; float32 is held
    against two controls on the same operands (``SPLIT_VS_CUDA_CORES``):
    the stage chain's error (the CUDA cores) and a bf16 network's."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet, full_apply, full_plain
    from graspldm_tpu_torch.models.stacked_denoiser import pack_math_weights

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    for config, label, ddm in nets:
        dims = _denoiser_dims(ddm)
        math_w = pack_math_weights(ddm, dims)
        dts = (torch.float32,) if ddm.conditioning else (torch.float32, torch.bfloat16)
        bgs = FULL_BG[config][1:] if ddm.conditioning else (RAGGED_BG,) + FULL_BG[config]
        w_bf16 = PackedNet(math_w, dims, torch.bfloat16, dev)
        for dt in dts:
            w = PackedNet(math_w, dims, dt, dev) if dt == torch.float32 else w_bf16
            tag = tag_of(dt)
            tol = TOL_FP32 if tag == "fp32" else TOL_BF16
            if tag == "fp32":
                packing = split_packing_ms(math_w, dims, dev)
                log(f"[kernels] float32 {label} packing: {packing['pack_ms']:.3f} ms, of which "
                    f"the split's fragment copies {packing['split_ms']:.3f} ms (host clock)")
            for bg in bgs:
                log(f"[kernels] full_kernel {label} {tag}, L={dims.seq_len}, BG={bg}")
                x, emb = full_operands(w, bg, gen, dev)
                ref = full_plain(w, x, emb)
                got = full_apply(w, x, emb)
                chain = stage_chain(w, x, emb)
                torch.cuda.synchronize()
                err = run.compare(f"full_kernel {label} BG={bg} vs full_plain", got, ref, tol)
                run.compare(f"full_kernel {label} BG={bg} vs the stage chain", got, chain, tol)
                bitwise = bool(torch.equal(got, chain))
                log(f"  bitwise equal to the stage chain: {bitwise}")
                checked = dict(BG=bg, what=label, max_abs_err=err, bitwise_equal_chain=bitwise)
                if tag == "fp32":
                    checked.update(split_controls(run, f"full_kernel {label} BG={bg}", w_bf16, x,
                                                  emb, got, ref, chain))
                r = run.record("full_kernel", config, dims.seq_len, FULL_BG[config][0], None, tag,
                               what="one denoiser evaluation (guided samplers)")
                r.setdefault("err_checked_at", []).append(checked)
                if bg not in FULL_BG[config] or ddm.conditioning:
                    continue
                k_ms = cuda_ms(lambda: full_apply(w, x, emb), 10)
                p_ms = cuda_ms(lambda: full_plain(w, x, emb), 3)
                c_ms = cuda_ms(lambda: stage_chain(w, x, emb), 10)
                b = full_bound(w, bg, nbytes(x, emb, ref, w.math_flat, w.layout))
                way = b.get("bound_type", "bytes")
                way = "" if way == "bytes" else f": {way}"
                log(f"  full_kernel: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, chain of 5 "
                    f"launches {c_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}{way})")
                timed = dict(BG=bg, ms=k_ms, plain_ms=p_ms, chain_ms=c_ms, **b)
                r.setdefault("timed_at", []).append(timed)
                if bg == FULL_BG[config][0]:
                    r.update(err=err, ms=k_ms, plain_ms=p_ms, chain_ms=c_ms, **b)


def split_packing_ms(math_w, dims, dev, reps: int = 5) -> dict:
    """Host milliseconds of a float32 ``PackedNet`` (every generation call
    packs its denoiser) and of the part of it that builds the exact split's
    fragment-ordered copies, which only ``full_kernel<float>`` reads."""
    from graspldm_tpu_torch.models import stacked_cuda as sc

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    products = sc._tc_products(math_w, dims).values()
    return dict(pack_ms=ms(lambda: sc.PackedNet(math_w, dims, torch.float32, dev)),
                split_ms=ms(lambda: [sc._tc_copy(v, taps, torch.float32) for taps, v in products]))


def split_controls(run: Run, name: str, w_bf16, x, emb, got, ref, chain) -> dict:
    """The float32 ``full_kernel``'s two controls on its own operands: its
    error against ``full_plain`` beside the float32 stage chain's (the same
    function on the CUDA cores), within ``SPLIT_VS_CUDA_CORES`` of it; and a
    bf16 network (``full_plain`` of the bf16 pack on the inputs rounded to
    bf16), which must land above ``TOL_FP32``."""
    from graspldm_tpu_torch.models.stacked_cuda import full_plain

    top = max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item()
    chain_err = (chain - ref).abs().max().item()
    ratio = err / max(chain_err, 1e-30)
    apart = (got - chain).abs().max().item() / top
    bf16 = full_plain(w_bf16, x.to(torch.bfloat16), emb.to(torch.bfloat16)).float()
    bf16_err = (bf16 - ref).abs().max().item()
    ok = ratio <= SPLIT_VS_CUDA_CORES
    caught = bf16_err > TOL_FP32 * top
    log(f"  CUDA-core control: {name} (tensor cores, exact bf16 split) {err:.3e} against "
        f"full_plain, the fp32 stage chain (CUDA cores) {chain_err:.3e}: {ratio:.2f}x (limit "
        f"{SPLIT_VS_CUDA_CORES:g}x) -> {'ok' if ok else 'FAIL'}; kernel and chain {apart:.3e} of "
        f"max(1, max|ref|) apart")
    log(f"  bf16 control: a bf16 network against full_plain {bf16_err:.3e} (rel "
        f"{bf16_err / top:.3e}), above TOL_FP32's {TOL_FP32 * top:.3e}: "
        f"{'yes' if caught else 'NO'}")
    if not ok:
        run.failures.append(f"{name}: {ratio:.2f}x the CUDA-core chain's error")
    if not caught:
        run.failures.append(f"{name}: TOL_FP32 would pass a bf16 network")
    return dict(cuda_core_chain_err=chain_err, vs_cuda_core_chain=ratio, bf16_network_err=bf16_err,
                rel_apart_from_chain=apart)


# ---------------------------------------------------------------------------
# the hybrid kernels (attention between launches, XLA_ATTENTION at L > 4)
# ---------------------------------------------------------------------------


def hybrid_macs(d, i: int) -> int:
    """Multiply-adds of hybrid launch ``i`` for one row (``i`` = n_stages:
    the hybrid final block): the previous stage's k3 projection, then the
    ResnetBlocks (and the head); the attention runs between launches."""
    n = len(d.block_channels)
    proj = d.seq_len * 3 * d.cins[i - 1] * d.block_channels[i - 1] if i > 0 else 0
    if i == n:
        return proj + final_macs(d)
    L, E, C = d.seq_len, d.emb_dim, d.cins[i]
    return proj + 2 * (E * 2 * C + 2 * L * 3 * C * C)


def hybrid_weights(w, i: int) -> list:
    """The packed weights hybrid launch ``i`` reads."""
    pfx = "final" if i == len(w.dims.block_channels) else f"b{i}r"
    ws = [t for k, t in w.w.items() if k.startswith(pfx)]
    return ws + ([w.w[f"b{i - 1}_wp"], w.w[f"b{i - 1}_bp"]] if i > 0 else [])


def hybrid_launch(w, i: int, x, emb, plain: bool = False):
    """Hybrid launch ``i`` (or its plain version) on ``x``."""
    from graspldm_tpu_torch.models import stacked_cuda as sc

    if i == len(w.dims.block_channels):
        return (sc.hybrid_final_plain if plain else sc.hybrid_final_apply)(w, x, emb)
    return (sc.hybrid_stage_plain if plain else sc.hybrid_stage_apply)(w, i, x, emb)


def hybrid_chain(w, x, emb, plain: bool = False):
    """The network after the init conv with attention between launches:
    each hybrid stage, then its attention in plain PyTorch, then the hybrid
    final block."""
    from graspldm_tpu_torch.models.stacked_denoiser import attention_stacked

    n = len(w.dims.block_channels)
    for i in range(n):
        x = attention_stacked(w.w, i, hybrid_launch(w, i, x, emb, plain), w.dims)
    return hybrid_launch(w, n, x, emb, plain)


def hold_hybrid(run: Run, config: str, label: str, w, x, emb, timed: bool) -> None:
    """Each hybrid launch of one chain against its plain version on the
    same operands (each launch's input from the plain chain); given
    ``timed``, each launch, its plain version and each attention between
    launches timed with CUDA events, summed per kernel over the chain."""
    from graspldm_tpu_torch.models.stacked_denoiser import attention_stacked

    d, tag = w.dims, tag_of(w.dtype)
    n, bg = len(d.block_channels), x.shape[0]
    tol = TOL_FP32 if tag == "fp32" else TOL_BF16
    errs = {"hybrid_stage_kernel": [], "hybrid_final_kernel": []}
    inputs, h = [], x
    for i in range(n + 1):
        name = "hybrid_final_kernel" if i == n else "hybrid_stage_kernel"
        ref = hybrid_launch(w, i, h, emb, plain=True)
        got = hybrid_launch(w, i, h, emb)
        torch.cuda.synchronize()
        errs[name].append(run.compare(f"{name} {label} {tag} launch {i}", got, ref, tol))
        inputs.append(h)
        if i < n:
            h = attention_stacked(w.w, i, ref, d)
    for name, e in errs.items():
        r = run.record(name, config, d.seq_len, HYBRID_BG[config], None, tag,
                       what=HYBRID_WHAT[config])
        r.setdefault("err_checked_at", []).append(dict(BG=bg, what=label, max_abs_err=max(e)))
        r["err"] = max(r.get("err", 0.0), max(e))
    if not timed:
        return
    acc = {k: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0) for k in errs}
    attn = []
    for i, xi in enumerate(inputs):
        a = acc["hybrid_final_kernel" if i == n else "hybrid_stage_kernel"]
        a["ms"] += cuda_ms(lambda: hybrid_launch(w, i, xi, emb), 10)
        a["plain_ms"] += cuda_ms(lambda: hybrid_launch(w, i, xi, emb, plain=True), 3)
        a["flops"] += 2.0 * hybrid_macs(d, i) * bg
        out_cols = d.seq_len * (d.cins[i] if i < n else 1)
        a["bytes"] += nbytes(xi, emb, *hybrid_weights(w, i)) + bg * out_cols * xi.element_size()
        if i < n:
            hi = hybrid_launch(w, i, xi, emb)
            attn.append(cuda_ms(lambda: attention_stacked(w.w, i, hi, d), 10))
    for name, a in acc.items():
        b = bound(a["flops"], a["bytes"], tag)
        log(f"  {name} {label} {tag}, {n if name == 'hybrid_stage_kernel' else 1} launch(es): "
            f"kernel {a['ms']:.3f} ms, plain {a['plain_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        r = run.record(name, config, d.seq_len, HYBRID_BG[config], None, tag)
        timed_at = dict(BG=bg, ms=a["ms"], plain_ms=a["plain_ms"], **b)
        r.setdefault("timed_at", []).append(timed_at)
        if bg == HYBRID_BG[config]:
            r.update(ms=a["ms"], plain_ms=a["plain_ms"], **b)
    log(f"  attention between launches {label} {tag}: "
        + ", ".join(f"stage {i} {t:.3f} ms" for i, t in enumerate(attn))
        + f"; per chain {sum(attn):.3f} ms")
    r = run.record("hybrid_stage_kernel", config, d.seq_len, HYBRID_BG[config], None, tag)
    r.setdefault("attention_ms", []).append(dict(BG=bg, per_stage=attn, per_chain=sum(attn)))


def hybrid_kernel_phase(run: Run, vae, region_ddm, ppc_ddm, dev) -> None:
    """Both hybrid kernels against their plain versions: at the decoder's
    shapes (fpc VAE, L = 16, BG = 4096) in float32 and bf16, with a ragged
    BG = 1021 in bf16, and at the ppc denoiser's at BG = 1024, 2048 (CFG)
    and 1021: the region-conditioned one in float32 (as conditioned packs
    are) and the unconditioned one in bf16; timed at 4096 / 1024 / 2048. Then the hybrid chain against the unsplit
    chain (4 ``stage_kernel`` + ``final_kernel``) on the decoder's operands:
    the attention's lowering differs (one-pass LayerNorm statistics, bf16
    softmaxes), so the two agree to float32's sums in float32 and, in bf16,
    to no better than bf16 itself moves the network (its spread: plain bf16
    vs plain float32 on the same operands); both chains timed."""
    from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
    from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet, full_plain, init_conv
    from graspldm_tpu_torch.models.stacked_denoiser import (
        compute_emb_s_stacked, pack_math_weights,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    ddims = decoder_dims_for(vae)
    dec_math = pack_math_weights(vae.decoder.net, ddims)
    z_pc = torch.randn((BG, 3, 64), generator=gen, device=dev)
    z_h = torch.randn((BG, 4), generator=gen, device=dev)
    with torch.no_grad():
        x_in = vae.decoder.in_layer(z_h)
    w32 = PackedNet(dec_math, ddims, torch.float32, dev)
    for dt in (torch.float32, torch.bfloat16):
        tag = tag_of(dt)
        log(f"[kernels] hybrid fpc decoder {tag}, L=16, BG={BG}")
        w = PackedNet(dec_math, ddims, dt, dev)
        emb = compute_emb_s_stacked(w.aux, None, z_pc).to(dt).contiguous()
        x = init_conv(w, x_in).reshape(BG, -1).to(dt).contiguous()
        hold_hybrid(run, "fpc", "decoder", w, x, emb, timed=True)
        if dt == torch.bfloat16:
            hold_hybrid(run, "fpc", f"decoder ragged BG={RAGGED_BG}", w, x[:RAGGED_BG],
                        emb[:RAGGED_BG], timed=False)
        hyb, unsplit = hybrid_chain(w, x, emb), stage_chain(w, x, emb)
        torch.cuda.synchronize()
        if dt == torch.float32:
            err = run.compare("hybrid chain vs unsplit chain decoder fp32", hyb, unsplit,
                              TOL_FP32)
        else:
            sp = spread(run, "decoder chain", full_plain(w, x, emb).float(),
                        full_plain(w32, x.float(), emb.float()).float())
            err = run.compare("hybrid chain vs unsplit chain decoder bf16 (limit: twice bf16's "
                              "spread)", hyb, unsplit, 2.0 * sp["max_rel"])
        hyb_ms = cuda_ms(lambda: hybrid_chain(w, x, emb), 10)
        uns_ms = cuda_ms(lambda: stage_chain(w, x, emb), 10)
        log(f"  decode core {tag}, BG={BG}: hybrid chain (5 launches + 4 attentions) "
            f"{hyb_ms:.3f} ms vs unsplit chain (5 launches) {uns_ms:.3f} ms")
        r = run.record("hybrid_stage_kernel", "fpc", 16, BG, None, tag)
        r.update(chain_ms=hyb_ms, unsplit_chain_ms=uns_ms,
                 chain_vs_unsplit=dict(max_abs_err=err, bitwise_equal=bool(torch.equal(hyb,
                                                                                        unsplit))))

    for ddm, dt in ((region_ddm, torch.float32), (ppc_ddm, torch.bfloat16)):
        dims = _denoiser_dims(ddm)
        w = PackedNet(pack_math_weights(ddm, dims), dims, dt, dev)
        label = f"ppc {ddm.conditioning or 'unconditioned'} denoiser"
        for bg in (RAGGED_BG,) + FULL_BG["ppc"]:
            log(f"[kernels] hybrid {label} {tag_of(dt)}, L=16, BG={bg}")
            x, emb = full_operands(w, bg, gen, dev)
            hold_hybrid(run, "ppc", label, w, x, emb, timed=bg != RAGGED_BG)


# ---------------------------------------------------------------------------
# main paths
# ---------------------------------------------------------------------------


def check_grasps(out: dict, b: int, g: int) -> None:
    H = out["grasps"]
    if tuple(H.shape) != (b, g, 4, 4):
        raise AssertionError(f"grasps shape {tuple(H.shape)} != {(b, g, 4, 4)}")
    if tuple(out["grasp_tmrp"].shape) != (b, g, 6) or tuple(out["confidence"].shape) != (b, g):
        raise AssertionError("grasp_tmrp / confidence shapes are wrong")
    for k, v in out.items():
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise AssertionError(f"{k} has non-finite values")
    conf = torch.as_tensor(out["confidence"])
    check_poses(H, f"confidence in [{conf.min().item():.3f}, {conf.max().item():.3f}]")


def check_poses(H, note: str = "") -> None:
    """Every 4x4 pose of ``H [..., 4, 4]`` has an orthonormal rotation block
    with det +1 and the bottom row [0, 0, 0, 1]."""
    H = torch.as_tensor(H).double().cpu()
    R = H[..., :3, :3]
    ortho = (R @ R.transpose(-1, -2) - torch.eye(3, dtype=R.dtype)).abs().max().item()
    det = (torch.linalg.det(R) - 1.0).abs().max().item()
    bottom = (H[..., 3, :] - torch.tensor([0, 0, 0, 1.0], dtype=H.dtype)).abs().max().item()
    log(f"  |R R^T - I| {ortho:.2e}, |det R - 1| {det:.2e}, bottom row {bottom:.1e}"
        + (f", {note}" if note else ""))
    if ortho > 1e-4 or det > 1e-4 or bottom != 0.0:
        raise AssertionError("rotation blocks are not orthonormal")


def per_call(sampler_kernel: str) -> dict:
    """One generation call: 4 decoder stages, the final block, one sampler."""
    return {"stage_kernel": 4, "final_kernel": 1, sampler_kernel: 1}


def clouds(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """Metric clouds: a noisy box surface around a random centre."""
    pts = rng.uniform(-1.0, 1.0, size=(b, n, 3))
    axis = rng.integers(0, 3, size=(b, n))
    np.put_along_axis(pts, axis[..., None], np.sign(rng.uniform(-1, 1, (b, n, 1))), axis=-1)
    pts = pts * np.array([0.04, 0.03, 0.08]) + rng.normal(0.0, 0.001, size=pts.shape)
    return (pts + rng.uniform(-0.3, 0.3, size=(b, 1, 3))).astype(np.float32)


def _normalized(dev, b: int, seed: int):
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    pc = torch.from_numpy(clouds(np.random.default_rng(seed), b, N_POINTS)).to(dev)
    pc_n, _, meta = normalize_pc_and_grasps(pc, torch.zeros((b, 1, 6), device=dev))
    return pc_n, meta


def timed_ldm(run: Run, label: str, models, pc_n, meta, g: int, gen, steps: int, sampler: str,
              kernel: str, config: str = "fpc", calls: int = 2) -> None:
    from graspldm_tpu_torch.inference.pipeline import ldm_generate

    vae, ddm, diffusion = models
    for i in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ldm_generate(vae, ddm, diffusion, pc_n, g, gen, num_inference_steps=steps,
                           sampler=sampler, meta=meta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  {label} call {i + 1}: wall {wall:.3f} s"
            + (" (first call: packing and set-up included)" if i == 0 else
               " (warm; packing included)"))
        check_grasps(out, pc_n.shape[0], g)
        run.expect_more(label, config, **per_call(kernel))


def generation_phase(run: Run, fpc, ppc, dev) -> None:
    from graspldm_tpu_torch.inference.pipeline import vae_generate

    vae, ddm, diffusion = fpc
    pc_n, meta = _normalized(dev, B, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log(f"[ldm_generate] B={B} x N={N_POINTS}, G={G}, {STEPS} DDIM steps, bf16 kernels")
    timed_ldm(run, "ldm_generate ddim", fpc, pc_n, meta, G, gen, STEPS, "ddim",
              "ddim_sampler_kernel")
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: vae.encode_pc(pc_n), 5)
    log(f"  encode_pc alone {enc_ms:.3f} ms (CUDA events)")

    log(f"[vae_generate] B={B}, G={G}")
    out = vae_generate(vae, pc_n, G, gen, meta=meta)
    torch.cuda.synchronize()
    check_grasps(out, B, G)
    run.expect_more("vae_generate", "fpc", stage_kernel=4, final_kernel=1)

    pc1, meta1 = _normalized(dev, 1, SEED + 7)
    log(f"[ldm_generate] ppc (z_pc [3, 256], latent 16), B=1 x N={N_POINTS}, G={G}, "
        f"{STEPS} DDIM steps, bf16 kernels")
    timed_ldm(run, "ldm_generate ppc ddim", ppc, pc1, meta1, G, gen, STEPS, "ddim",
              "ddim_sampler_kernel", "ppc", calls=1)


def edm_generation_phase(run: Run, fpc, ppc, dev) -> None:
    pc_n, meta = _normalized(dev, B, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for sampler, steps in EDM_STEPS.items():
        log(f"[ldm_generate EDM] fpc, B={B} x N={N_POINTS}, G={G}, {sampler} x {steps} steps, "
            "bf16 kernels")
        timed_ldm(run, f"ldm_generate {sampler}", fpc, pc_n, meta, G, gen, steps, sampler,
                  f"{sampler}_sampler_kernel")
    pc1, meta1 = _normalized(dev, 1, SEED + 7)
    for sampler, steps in EDM_STEPS.items():
        log(f"[ldm_generate EDM] ppc (z_pc [3, 256], latent 16), B=1 x N={N_POINTS}, G={G}, "
            f"{sampler} x {steps} steps, bf16 kernels")
        timed_ldm(run, f"ldm_generate ppc {sampler}", ppc, pc1, meta1, G, gen, steps, sampler,
                  f"{sampler}_sampler_kernel", "ppc", calls=1)


def per_trajectory_call(kind: str, steps: int) -> dict:
    """One ``ldm_generate(return_trajectory=True)`` call: one step-kernel
    launch per step, and the decode of x_0 and of min(50, S') states (S' =
    steps + 1 with x_T first, DPM++ steps)."""
    decoded = 1 + min(50, steps if kind == "dpmpp" else steps + 1)
    return {STEP_KERNEL[kind]: steps, "stage_kernel": 4 * decoded, "final_kernel": decoded}


def _timed(fn, part: str, times: dict):
    """``fn`` that adds its host time, bracketed by ``torch.cuda.synchronize``,
    to ``times[part]``."""
    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        times[part] = times.get(part, 0.0) + time.perf_counter() - t0
        return res
    return call


@contextlib.contextmanager
def split_times(times: dict, parts: dict | None = None, made: dict | None = None,
                module=None):
    """Add the host time of ``module``'s functions in ``parts`` (name ->
    part; default: ``ldm_generate``'s sampler call and its decodes,
    "sampler" and "decode") and of the functions that the factories in
    ``made`` (name -> part) return, to ``times``, by wrapping the module's
    names for the duration (default: the pipeline module)."""
    from graspldm_tpu_torch.inference import pipeline

    pl = module or pipeline
    if parts is None:
        parts = {"fused_sample": "sampler", "fused_sample_dpmpp": "sampler",
                 "fused_sample_churn": "sampler", "decode_and_postprocess": "decode"}
    made = made or {}
    saved = {n: getattr(pl, n) for n in (*parts, *made)}
    for n, part in parts.items():
        setattr(pl, n, _timed(saved[n], part, times))
    for n, part in made.items():
        setattr(pl, n, lambda *a, _f=saved[n], _p=part, **k: _timed(_f(*a, **k), _p, times))
    try:
        yield times
    finally:
        for n, fn in saved.items():
            setattr(pl, n, fn)


def trajectory_phase(run: Run, fpc: dict, ppc: dict, dev) -> None:
    """``ldm_generate(return_trajectory=True)`` at full width, bf16: fpc (B
    clouds x G grasps, each sampler twice) and ppc (one cloud x G). Checks
    the trajectory's and the decoded states' shapes, every decoded pose,
    and exact launch counts; prints each call's wall time split into
    sampler, decode and the rest."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate

    for config, models, b, calls in (("fpc", fpc, B, 2), ("ppc", ppc, 1, 1)):
        pc_n, meta = _normalized(dev, b, SEED if config == "fpc" else SEED + 7)
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        for kind, steps in TRAJ_STEPS.items():
            vae, ddm, diffusion = models["ddim" if kind == "ddim" else "edm"]
            L = ddm.latent_in_features
            n_states = steps if kind == "dpmpp" else steps + 1
            log(f"[trajectory] {config}, B={b} x N={N_POINTS}, G={G}, {kind} x {steps} steps, "
                f"bf16 kernels, return_trajectory")
            for i in range(calls):
                times: dict = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with split_times(times):
                    out = ldm_generate(vae, ddm, diffusion, pc_n, G, gen,
                                       num_inference_steps=steps, sampler=kind, meta=meta,
                                       return_trajectory=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rest = wall - times["sampler"] - times["decode"]
                log(f"  call {i + 1}: wall {wall:.3f} s = sampler {times['sampler']:.3f} s + "
                    f"decode {times['decode']:.3f} s ({1 + min(50, n_states)} decodes) + "
                    f"rest {rest:.3f} s" + (" (first call: set-up included)" if i == 0 else ""))
                traj, A = out["latent_trajectory"], out["all_diffusion_grasps"]
                if tuple(traj.shape) != (n_states, b * G, 1, L):
                    raise AssertionError(f"latent_trajectory shape {tuple(traj.shape)}")
                if tuple(A.shape) != (min(50, n_states), b, G, 4, 4):
                    raise AssertionError(f"all_diffusion_grasps shape {tuple(A.shape)}")
                check_grasps(out, b, G)
                check_poses(A, f"all {A.shape[0]} decoded states")
                run.expect_more(f"trajectory {config} {kind}", config,
                                **per_trajectory_call(kind, steps))


def region_of(pc_n: torch.Tensor, g: int, gen) -> torch.Tensor:
    """``[B*g, REGION_POINTS, 3]``: per cloud, the REGION_POINTS points
    nearest one of its points drawn from ``gen``, repeated per grasp."""
    b, n = pc_n.shape[:2]
    centre = pc_n[torch.arange(b), torch.randint(0, n, (b,), generator=gen, device=pc_n.device)]
    idx = ((pc_n - centre[:, None]) ** 2).sum(-1).topk(REGION_POINTS, largest=False).indices
    region = torch.gather(pc_n, 1, idx[..., None].expand(-1, -1, 3))
    return region.repeat_interleave(g, dim=0)


def guided_phase(run: Run, cls_fpc, fpc, fpc_edm, region_ppc, dev) -> None:
    """The guided and conditioned calls at full width, each twice: exact
    launch counts per call, every pose checked, and each guided call's wall
    time split into denoiser launches (``stacked_denoiser_apply`` with
    ``fuse_stages=True``), guidance VJPs (the success gradient) and the
    rest (encode, packing, tables, sampler arithmetic, decode)."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate

    pc_n, meta = _normalized(dev, B, SEED)
    pc1, meta1 = _normalized(dev, 1, SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cls = torch.arange(B, dtype=torch.float32, device=dev).repeat_interleave(G)
    region = region_of(pc1, G, gen)
    calls = [
        ("class fpc ddim, unguided", "fpc", cls_fpc, pc_n, meta, "ddim", STEPS,
         dict(cls_cond=cls), per_call("ddim_sampler_kernel")),
        ("class fpc ddim, cfg", "fpc", cls_fpc, pc_n, meta, "ddim", STEPS,
         dict(cls_cond=cls, cfg_scale=CFG_SCALE), per_call_full(STEPS)),
        ("fpc ddim, success guidance", "fpc", fpc, pc_n, meta, "ddim", STEPS,
         dict(guidance_scale=GUIDANCE_SCALE), per_call_full(STEPS)),
        ("EDM fpc dpmpp, success guidance", "fpc", fpc_edm, pc_n, meta, "dpmpp",
         EDM_STEPS["dpmpp"], dict(guidance_scale=GUIDANCE_SCALE),
         per_call_full(EDM_STEPS["dpmpp"])),
        ("region EDM ppc dpmpp, cfg", "ppc", region_ppc, pc1, meta1, "dpmpp", EDM_STEPS["dpmpp"],
         dict(region_points=region, cfg_scale=CFG_SCALE), per_call_full(EDM_STEPS["dpmpp"])),
    ]
    for label, config, models, pc, m, sampler, steps, kw, expect in calls:
        b = pc.shape[0]
        log(f"[guided] {label}: B={b} x N={N_POINTS}, G={G}, {sampler} x {steps} steps "
            f"(denoiser {'fp32' if models[1].conditioning else 'bf16'}, decoder bf16)"
            + "".join(f", {k}={v}" for k, v in kw.items() if isinstance(v, float)))
        for i in range(2):
            times: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with split_times(times, {"stacked_denoiser_apply": "denoiser"},
                             {"make_success_guidance": "guidance"}):
                out = ldm_generate(*models, pc, G, gen, num_inference_steps=steps,
                                   sampler=sampler, meta=m, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            den, vjp = times.get("denoiser", 0.0), times.get("guidance", 0.0)
            log(f"  call {i + 1}: wall {wall:.3f} s = denoiser launches {den:.3f} s + guidance "
                f"VJPs {vjp:.3f} s + rest {wall - den - vjp:.3f} s"
                + (" (first call: set-up included)" if i == 0 else ""))
            check_grasps(out, b, G)
            run.expect_more(f"guided {label}", config, **expect)


def per_call_full(evals: int) -> dict:
    """One guided call: one ``full_kernel`` launch per denoiser evaluation,
    then the decode (4 stage launches and the final block)."""
    return {"full_kernel": evals, "stage_kernel": 4, "final_kernel": 1}


def _post(url: str, body: dict, results: list, i: int) -> None:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = (r.status, json.loads(r.read()))
    except Exception as e:  # reported by the caller
        results[i] = (None, repr(e))


def server_phase(run: Run, models, dev, steps: int, sampler: str, kernel: str) -> None:
    """3 concurrent requests through ``GraspServer``; to a class-conditioned
    denoiser each request carries a ``cls``."""
    from graspldm_tpu_torch.serving import (
        DynamicBatcher, GraspServer, make_batch_generate_from_parts,
    )

    conditioning = models[1].conditioning
    log(f"[server] GraspServer, LDM mode, up to {G} grasps, {sampler} x {steps} steps"
        + (", class-conditioned" if conditioning else ""))
    fn = make_batch_generate_from_parts(*models, device=dev, num_grasps=G,
                                        num_inference_steps=steps, sampler=sampler, seed=SEED)
    batcher = DynamicBatcher(fn, num_points=N_POINTS, max_batch=4, max_wait_ms=50.0,
                             requires_cls=conditioning == "class")
    server = GraspServer(batcher, host="127.0.0.1", port=0, info={"num_grasps": G})
    server.start_background()
    try:
        host, port = server.address[:2]
        url = f"http://{host}:{port}/v1/generate"
        rng = np.random.default_rng(SEED + 2)
        reqs = [(N_POINTS, G), (2 * N_POINTS, G // 4), (N_POINTS // 2, G // 16)]
        results = [None] * len(reqs)
        bodies = [{"points": clouds(rng, 1, n)[0].tolist(), "num_grasps": g} for n, g in reqs]
        if conditioning == "class":
            for i, body in enumerate(bodies):
                body["cls"] = float(i)
        threads = [threading.Thread(target=_post, args=(url, body, results, i))
                   for i, body in enumerate(bodies)]
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
        stats = batcher.stats()
        log(f"  batcher stats: {json.dumps(stats)}")
    finally:
        server.shutdown()
    if stats["batches"] < 1:
        raise AssertionError("the server ran no batch")
    run.expect_more("server", "fpc", stats["batches"],
                    **{k: stats["batches"] * v for k, v in per_call(kernel).items()})


def reference_phase(run: Run, dev) -> None:
    """Small float32 generation on the card against the CPU's plain path."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    b, g = 1, 16
    rng = np.random.default_rng(SEED + 3)
    pc = torch.from_numpy(clouds(rng, b, N_POINTS))
    pc_n, _, meta = normalize_pc_and_grasps(pc, torch.zeros((b, 1, 6)))
    meta_d = type(meta)(*(m.to(dev) for m in meta))
    cpu_gen = torch.Generator().manual_seed(SEED + 4)
    x_unit = torch.randn((b * g, 4), generator=cpu_gen)
    churn_noise = torch.randn((EDM_STEPS["churn"], b * g, 4), generator=cpu_gen)
    runs = [("ddim", False, STEPS, x_unit, None)] + [
        (s, True, n, 80.0 * x_unit, churn_noise if s == "churn" else None)
        for s, n in EDM_STEPS.items()
    ]
    runs.append(("ddim", False, STEPS, x_unit, None, True))
    ddpm_noise = torch.randn((STEPS, b * g, 4), generator=cpu_gen)
    cls = torch.arange(b, dtype=torch.float32).repeat_interleave(g)
    region = region_of(pc_n, g, cpu_gen)
    # (conditioning, sampler, EDM, steps, x_T, noise, ldm_generate options)
    guided = [
        ("class", "ddim", False, STEPS, x_unit, None, dict(cls_cond=cls, cfg_scale=CFG_SCALE)),
        (None, "ddpm", False, STEPS, x_unit, ddpm_noise, dict(guidance_scale=GUIDANCE_SCALE)),
        (None, "churn", True, EDM_STEPS["churn"], 80.0 * x_unit, churn_noise,
         dict(guidance_scale=GUIDANCE_SCALE)),
        ("region", "dpmpp", True, EDM_STEPS["dpmpp"], 80.0 * x_unit, None,
         dict(region_points=region, cfg_scale=CFG_SCALE)),
        ("class", "ddim", False, STEPS, x_unit, None,
         dict(cls_cond=cls, cfg_scale=CFG_SCALE, guidance_scale=GUIDANCE_SCALE)),
    ]
    unguided = [(None, sampler, edm, steps, x_T, noise, dict(return_trajectory=bool(traj)))
                for sampler, edm, steps, x_T, noise, *traj in runs]
    for conditioning, sampler, edm, steps, x_T, noise, opts in unguided + guided:
        log(f"[reference] fp32 ldm_generate B={b}, G={g}, {sampler} x {steps} steps"
            + (f", {conditioning}-conditioned" if conditioning else "")
            + "".join(f", {k}" for k, v in opts.items() if v is not False)
            + ": card vs CPU")
        vae, ddm, diffusion = build_models("float32", "cpu", elucidated=edm,
                                           conditioning=conditioning)
        kw = dict(num_inference_steps=steps, sampler=sampler)
        want = ldm_generate(vae, ddm, diffusion, pc_n, g, meta=meta, x_T=x_T, noise=noise,
                            **opts, **kw)
        vae_d, ddm_d = copy.deepcopy(vae).to(dev), copy.deepcopy(ddm).to(dev)
        got = ldm_generate(vae_d, ddm_d, diffusion, pc_n.to(dev), g, meta=meta_d,
                           x_T=x_T.to(dev), noise=None if noise is None else noise.to(dev),
                           **{k: v.to(dev) if torch.is_tensor(v) else v for k, v in opts.items()},
                           **kw)
        keys = ("grasps", "grasp_tmrp", "confidence")
        for k in keys + (("latent_trajectory", "all_diffusion_grasps")
                         if opts.get("return_trajectory") else ()):
            err = (got[k].cpu() - want[k]).abs().max().item()
            log(f"  {k}: max_abs_err {err:.3e} tol {TOL_E2E:.0e}")
            if not err <= TOL_E2E:
                raise AssertionError(f"{sampler} {k}: card and CPU disagree")


def per_call_hybrid(evals: int, n_stages: int = 4) -> dict:
    """Hybrid launches of ``evals`` network evaluations (decodes included):
    one hybrid stage launch per stage and one hybrid final launch each."""
    return {"hybrid_stage_kernel": n_stages * evals, "hybrid_final_kernel": evals}


def hybrid_phase(run: Run, fpc, region_ppc, dev) -> None:
    """The route with attention between launches, the flag patched as a
    user would set it: the fpc flagship with DDIM 100 (B clouds x G grasps,
    bf16; its L = 4 sampler is unchanged, its L = 16 decode is the hybrid
    chain) and the region-conditioned EDM ppc flagship with DPM++ 32 and
    CFG (one cloud x G grasps, float32 denoiser: each evaluation one hybrid
    chain over 2G rows, the decode one more), each twice: exact launch
    counts per call, every pose checked, and the wall time split into
    hybrid launches, attention between launches and the rest."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate
    from graspldm_tpu_torch.models import stacked_cuda as sc

    pc_n, meta = _normalized(dev, B, SEED)
    pc1, meta1 = _normalized(dev, 1, SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    region = region_of(pc1, G, gen)
    n_dpmpp = EDM_STEPS["dpmpp"]
    calls = [
        ("fpc ddim, hybrid decode", "fpc", fpc, pc_n, meta, "ddim", STEPS, {},
         {"ddim_sampler_kernel": 1, **per_call_hybrid(1)}),
        ("region EDM ppc dpmpp, cfg", "ppc", region_ppc, pc1, meta1, "dpmpp", n_dpmpp,
         dict(region_points=region, cfg_scale=CFG_SCALE), per_call_hybrid(n_dpmpp + 1)),
    ]
    parts = {"hybrid_stage_apply": "hybrid", "hybrid_final_apply": "hybrid",
             "attention_stacked": "attention"}
    with mock.patch.object(sc, "XLA_ATTENTION", True):
        for label, config, models, pc, m, sampler, steps, kw, expect in calls:
            b = pc.shape[0]
            log(f"[hybrid] {label}: B={b} x N={N_POINTS}, G={G}, {sampler} x {steps} steps, "
                "XLA_ATTENTION on")
            for i in range(2):
                times: dict = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with split_times(times, parts, module=sc):
                    out = ldm_generate(*models, pc, G, gen, num_inference_steps=steps,
                                       sampler=sampler, meta=m, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                hyb, att = times.get("hybrid", 0.0), times.get("attention", 0.0)
                log(f"  call {i + 1}: wall {wall:.3f} s = hybrid launches {hyb:.3f} s + "
                    f"attention between launches {att:.3f} s + rest {wall - hyb - att:.3f} s"
                    + (" (first call: set-up included)" if i == 0 else ""))
                check_grasps(out, b, G)
                run.expect_more(f"hybrid {label}", config, **expect)


def hybrid_reference_phase(run: Run, dev) -> None:
    """The hybrid route in float32, card against CPU: the region-conditioned
    EDM ppc flagship, DPM++ 32 with CFG, one cloud x 16 grasps."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate
    from graspldm_tpu_torch.models import stacked_cuda as sc
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    b, g, steps = 1, 16, EDM_STEPS["dpmpp"]
    rng = np.random.default_rng(SEED + 42)
    pc_n, _, meta = normalize_pc_and_grasps(torch.from_numpy(clouds(rng, b, N_POINTS)),
                                            torch.zeros((b, 1, 6)))
    meta_d = type(meta)(*(t.to(dev) for t in meta))
    cpu_gen = torch.Generator().manual_seed(SEED + 43)
    x_T = 80.0 * torch.randn((b * g, 16), generator=cpu_gen)
    region = region_of(pc_n, g, cpu_gen)
    vae, ddm, diffusion = build_models("float32", "cpu", elucidated=True, conditioning="region",
                                       **PPC)
    log(f"[hybrid reference] fp32 region ppc ldm_generate B={b}, G={g}, dpmpp x {steps} steps, "
        "cfg, XLA_ATTENTION on: card vs CPU")
    kw = dict(num_inference_steps=steps, sampler="dpmpp", cfg_scale=CFG_SCALE)
    with mock.patch.object(sc, "XLA_ATTENTION", True):
        want = ldm_generate(vae, ddm, diffusion, pc_n, g, meta=meta, x_T=x_T,
                            region_points=region, **kw)
        before = counts()
        got = ldm_generate(copy.deepcopy(vae).to(dev), copy.deepcopy(ddm).to(dev), diffusion,
                           pc_n.to(dev), g, meta=meta_d, x_T=x_T.to(dev),
                           region_points=region.to(dev), **kw)
    launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    log(f"  launches: {launched}")
    if launched != per_call_hybrid(steps + 1):
        raise AssertionError(f"hybrid reference launches {launched}")
    for k in ("grasps", "grasp_tmrp", "confidence"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        log(f"  {k}: max_abs_err {err:.3e} tol {TOL_E2E:.0e}")
        if not err <= TOL_E2E:
            raise AssertionError(f"hybrid {k}: card and CPU disagree")


def module_route_phase(run: Run, flagships: dict, dev) -> None:
    """The plain-module route on the card. First, ``"auto"`` takes the
    kernels for every model the main paths run (it decides by model, as the
    JAX package does). Then float32 ``ldm_generate`` card against CPU on
    routes that launch no denoiser kernel: the fpc flagship with
    ``denoiser_impl="module"``, and a denoiser with learned sinusoidal time
    features, which ``"auto"`` sends to the module (DDIM 100, one cloud x
    16 grasps; the decoder keeps its kernels)."""
    from graspldm_tpu_torch.flagship import init_params_
    from graspldm_tpu_torch.inference.pipeline import (
        ldm_generate, resolve_decoder_impl, resolve_denoiser_impl,
    )
    from graspldm_tpu_torch.models import GraspLatentDDM
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    for label, (vae, ddm, _) in flagships.items():
        routes = (resolve_denoiser_impl(ddm), resolve_decoder_impl(vae))
        log(f"[module route] auto on the {label} flagship: denoiser {routes[0]}, "
            f"decoder {routes[1]}")
        if routes != ("kernels", "kernels"):
            raise AssertionError(f"auto left the kernels for the {label} flagship")
    b, g = 1, 16
    rng = np.random.default_rng(SEED + 44)
    pc_n, _, meta = normalize_pc_and_grasps(torch.from_numpy(clouds(rng, b, N_POINTS)),
                                            torch.zeros((b, 1, 6)))
    meta_d = type(meta)(*(t.to(dev) for t in meta))
    x_T = torch.randn((b * g, 4), generator=torch.Generator().manual_seed(SEED + 45))
    vae, ddm, diffusion = build_models("float32", "cpu")
    learned = init_params_(GraspLatentDDM(learned_sinusoidal_cond=True,
                                          random_fourier_features=False, dropout=None),
                           torch.Generator().manual_seed(SEED + 46)).eval()
    denoiser_kernels = ("ddim_sampler_kernel", "dpmpp_sampler_kernel", "churn_sampler_kernel",
                        "ddim_step_kernel", "dpmpp_step_kernel", "churn_step_kernel",
                        "full_kernel")
    for label, den, impl in (("fpc, denoiser_impl='module'", ddm, "module"),
                             ("learned sinusoidal, auto", learned, "auto")):
        log(f"[module route] fp32 ldm_generate {label}, B={b}, G={g}, ddim x {STEPS}: "
            "card vs CPU")
        kw = dict(num_inference_steps=STEPS, sampler="ddim", denoiser_impl=impl)
        want = ldm_generate(vae, den, diffusion, pc_n, g, meta=meta, x_T=x_T, **kw)
        before = counts()
        got = ldm_generate(copy.deepcopy(vae).to(dev), copy.deepcopy(den).to(dev), diffusion,
                           pc_n.to(dev), g, meta=meta_d, x_T=x_T.to(dev), **kw)
        launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        log(f"  launches: {launched}")
        if any(k in launched for k in denoiser_kernels) or launched != per_call_plain_decode():
            raise AssertionError(f"module route launched {launched}")
        for k in ("grasps", "grasp_tmrp", "confidence"):
            err = (got[k].cpu() - want[k]).abs().max().item()
            log(f"  {k}: max_abs_err {err:.3e} tol {TOL_E2E:.0e}")
            if not err <= TOL_E2E:
                raise AssertionError(f"module route {k}: card and CPU disagree")


def per_call_plain_decode() -> dict:
    """The decode alone: 4 stage launches and the final block."""
    return {"stage_kernel": 4, "final_kernel": 1}


def pvcnn_attention_phase(run: Run, dev) -> None:
    """``PVCNNEncoder(use_global_attention=True)`` at the fpc flagship's
    width (channels and voxel resolutions scaled 0.75, z_pc [3, 64]) on B x
    1024 points, float32 (TF32 off), card against CPU within TOL_PVCNN2 of
    the output's largest magnitude. The clouds are rounded to multiples of
    2^-10, so that their mean, the voxel coordinates and their rounding are
    exact and equal on both sides and the comparison holds the arithmetic
    (the convolutions, BatchNorm and the attention over the 1024 points)."""
    from torch import nn

    from graspldm_tpu_torch.flagship import init_params_
    from graspldm_tpu_torch.models.pvcnn import PVCNNEncoder

    gen = torch.Generator().manual_seed(SEED + 47)
    enc = init_params_(PVCNNEncoder(out_features=64, n_points=N_POINTS, scale_channels=0.75,
                                    scale_voxel_resolution=0.75, use_global_attention=True,
                                    out_channels=3), gen).eval()
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    pc_n, _ = _normalized("cpu", B, SEED + 48)
    pc_q = torch.round(pc_n * 1024.0) / 1024.0
    log(f"[pvcnn attention] PVCNNEncoder(use_global_attention=True), fpc width, B={B} x "
        f"N={N_POINTS}, float32: card vs CPU")
    with torch.no_grad():
        want = enc(pc_q)
        enc_d = copy.deepcopy(enc).to(dev)
        got = enc_d(pc_q.to(dev))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: enc_d(pc_q.to(dev)), 3)
    log(f"  forward on the card {ms:.3f} ms (CUDA events, mean of 3)")
    if tuple(got.shape) != (B, 3, 64):
        raise AssertionError(f"encoder output {tuple(got.shape)}")
    run.compare("PVCNNEncoder global attention card vs CPU", got.cpu(), want, TOL_PVCNN2)


# ---------------------------------------------------------------------------
# the PVCNN2 encoder path
# ---------------------------------------------------------------------------


def fps_bound(B_: int, N: int, M: int) -> dict:
    """9 float32 operations per point and step (3 sub, 3 mul, 2 add, 1 min)
    over M - 1 steps; the coordinates read once, the int64 picks written
    once."""
    return bound(9.0 * B_ * (M - 1) * N, 12 * B_ * N + 8 * B_ * M, "fp32")


def fps_kernel_phase(run: Run, dev) -> None:
    """fps_kernel against its plain version (indices equal) at the SA
    shapes, a ragged N and duplicated points; both timed at the SA shapes."""
    from graspldm_tpu_torch.ops.cuda_fps import fps_apply, fps_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    checked, timed = [], []

    def hold(label: str, coords: torch.Tensor, M: int, time_it: bool) -> None:
        B_, N = coords.shape[:2]
        got, want = fps_apply(coords, M), fps_plain(coords, M)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        checked.append(dict(B=B_, N=N, M=M, what=label, max_abs_err=err))
        line = f"  {label} B={B_}, N={N} -> M={M}: indices {'equal' if same else 'DIFFER'}"
        if not same:
            run.failures.append(f"fps_kernel {label} B={B_} N={N} M={M}: indices differ")
        if time_it:
            k_ms = cuda_ms(lambda: fps_apply(coords, M), 20)
            p_ms = cuda_ms(lambda: fps_plain(coords, M), 2)
            b = fps_bound(B_, N, M)
            timed.append(dict(B=B_, N=N, M=M, ms=k_ms, plain_ms=p_ms, **b))
            line += (f"; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b['bound_ms']:.2e} ms "
                     f"({b['bound_by']})")
        log(line)

    log("[kernels] fps_kernel vs its plain version (float32 coords, int64 picks)")
    for b_ in FPS_B:
        for N, M in FPS_SHAPES:
            hold("SA shape", torch.randn((b_, N, 3), generator=gen, device=dev), M, True)
    hold("ragged", torch.randn((PVCNN2_B, 1000, 3), generator=gen, device=dev), 250, False)
    base = torch.randn((PVCNN2_B, 256, 3), generator=gen, device=dev)
    perm = torch.randperm(1024, generator=gen, device=dev)
    hold("duplicated points (x4)", base.repeat(1, 4, 1)[:, perm].contiguous(), 1024, False)
    one = torch.randn((PVCNN2_B, 1, 3), generator=gen, device=dev).repeat(1, 64, 1)
    hold("one point x64", one, 64, False)
    main = [t for t in timed if t["B"] == PVCNN2_B]
    b = bound(sum(t["flops"] for t in main), sum(t["bytes"] for t in main), "fp32")
    log(f"  one PVCNN2Encoder forward's 4 launches at B={PVCNN2_B}: kernel "
        f"{sum(t['ms'] for t in main):.3f} ms, plain {sum(t['plain_ms'] for t in main):.3f} ms, "
        f"bound {b['bound_ms']:.2e} ms ({b['bound_by']}; the M steps are a chain of dependent "
        f"block-wide argmaxes, which the bound does not count)")
    run.record("fps_kernel", "pvcnn2", None, PVCNN2_B, None, "fp32",
               what=f"the 4 launches of one PVCNN2Encoder forward at B={PVCNN2_B} "
                    f"(N -> M: {', '.join(f'{n}->{m}' for n, m in FPS_SHAPES)}); per launch "
                    "in timed_at",
               err=max(c["max_abs_err"] for c in checked), ms=sum(t["ms"] for t in main),
               plain_ms=sum(t["plain_ms"] for t in main), bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], timed_at=timed, err_checked_at=checked)


def build_pvcnn2(dev):
    """``PVCNN2Encoder()`` at its defaults with weights from a seeded
    generator and BatchNorm running statistics and affines drawn from it
    (not the identity)."""
    from torch import nn

    from graspldm_tpu_torch.flagship import init_params_
    from graspldm_tpu_torch.models import PVCNN2Encoder

    gen = torch.Generator().manual_seed(SEED + 30)
    enc = init_params_(PVCNN2Encoder(), gen)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    return enc.to(dev).eval()


def pvcnn2_phase(run: Run, enc, dev) -> None:
    """The main path: ``PVCNN2Encoder`` on B = 16 clouds x 1024 points,
    twice, then timed; 4 fps_kernel launches per forward."""
    pc_n, _ = _normalized(dev, PVCNN2_B, SEED + 31)
    log(f"[pvcnn2] PVCNN2Encoder (defaults: SA {[m for _, m in FPS_SHAPES]} centres, "
        f"out {enc.out_layer[1].out_features}), B={PVCNN2_B} x N={N_POINTS}, float32 (TF32 off)")
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = enc(pc_n)
        torch.cuda.synchronize()
        log(f"  call {i + 1}: wall {time.perf_counter() - t0:.3f} s"
            + (" (first call: cuDNN set-up included)" if i == 0 else ""))
        if tuple(out.shape) != (PVCNN2_B, 32) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"encoder output {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        run.expect_more("pvcnn2 encoder", "pvcnn2", fps_kernel=len(FPS_SHAPES))
    with torch.no_grad():
        ms = cuda_ms(lambda: enc(pc_n), 3)
    log(f"  forward {ms:.3f} ms (CUDA events, mean of 3); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; |z| max "
        f"{out.abs().max().item():.3f}")
    run.expect_more("pvcnn2 encoder timing", "pvcnn2", 4, fps_kernel=4 * len(FPS_SHAPES))
    with torch.no_grad():
        device_time_by_kernel(lambda: enc(pc_n), ms)
    run.expect_more("pvcnn2 encoder profile", "pvcnn2", fps_kernel=len(FPS_SHAPES))


def device_time_by_kernel(fn, event_ms: float, top: int = 10) -> None:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel,
    largest first, and its sum against ``event_ms`` (the call's time from
    CUDA events, idle gaps included): the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels' own rows only: a CPU op's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(t for t, _ in rows) / 1e3  # ms
    if total <= 0:
        log("  profiler: no device time recorded")
        return
    log(f"  profiled call: kernels {total:.3f} ms on the device, {100 * total / event_ms:.0f} % "
        f"of the {event_ms:.3f} ms forward (busy share); by kernel:")
    for t, name in rows[:top]:
        log(f"    {t / 1e3:8.3f} ms {100 * t / 1e3 / total:5.1f} %  {name[:100]}")


@contextlib.contextmanager
def selections(record: list, replay: list | None, flips: dict):
    """Wrap the PVCNN2 path's discrete selections for the duration. Without
    ``replay``, each call's result is appended to ``record`` (the card's
    run). With it, each call checks its own result against the card's (the
    same call order), counts flips under the rules at ``TOL_PVCNN2``, raises
    on any other difference, and goes on with the card's selection (with
    the CPU's own distances for 3-NN)."""
    from graspldm_tpu_torch.models import pvcnn as pv
    from graspldm_tpu_torch.models import pvcnn2 as pv2
    from graspldm_tpu_torch.ops import neighborhood as nb

    fps, bq = pv2.furthest_point_sample, pv2.ball_query
    vox, nn3 = pv.normalize_coords_for_voxelization, nb.three_nn

    def take(kind: str, own):
        if replay is None:
            record.append((kind, own))
            return None
        k, card = replay.pop(0)
        if k != kind:
            raise AssertionError(f"selection order differs: card {k}, CPU {kind}")
        return card

    def exact(kind: str, fn):
        def wrapped(*a, **kw):
            own = fn(*a, **kw)
            card = take(kind, own)
            if card is not None and not torch.equal(own, card.cpu()):
                n = int((own != card.cpu()).sum())
                raise AssertionError(f"{kind}: {n} indices differ between card and CPU")
            return own
        return wrapped

    def three_nn(points, centers):
        own_d, own_i = nn3(points, centers)
        card = take("3-NN", (own_d, own_i))
        if card is None:
            return own_d, own_i
        ci = card[1].cpu()
        diff = own_i != ci
        if bool(diff.any()):
            p64, c64 = points.double(), centers.double()
            d64 = ((p64[:, :, None, :] - c64[:, None, :, :]) ** 2).sum(-1)  # [B, N, M]
            gap = (d64.gather(-1, own_i) - d64.gather(-1, ci)).abs()[diff].max().item()
            flips["3-NN"] += int(diff.sum())
            log(f"  3-NN: {int(diff.sum())} picks flip, exact distance gaps up to {gap:.2e} "
                f"(near-tie limit {NEAR_TIE_3NN:.0e})")
            if gap > NEAR_TIE_3NN:
                raise AssertionError("3-NN: a pick flips away from a near-tie")
        d = nb.pairwise_sq_dists(points, centers).gather(-1, ci).clamp(1e-10, 1e10)
        return d, ci

    def vox_coords(coords, resolution, normalize=True):
        own = vox(coords, resolution, normalize=normalize)
        card = take("voxel coords", own)
        if card is None:
            return own
        card = card.cpu()
        err = (own - card).abs().max().item()
        flip = torch.round(own) != torch.round(card)
        near = ((own - own.floor()) - 0.5).abs() <= TOL_VOX
        if err > TOL_VOX or bool((flip & ~near).any()):
            raise AssertionError(f"voxel coords differ by {err:.2e}, or round apart away "
                                 "from a half-integer")
        if bool(flip.any()):
            flips["voxel"] += int(flip.sum())
            log(f"  voxel rounding: {int(flip.sum())} coordinates round apart at a half-integer")
        return card

    with contextlib.ExitStack() as stack:
        for mod, name, fn in ((pv2, "furthest_point_sample", exact("FPS", fps)),
                              (pv2, "ball_query", exact("ball query", bq)),
                              (pv, "normalize_coords_for_voxelization", vox_coords),
                              (nb, "three_nn", three_nn)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def pvcnn2_reference_phase(run: Run, enc, dev) -> None:
    """The same weights on PVCNN2_CHECK_B of the main path's clouds, card
    vs CPU: the selections first, then the output (``TOL_PVCNN2``)."""
    pc_n, _ = _normalized(dev, PVCNN2_B, SEED + 31)
    pc = pc_n[:PVCNN2_CHECK_B]
    enc_cpu = copy.deepcopy(enc).cpu()
    record, flips = [], {"3-NN": 0, "voxel": 0}
    log(f"[pvcnn2 reference] PVCNN2Encoder B={PVCNN2_CHECK_B} x N={N_POINTS}: card vs CPU")
    with selections(record, None, flips), torch.no_grad():
        got = enc(pc).cpu()
    kinds = [k for k, _ in record]
    with selections([], list(record), flips), torch.no_grad():
        want = enc_cpu(pc.cpu())
    log(f"  selections compared: {', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}"
        f"; FPS and ball-query indices equal; flips at near-ties: 3-NN {flips['3-NN']}, "
        f"voxel rounding {flips['voxel']}")
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= TOL_PVCNN2 * top
    log(f"  output: max_abs_err {err:.3e} (rel {err / max(top, 1e-30):.3e} of max|ref| {top:.3f}) "
        f"tol {TOL_PVCNN2 * top:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        run.failures.append("PVCNN2Encoder: card and CPU disagree")

    # the control: the card again with TF32 convolutions (cuDNN), the
    # nearest lower precision; the selections depend on the coordinates
    # alone, so they must be the float32 run's, and the limit must fail it
    ctrl_record = []
    torch.backends.cudnn.allow_tf32 = True
    try:
        with selections(ctrl_record, None, flips), torch.no_grad():
            ctrl = enc(pc).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    picks = [(k, v[1] if k == "3-NN" else v) for k, v in record]
    ctrl_picks = [(k, v[1] if k == "3-NN" else v) for k, v in ctrl_record]
    if len(picks) != len(ctrl_picks) or not all(
            k == kc and torch.equal(v, vc) for (k, v), (kc, vc) in zip(picks, ctrl_picks)):
        run.failures.append("PVCNN2Encoder TF32 control: its selections differ from the "
                            "float32 run's")
    err_ctrl = (ctrl - want).abs().max().item()
    caught = err_ctrl > TOL_PVCNN2 * top
    log(f"  control, TF32 convolutions: max_abs_err {err_ctrl:.3e} (rel "
        f"{err_ctrl / max(top, 1e-30):.3e}), selections equal to the float32 run's -> "
        f"{'above the limit' if caught else 'WITHIN the limit: FAIL'}")
    if not caught:
        run.failures.append("PVCNN2Encoder: TOL_PVCNN2 does not fail TF32 convolutions")


# ---------------------------------------------------------------------------
# the micro-benchmark path
# ---------------------------------------------------------------------------

MB_KERNEL = {"mm": "mm_chain_kernel", "silu": "silu_chain_kernel",
             "repeat": "bcast_chain_kernel"}


def mb_tools() -> dict:
    from graspldm_tpu_torch.tools import bench_mm, bench_repeat, bench_silu

    return {"mm": bench_mm, "silu": bench_silu, "repeat": bench_repeat}


def mb_operands(tool: str, R: int, dev, seed: int, dense: bool = False) -> dict:
    """The tool's inputs of ``R`` rows (its ``make_inputs`` of ``seed``, as
    its ``bench()`` makes them) and, by form: the kernel (``reps`` as the
    tool's unless given), its plain version, the one PyTorch call that
    computes one rep (the yardstick), the operations by type (a list: each
    entry one way the card can compute the function) and the bytes moved
    (each input read once, the output written once) for the bound.
    ``dense`` swaps the tool's one-hot pool for a seeded normal ``pf`` and
    ``pb = bf16(pf)``: the one-hot pool sums 32 consecutive k rows with one
    weight, so a wrong k mapping inside an mma k-step would still agree."""
    m = mb_tools()[tool]
    reps = m.REPS
    if tool == "mm":
        x = m.make_inputs(R, dev, seed)
        if dense:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            pf = torch.randn((m.K, m.N), generator=gen, device=dev)
            pb = pf.to(torch.bfloat16)
        else:
            pf, pb = m.make_pool(dev)
        sq = x.float() * x.float()
        hi = sq.to(torch.bfloat16)
        lo = (sq - hi.float()).to(torch.bfloat16)
        # one rep, one call: float32 (TF32 off), bf16 (cuBLAS, fp32 accumulate),
        # split as one product [hi | lo] @ [pool; pool]
        lib = {"f32": (sq, pf), "bf16": (x * x, pb),
               "split": (torch.cat([hi, lo], 1), torch.cat([pb, pb], 0))}
        flops = 2.0 * R * m.K * m.N * reps
        # the chain's function in float64 (the multiplier is bf16(0.999) = 1,
        # so the reps are equal; hi + lo is the float32 square exactly)
        x2 = x.double() * x.double()
        a64 = {"f32": x2, "bf16": (x * x).double(), "split": x2}
        return dict(
            kern=lambda f, r=reps: m.mm_chain_apply(x, pf, pb, f, r),
            plain=lambda f: m.plain_chain(x, pf, pb, f),
            exact=lambda f: reps * (a64[f] @ (pf if f == "f32" else pb).double()),
            library=lambda f: torch.matmul(*lib[f]),
            # f32: either once on the CUDA cores or as the five exact bf16
            # products the kernel runs; the bound is the faster way
            ops=lambda f: [{"fp32": flops}, {"bf16": 5 * flops}] if f == "f32" else
            [{"bf16": flops * (2 if f == "split" else 1)}],
            bytes=lambda f: nbytes(x, pf if f == "f32" else pb) + R * m.N * 4,
            what=f"{reps}-rep chain of x^2 @ pool, x bf16 [{R}, {m.K}], "
                 f"{'dense ' if dense else ''}pool [{m.K}, {m.N}]")
    if tool == "silu":
        x = m.make_inputs(R, MB_W, dev, seed)
        # an element and rep: 2 special-function operations (exp and the
        # reciprocal of the quotient) and 3 float32 ones (1 + e, the product
        # or the rounding steps, the chain's multiply)
        return dict(
            kern=lambda f, r=reps: m.silu_chain_apply(x, f, r),
            plain=lambda f: m.plain_chain(x, f),
            library=lambda f: torch.nn.functional.silu(x),
            ops=lambda f: [{"sfu": 2.0 * reps * x.numel(), "fp32": 3.0 * reps * x.numel()}],
            bytes=lambda f: 2 * nbytes(x),
            what=f"{reps}-rep SiLU chain on x bf16 [{R}, {MB_W}]")
    (s, v), b = m.make_inputs(R, dev, seed), m.qbcast(dev)
    # per rep and row: L*hd products, (L-1)*hd sums, 3*L*H for the s update;
    # matmul adds the one-hot product on the tensor cores
    elem = 1.0 * reps * R * (m.L * m.HD + (m.L - 1) * m.HD + 3 * m.L * m.H)
    return dict(
        kern=lambda f, r=reps: m.bcast_chain_apply(s, v, b, f, r),
        plain=lambda f: m.plain_chain(s, v, b, f),
        library=lambda f: torch.einsum("rlh,rlhd->rhd", s.view(R, m.L, m.H),
                                       v.view(R, m.L, m.H, m.D)),
        ops=lambda f: [{"fp32": elem, **({"bf16": 2.0 * reps * R * m.L * m.H * m.L * m.HD}
                                         if f == "matmul" else {})}],
        bytes=lambda f: nbytes(s, v, b) + R * m.HD * 2,
        what=f"{reps}-rep score broadcast, s [{R}, {m.L * m.H}], v [{R}, {m.L * m.HD}] bf16")


def mb_bound(ways: list, nbytes_: int, peaks: dict) -> dict:
    """The least time: over the ways the card can compute the function
    (each a dict of operations by type), the least of the largest of the
    bytes' time and each operation type's time at its peak rate
    (``peaks``, operations a second)."""
    best = None
    for ops in ways:
        times = {"bytes": nbytes_ / PEAK_BYTES, **{k: v / peaks[k] for k, v in ops.items()}}
        by = max(times, key=times.get)
        if best is None or times[by] < best[0]:
            best = (times[by], by, ops)
    t, by, ops = best
    return dict(bound_ms=1e3 * t, bound_by="bytes" if by == "bytes" else "operations",
                bound_type=by, flops=sum(ops.values()), bytes=nbytes_)


def sfu_rate(dev) -> float:
    """Special-function results a second: SFU_PER_SM_CLK per SM at the
    card's top SM clock (nvidia-smi's clocks.max.sm, in MHz)."""
    from graspldm_tpu_torch.utils.profiling import query_gpu

    mhz = float(query_gpu(dev, "clocks.max.sm").split()[0])
    return SFU_PER_SM_CLK * torch.cuda.get_device_properties(dev).multi_processor_count * mhz * 1e6


# the kernels (and template instances) that are meant to run on the tensor
# cores; every other kernel must issue no HMMA, and none a TF32 one
TENSOR_CORE_KERNELS = {("mm_chain_kernel", "f32"), ("mm_chain_kernel", "bf16"),
                       ("mm_chain_kernel", "split"), ("bcast_chain_kernel", "matmul"),
                       ("ddim_sampler_kernel", "bf16"), ("full_kernel", "bf16"),
                       ("full_kernel", "fp32"), ("stage_kernel", "bf16")}


def sass_check(run: Run) -> None:
    """``cuobjdump -sass`` of every built library: the kernels of
    TENSOR_CORE_KERNELS issue HMMA, every other kernel (the float32
    ``ddim_sampler_kernel`` and ``stage_kernel``, ``final_kernel`` among
    them) none, and no kernel a TF32 HMMA.
    Instances are named by their template argument (a micro-benchmark
    kernel's form, or bf16 / fp32)."""
    from graspldm_tpu_torch.cuda_build import library_path, nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    names = "|".join(sorted(REPLACES, key=len, reverse=True))
    tools = mb_tools()
    forms = {MB_KERNEL[t]: m.FORMS for t, m in tools.items()}
    found = {}
    for src in sorted({os.path.basename(v) for v in SOURCES.values()}):
        out = subprocess.run([cuobjdump, "-sass", str(library_path(src))], capture_output=True,
                             text=True, check=True, timeout=300).stdout
        for chunk in out.split("Function : ")[1:]:
            m = re.search(rf"({names})(?:I(?:Li(\d+)E|(13__nv_bfloat16)E|(f)E))?",
                          chunk.split("\n", 1)[0])
            if not m:
                continue
            name, arg = m.group(1), m.group(2)
            if arg is not None:
                inst = forms[name][int(arg)] if name in forms else arg
            else:
                inst = "bf16" if m.group(3) else "fp32" if m.group(4) else ""
            lines = [ln for ln in chunk.splitlines() if "HMMA" in ln]
            found[(name, inst)] = (len(lines), sum("TF32" in ln for ln in lines))
    for (name, inst), (n, tf32) in sorted(found.items()):
        want = (name, inst) in TENSOR_CORE_KERNELS
        ok = (n > 0) == want and tf32 == 0
        log(f"  SASS {name}{f'<{inst}>' if inst else ''}: {n} HMMA ({tf32} TF32)"
            f"{' -- tensor cores' if want else ''} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            run.failures.append(f"SASS {name} {inst}: {n} HMMA, {tf32} TF32 "
                                f"(tensor cores wanted: {want})")
    missing = sorted(set(REPLACES) - {k for k, _ in found}) + \
        sorted(f"{k} {i}" for k, i in TENSOR_CORE_KERNELS - set(found))
    if missing:
        run.failures.append(f"SASS: not found in the libraries: {missing}")


def microbench_kernel_phase(run: Run, dev) -> None:
    """Each micro-benchmark kernel in each form against its plain version at
    MB_R and MB_RAGGED rows; at MB_R timed beside its one-rep time, its
    plain version and the library call (times the reps)."""
    log("[kernels] SASS of the libraries; micro-benchmark kernels vs their plain versions")
    sass_check(run)
    peaks = {**PEAK_FLOPS, "sfu": sfu_rate(dev)}
    for tool, mod in mb_tools().items():
        name = MB_KERNEL[tool]
        checked = {f: [] for f in mod.FORMS}
        for R in (MB_R, MB_RAGGED):
            ops = mb_operands(tool, R, dev, SEED + 61)
            for form in mod.FORMS:
                got, ref = ops["kern"](form), ops["plain"](form)
                torch.cuda.synchronize()
                label = f"{name} {form} R={R}"
                if tool == "mm":
                    err = run.compare(label, got, ref, TOL_MM)
                    # the product as a dense one, on a pool that tells every k apart
                    dense = mb_operands(tool, R, dev, SEED + 67, dense=True)
                    got_d, ref_d = dense["kern"](form), dense["plain"](form)
                    checked[form].append(dict(R=R, pool="dense", max_abs_err=run.compare(
                        f"{label} dense pool", got_d, ref_d, TOL_MM_DENSE)))
                    exact = dense["exact"](form)
                    top = exact.abs().max().item()
                    log(f"    against the float64 product: kernel "
                        f"{(got_d.double() - exact).abs().max().item() / top:.3e}, plain (cuBLAS "
                        f"fp32 products, TF32 off) "
                        f"{(ref_d.double() - exact).abs().max().item() / top:.3e} of max|ref|")
                else:
                    diff = (got.float() - ref.float()).abs()
                    err, n = diff.max().item(), int((diff > 0).sum())
                    ok = torch.equal(got, ref)
                    log(f"  {label}: {'bitwise equal' if ok else f'{n} entries DIFFER'} "
                        f"(max_abs_err {err:.3e}, max|ref| {ref.float().abs().max().item():.3e})")
                    if not ok:
                        run.failures.append(f"{label}: kernel disagrees with its plain version")
                checked[form].append(dict(R=R, max_abs_err=err))
                if R != MB_R:
                    continue
                k_ms = cuda_ms(lambda: ops["kern"](form), 20)
                r1_ms = cuda_ms(lambda: ops["kern"](form, 1), 20)
                p_ms = cuda_ms(lambda: ops["plain"](form), 3)
                l_ms = cuda_ms(lambda: ops["library"](form), 20) * mod.REPS
                b = mb_bound(ops["ops"](form), ops["bytes"](form), peaks)
                tag = "fp32" if form == "f32" and tool == "mm" else "bf16"
                run.record(name, form, None, R, mod.REPS, tag, what=ops["what"], ms=k_ms,
                           plain_ms=p_ms, library_ms=l_ms, reps1_ms=r1_ms, **b)
                folded = k_ms < MIN_REPS_RATIO * r1_ms
                log(f"  {name} {form}: kernel {k_ms:.4f} ms ({mod.REPS} reps; 1 rep {r1_ms:.4f} "
                    f"ms), plain {p_ms:.4f} ms, library {l_ms:.4f} ms ({mod.REPS} calls), bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bound_type']}"
                    + (", the SFU floor" if b["bound_type"] == "sfu" else "") + ")"
                    + (f" -> FAIL: under {MIN_REPS_RATIO}x the one-rep time" if folded else ""))
                if folded:
                    run.failures.append(f"{name} {form}: {mod.REPS} reps take {k_ms:.4f} ms "
                                        f"against {r1_ms:.4f} for one")
        for form in mod.FORMS:
            r = run.records[(name, form)]["fp32" if tool == "mm" and form == "f32" else "bf16"]
            r["err"] = max(c["max_abs_err"] for c in checked[form])
            r["err_checked_at"] = checked[form]


def microbench_phase(run: Run, dev) -> None:
    """The micro-benchmark main path: each tool's timing function (the one
    its ``main()`` calls) at the tools' defaults on the card, its lines as
    ``main()`` prints them; each form's launches (its result, one warm-up,
    MB_ITERS timed) booked to that form, its output held against its plain
    version on the same inputs and the forms against each other as the
    tools expect (split error-free, the broadcasts bitwise)."""
    from graspldm_tpu_torch.utils.profiling import device_line

    log(f"[microbench] {device_line(dev)}")
    for tool, mod in mb_tools().items():
        ops = mb_operands(tool, MB_R, dev, SEED)
        size = f"{MB_R} {MB_W}" if tool == "silu" else f"{MB_R}"
        log(f"[microbench] python -m {mod.__name__} {size} --iters {MB_ITERS}")
        args = (MB_R, MB_W) if tool == "silu" else (MB_R,)
        for r in mod.bench(*args, dev, MB_ITERS, seed=SEED):
            log("  " + mod.line(r))
            out, form = r["out"], r["form"]
            if out.shape[0] != MB_R or not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"{tool} {form}: output {tuple(out.shape)} not finite")
            run.expect_more(f"microbench {tool}", form, **{MB_KERNEL[tool]: MB_ITERS + 2})
            ref = ops["plain"](form)
            same = torch.equal(out, ref) if tool != "mm" else \
                (out - ref).abs().max().item() <= TOL_MM * ref.abs().max().item()
            wanted = {"split": 1e-4, "repeat": 0.0, "narrow": 0.0}.get(form)
            agree = wanted is None or r["err"] <= wanted
            log(f"  {form}: output vs its plain version {'ok' if same else 'FAIL'}; vs the first "
                f"form {r['err']:.2e}" + ("" if wanted is None else
                                          f" (limit {wanted:.0e}: {'ok' if agree else 'FAIL'})"))
            if not (same and agree):
                run.failures.append(f"microbench {tool} {form}: output wrong")


def launches_of(run: Run, name: str, config: str) -> dict:
    """Launches of kernel ``name`` by the calls of ``config``, per main path."""
    return {p: run.launches.get((p, name, config), 0) for p in run.paths}


def kernels_line(run: Run) -> dict:
    entries = []
    for (name, config), r in run.records.items():
        # a kernel held in bf16 reports bf16 first, fp32 beside it; an
        # fp32-only kernel (fps_kernel) reports fp32
        bf, fp = (r["bf16"], r.get("fp32", {})) if "bf16" in r else (r["fp32"], {})
        by_path = launches_of(run, name, config)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "max_abs_err": bf.get("err"),
            "ms": bf.get("ms"), "plain_ms": bf.get("plain_ms"), "bound_ms": bf.get("bound_ms"),
            "bound_by": bf.get("bound_by"), "library_ms": bf.get("library_ms"),
            "dtype": "bfloat16" if "bf16" in r else "float32", "config": config, "what": r["what"], "L": r["L"],
            "BG": r["BG"], "steps": r["steps"], "launches_by_path": by_path,
            "err_checked_at": bf.get("err_checked_at", [
                dict(BG=r["BG"], steps=r["steps"], max_abs_err=bf.get("err"))]),
            "max_abs_err_fp32": fp.get("err"), "ms_fp32": fp.get("ms"),
            "plain_ms_fp32": fp.get("plain_ms"), "bound_ms_fp32": fp.get("bound_ms"),
            "bound_by_fp32": fp.get("bound_by"),
            **{f"{k}{sfx}": t[k] for sfx, t in (("", bf), ("_fp32", fp))
               for k in ("chain_ms", "timed_at", "unsplit_chain_ms", "attention_ms",
                         "chain_vs_unsplit", "reps1_ms", "vs_dpmpp_per_step") if k in t},
            **({"err_checked_at_fp32": fp["err_checked_at"]}
               if "err_checked_at" in fp and "bf16" in r else {}),
            "launches_per_call": run.per_call.get((name, config), {}),
            **{k: v for k, v in bf.items() if k.startswith("bf16_vs_fp32_plain")},
            **({"chain_vs_whole": bf["chain_vs_whole"],
                "chain_vs_whole_fp32": fp.get("chain_vs_whole")} if "chain_vs_whole" in bf
               else {}),
        })
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs an NVIDIA GPU")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from graspldm_tpu_torch.utils.profiling import device_line

    card = device_line(dev)
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    from graspldm_tpu_torch.cuda_build import load_library
    from graspldm_tpu_torch.diffusion import DiffusionSchedule

    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    run = Run()
    ddim_models = build_models("bfloat16", dev)
    ppc_ddim = build_models("bfloat16", dev, **PPC)
    fpc_edm = build_models("bfloat16", dev, elucidated=True)
    ppc_edm = build_models("bfloat16", dev, elucidated=True, **PPC)
    cls_fpc = build_models("bfloat16", dev, conditioning="class")
    region_ppc = build_models("bfloat16", dev, elucidated=True, conditioning="region", **PPC)
    run.phase("kernels fpc", kernel_phase, *ddim_models, dev)
    run.phase("kernels EDM fpc", edm_kernel_phase, fpc_edm[1], fpc_edm[2], dev)
    ppc_sched = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    run.phase("kernels ppc", ppc_kernel_phase, ppc_edm[1], ppc_edm[2], ppc_sched, dev)
    run.phase("control", control_phase)
    run.phase("step kernels fpc", step_kernel_phase, "fpc", fpc_edm[1], fpc_edm[2],
              ddim_models[2].schedule, dev, BG)
    run.phase("step kernels ppc", step_kernel_phase, "ppc", ppc_edm[1], ppc_edm[2],
              ppc_sched, dev, PPC_BG)
    run.phase("fps kernel", fps_kernel_phase, dev)
    run.phase("full kernel", full_kernel_phase,
              [("fpc", "fpc", fpc_edm[1]), ("fpc", "fpc class-conditioned", cls_fpc[1]),
               ("ppc", "ppc", ppc_edm[1])], dev)
    run.phase("hybrid kernels", hybrid_kernel_phase, ddim_models[0], region_ppc[1], ppc_edm[1],
              dev)
    run.phase("microbench kernels", microbench_kernel_phase, dev)

    run.reset_counts("ddim")
    run.phase("generation ddim", generation_phase, ddim_models, ppc_ddim, dev)
    run.phase("server ddim", server_phase, ddim_models, dev, STEPS, "ddim",
              "ddim_sampler_kernel")
    log(f"[main path ddim] launches: {counts()}")

    run.reset_counts("edm")
    run.phase("generation EDM", edm_generation_phase, fpc_edm, ppc_edm, dev)
    run.phase("server EDM", server_phase, fpc_edm, dev, EDM_STEPS["dpmpp"], "dpmpp",
              "dpmpp_sampler_kernel")
    log(f"[main path EDM] launches: {counts()}")

    run.reset_counts("trajectory")
    run.phase("trajectories", trajectory_phase,
              dict(ddim=ddim_models, edm=fpc_edm), dict(ddim=ppc_ddim, edm=ppc_edm), dev)
    log(f"[main path trajectory] launches: {counts()}")

    run.reset_counts("guided")
    run.phase("guided", guided_phase, cls_fpc, ddim_models, fpc_edm, region_ppc, dev)
    run.phase("server class-conditioned", server_phase, cls_fpc, dev, STEPS, "ddim",
              "ddim_sampler_kernel")
    log(f"[main path guided] launches: {counts()}")

    run.reset_counts("hybrid")
    run.phase("hybrid", hybrid_phase, ddim_models, region_ppc, dev)
    log(f"[main path hybrid] launches: {counts()}")

    encoder = build_pvcnn2(dev)
    run.reset_counts("pvcnn2")
    run.phase("pvcnn2 encoder", pvcnn2_phase, encoder, dev)
    log(f"[main path pvcnn2] launches: {counts()}")

    run.reset_counts("microbench")
    run.phase("microbench", microbench_phase, dev)
    log(f"[main path microbench] launches: {counts()}")
    for name, config in run.records:
        n = launches_of(run, name, config)
        log(f"  {name} at {config}: {n}")
        if sum(n.values()) < 1:
            run.failures.append(f"{name} at {config} was not launched on any main path")

    run.phase("pvcnn2 reference", pvcnn2_reference_phase, encoder, dev)
    run.phase("reference", reference_phase, dev)
    run.phase("hybrid reference", hybrid_reference_phase, dev)
    run.phase("module route", module_route_phase,
              {"fpc": ddim_models, "ppc": ppc_ddim, "EDM fpc": fpc_edm, "EDM ppc": ppc_edm,
               "class fpc": cls_fpc, "region ppc": region_ppc}, dev)
    run.phase("pvcnn attention", pvcnn_attention_phase, dev)

    log(f"[done] wall {time.perf_counter() - t_start:.1f} s; {card}")
    if run.failures:
        log("FAILED:\n  " + "\n  ".join(run.failures))
        return 1
    log(json.dumps(kernels_line(run)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
