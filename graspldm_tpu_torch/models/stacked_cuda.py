"""Hopper kernels for the conditional ResNet1D core.

Counterpart of :mod:`graspldm_tpu.models.stacked_pallas`. Three kernels,
built from ``csrc/resnet1d_blocks.cuh``:

* ``stage_kernel`` replaces ``stacked_pallas.py:_stage_kernel``: one network
  stage (2 ResnetBlocks, residual linear attention, k3 projection to the
  next width) over a block of rows;
* ``final_kernel`` replaces ``stacked_pallas.py:_final_kernel``: the final
  ResnetBlock and the 1x1 head to one channel;
* ``full_kernel`` (``csrc/full_net.cu``) replaces
  ``stacked_pallas.py:_full_kernel``: every stage, the final ResnetBlock and
  the head in one launch, the activations kept in shared memory between
  stages. :func:`stacked_denoiser_apply` runs it with ``fuse_stages=True``
  (the guided samplers' denoiser), the stage chain otherwise (the decoder).

* ``hybrid_stage_kernel`` and ``hybrid_final_kernel`` (``csrc/hybrid.cu``)
  replace ``stacked_pallas.py:_hybrid_stage_kernel`` and
  ``_hybrid_final_kernel``: the route with attention between launches
  (:data:`XLA_ATTENTION`, L > 4). Hybrid stage i runs stage i - 1's k3
  projection (i > 0) and stage i's two ResnetBlocks, and stops before the
  attention, which runs in plain PyTorch between the launches
  (:func:`.stacked_denoiser.attention_stacked`); the hybrid final kernel
  runs the last stage's projection, the final ResnetBlock and the head.

All are generic over L (4 for the denoiser, 16 for the VAE decoder) and the
stage widths, and take float32 or bfloat16 activations and weights.
``stage_kernel``, ``final_kernel`` and ``full_kernel`` run their products
on the tensor cores in both dtypes, from the fragment-ordered copies
(:func:`tc_fragments`) that :class:`PackedNet` appends after the math form;
float32 through the exact bf16 split (:func:`bf16_parts`). The float32
``stage_kernel`` and ``final_kernel`` also keep their CUDA-core instances,
the control that every float32 tensor-core kernel is held against
(``stage_apply(..., cuda_cores=True)``, ``final_apply(..., cuda_cores=True)``;
counted apart, and launched by no main path). What bounds them
on the H100 and what the design does about it is in the notes at the top of
``csrc/kernels.cu``, ``csrc/full_net.cu``, ``csrc/tc_blocks.cuh`` and
``csrc/hybrid.cu``.

Beside each kernel is its plain PyTorch version (``stage_plain``,
``final_plain``, ``full_plain``, ``hybrid_stage_plain``,
``hybrid_final_plain``): same math, rounding to the compute dtype
at the same points. A wrapper runs the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, raising if the launch fails; it
never falls back. Each kernel is launched and counted through its handle
(``STAGE_KERNEL``, ...: :class:`~graspldm_tpu_torch.cuda_build.KernelCounter`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..cuda_build import KernelCounter, check_operand, on_cuda, ptr
from .stacked_denoiser import DenoiserDims, attention_stacked, compute_emb_s_stacked

__all__ = [
    "KernelCounter",
    "STAGE_KERNEL",
    "FINAL_KERNEL",
    "STAGE_KERNEL_CUDA_CORES",
    "FINAL_KERNEL_CUDA_CORES",
    "FULL_KERNEL",
    "HYBRID_STAGE_KERNEL",
    "HYBRID_FINAL_KERNEL",
    "XLA_ATTENTION",
    "PackedNet",
    "tc_fragments",
    "bf16_parts",
    "stage_plain",
    "final_plain",
    "full_plain",
    "hybrid_stage_plain",
    "hybrid_final_plain",
    "stage_apply",
    "final_apply",
    "full_apply",
    "hybrid_stage_apply",
    "hybrid_final_apply",
    "init_conv",
    "stacked_denoiser_apply",
]

# int64 record layout read by csrc/resnet1d_blocks.cuh (R_* / S_* / N_*)
REC_SIZE = 40
NET_HDR = 8
N_TC = 4  # header slot: where the tensor-core table starts in the layout
# the tensor-core table (csrc/tc_blocks.cuh, T_*): per stage, the offsets of
# the fragment-ordered copies of its products; then the final block's two
TC_SLOTS = ("r1_w1", "r1_w2", "r2_w1", "r2_w2", "wqkv", "wo", "wp")
TC_REC = 8
RES_SLOTS = ("mlp_w", "mlp_b", "w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2")
ATTN_SLOTS = ("attn_g", "wqkv", "wo", "bo", "out_g", "wp", "bp")
AUX_KEYS = ("fourier_w", "time_w1", "time_b1", "time_w2", "time_b2", "input_w", "input_b",
            "cls_w", "cls_b", "region_w1", "region_b1", "region_w2", "region_b2")
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-5  # the kernel path's LayerNorm eps in every dtype (as stacked_pallas)


STAGE_KERNEL = KernelCounter("stage_kernel", "gl_stage_forward")
FINAL_KERNEL = KernelCounter("final_kernel", "gl_final_forward")
# the float32 CUDA-core control of the two (``cuda_cores=True``), counted apart
STAGE_KERNEL_CUDA_CORES = KernelCounter("stage_kernel_cuda_cores", "gl_stage_forward_cuda_cores")
FINAL_KERNEL_CUDA_CORES = KernelCounter("final_kernel_cuda_cores", "gl_final_forward_cuda_cores")
FULL_KERNEL = KernelCounter("full_kernel", "gl_full_forward")
HYBRID_STAGE_KERNEL = KernelCounter("hybrid_stage_kernel", "gl_hybrid_stage_forward")
HYBRID_FINAL_KERNEL = KernelCounter("hybrid_final_kernel", "gl_hybrid_final_forward")

# Attention placement, the counterpart of stacked_pallas.XLA_ATTENTION (off
# by default there too). True routes an L > 4 network through the hybrid
# kernels, with the attention in plain PyTorch between the launches: "XLA"
# in the name is the JAX package's word for what runs outside its kernels,
# here plain PyTorch. The whole-trajectory and per-step sampler kernels and
# ``fuse_stages`` refuse it, as the JAX package's do.
XLA_ATTENTION = False


def _use_xla_attention(dims: DenoiserDims) -> bool:
    """Attention between launches (:data:`XLA_ATTENTION`) at L > 4, as
    ``stacked_pallas.py:_use_xla_attention``."""
    return XLA_ATTENTION and dims.seq_len > 4


class PackedNet:
    """Kernel operands of one ResNet1D core in one compute dtype.

    All kernel weights live in one flat ``dtype`` buffer (each piece 8-element
    aligned for vector loads); ``layout`` is the int64 offset table the
    kernels read (a header, then one record per stage and one for the
    final block). ``aux`` holds the float32 embedding (and head) weights
    that run in plain PyTorch around the kernels, a conditioned denoiser's
    class / region embedding weights included. ``device=None`` packs on
    the device of ``math_w``'s tensors.

    After the math form (``math_flat``), ``flat`` holds each tensor-core
    product's weights once more, fragment-ordered (:func:`tc_fragments`),
    and the layout a table of their offsets (``layout[N_TC]``, one record
    of ``TC_REC`` a stage and one for the final block): in bf16 one copy a
    product; in float32 the three exact bf16 parts of the weight
    (:func:`bf16_parts`), one whole copy after another (the part stride is
    the copy's length, which the kernel computes from the product's shape),
    their bf16 bits two to a float32 element.
    """

    def __init__(self, math_w: Dict[str, torch.Tensor], dims: DenoiserDims,
                 dtype: torch.dtype = torch.float32, device=None):
        if dtype not in DTYPE_CODE:
            raise ValueError(f"kernel dtype must be float32 or bfloat16, got {dtype}")
        self.dims, self.dtype = dims, dtype
        # no device named: the device of the weights themselves
        device = torch.device(device) if device is not None else next(iter(math_w.values())).device
        self.aux = {k: v.to(device) for k, v in math_w.items() if k in AUX_KEYS}
        chunks: List[torch.Tensor] = []
        offsets: Dict[str, int] = {}
        n = 0
        for k, v in math_w.items():
            if k in AUX_KEYS:
                continue
            offsets[k] = n
            flat = v.reshape(-1)
            pad = (-flat.numel()) % 8
            chunks += [flat, flat.new_zeros(pad)]
            n += flat.numel() + pad
        # the tensor-core products' weights once more, fragment-ordered
        # (tc_fragments), after the math form: bf16 one copy a product;
        # float32 its three exact bf16 parts (bf16_parts), one whole copy
        # after another, their bf16 bits two to a float32 element
        self.n_math = n
        tc, frags = {}, []
        for k, (taps, v) in _tc_products(math_w, dims).items():
            frag = _tc_copy(v, taps, dtype)
            tc[k] = n
            frags.append(frag)
            n += frag.numel() // (2 if dtype == torch.float32 else 1)
        self.flat = torch.cat([torch.cat(chunks).to(device=device, dtype=dtype),
                               torch.cat(frags).to(device).view(dtype)])
        self.w = {
            k: self.flat[offsets[k]: offsets[k] + v.numel()].view(v.shape)
            for k, v in math_w.items() if k in offsets
        }

        L, E, Ce, G = dims.seq_len, dims.emb_dim, dims.cond_channels, dims.groups
        head = [dims.heads, dims.dim_head]
        layout = [len(dims.block_channels), offsets["init_w"], offsets["init_b"],
                  self.w["init_w"].shape[1]]
        layout += [0] * (NET_HDR - len(layout))
        for i, (C, Cout) in enumerate(zip(dims.cins, dims.block_channels)):
            rec = [L, C, Cout, E, Ce, G] + head
            for r in ("r1", "r2"):
                rec += [offsets[f"b{i}{r}_{s}"] for s in RES_SLOTS]
            rec += [offsets[f"b{i}_{s}"] for s in ATTN_SLOTS]
            layout += rec + [0] * (REC_SIZE - len(rec))
        rec = [L, dims.block_channels[-1], 0, E, Ce, G] + head
        rec += [offsets[f"final_{s}"] for s in RES_SLOTS]
        rec += [offsets["final_fw"], offsets["final_fb"]]
        layout += rec + [0] * (REC_SIZE - len(rec))
        layout[N_TC] = len(layout)
        for i in range(len(dims.block_channels)):
            layout += [tc[f"b{i}_{s}"] for s in TC_SLOTS] + [0] * (TC_REC - len(TC_SLOTS))
        layout += [tc["final_w1"], tc["final_w2"]] + [0] * (TC_REC - 2)
        self.layout = torch.tensor(layout, dtype=torch.int64, device=device)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def math_flat(self) -> torch.Tensor:
        """The weights in their math form (``flat`` without the
        fragment-ordered copies): what one pass of the network reads."""
        return self.flat[: self.n_math]

    def v(self, name: str) -> torch.Tensor:
        """A weight as float32 values (exact for both dtypes)."""
        return self.w[name].float()

    @property
    def cmax(self) -> int:
        """Widest activation of the network (sizes the kernels' buffers)."""
        d = self.dims
        return max((self.w["init_w"].shape[1],) + tuple(d.cins) + tuple(d.block_channels))


def _tc_products(math_w: Dict[str, torch.Tensor], dims: DenoiserDims) -> Dict[str, tuple]:
    """The products the tensor-core network bodies run on the tensor cores
    (``csrc/tc_blocks.cuh``), by the name of their slot in the tensor-core
    table: ``(taps, W [taps*Ck, N])`` (taps 3: a k3 conv over Ck channels;
    1: a dense product of depth Ck)."""
    out = {}
    for i in range(len(dims.block_channels)):
        for r in ("r1", "r2"):
            for s in ("w1", "w2"):
                out[f"b{i}_{r}_{s}"] = (3, math_w[f"b{i}{r}_{s}"])
        out[f"b{i}_wqkv"] = (1, math_w[f"b{i}_wqkv"])
        out[f"b{i}_wo"] = (1, math_w[f"b{i}_wo"])
        out[f"b{i}_wp"] = (3, math_w[f"b{i}_wp"])
    out["final_w1"] = (3, math_w["final_w1"])
    out["final_w2"] = (3, math_w["final_w2"])
    return out


def bf16_parts(x: torch.Tensor) -> torch.Tensor:
    """The exact three-part bf16 split of a float32 tensor, ``[3,
    *x.shape]`` bf16 with ``p1 + p2 + p3 == x`` exactly: ``p1 = bf16(x)``,
    ``p2 = bf16(x - p1)``, ``p3 = bf16(x - p1 - p2)`` (8 + 8 + 8
    significant bits hold float32's 24 wherever no part underflows bf16's
    range, that is for |x| above about 2^-110). The float32 tensor-core
    products split their weights so at packing time and their activations
    so in the kernel (``csrc/tc_blocks.cuh`` ``split3``), and run the six
    bf16 products ``a_i * w_j`` with ``i + j <= 4``."""
    x = x.float()
    p1 = x.to(torch.bfloat16)
    r1 = x - p1.float()
    p2 = r1.to(torch.bfloat16)
    return torch.stack([p1, p2, (r1 - p2.float()).to(torch.bfloat16)])


def _tc_copy(v: torch.Tensor, taps: int, dtype: torch.dtype) -> torch.Tensor:
    """A product's fragment-ordered copy in a pack of ``dtype``, flat bf16:
    its fragments (bf16), or the fragments' three exact bf16 parts one
    whole copy after another (float32). Splitting the fragments is
    splitting each part's fragments, as the split is elementwise and the
    padding zero, in a third of the launches."""
    frag = tc_fragments(v, taps)
    return frag.to(torch.bfloat16) if dtype == torch.bfloat16 else bf16_parts(frag).reshape(-1)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def tc_fragments(W: torch.Tensor, taps: int) -> torch.Tensor:
    """``W [taps*Ck, N]`` as the B operand of ``mma.sync.m16n8k16``, in the
    order a warp loads it (``csrc/tc_blocks.cuh``): flat ``[KS, NP, 32, 8]``.

    Each tap's Ck rows are padded with zero rows to a multiple of 16 (so a
    k-step of 16 never spans two taps) and N with zero columns to a
    multiple of 16; KS = taps * Ck16 / 16 k-steps, NP = N16 / 16 column
    pairs. Lane ``4g + t`` of pair p at k-step s holds, for n-tile j = 0, 1
    (column n = 16p + 8j + g), the four values W[16s + 2t + q*8 + h, n] in
    the order (q, h) = (0, 0), (0, 1), (1, 0), (1, 1): registers b0 and b1
    of n-tile j, one 16-byte load a lane for two n-tiles."""
    K, N = W.shape
    Ck = K // taps
    Wp = W.new_zeros((taps, _up16(Ck), _up16(N)))
    Wp[:, :Ck, :N] = W.reshape(taps, Ck, N)
    KS, NP = taps * _up16(Ck) // 16, _up16(N) // 16
    # k = 16s + 8q + 2t + h, n = 16p + 8j + g -> [s, p, g, t, j, q, h]
    v = Wp.reshape(KS, 2, 4, 2, NP, 2, 8)
    return v.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)


# ---------------------------------------------------------------------------
# plain PyTorch versions: [B, L, C] float32 values, rounded to the compute
# dtype wherever the kernels store an activation
# ---------------------------------------------------------------------------


def _rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def _conv3(x, W, b):
    """k3 / pad 1 conv along L: ``x [B, L, C] @ W [3C, N]`` (row ``t*C + c``)."""
    L = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    return torch.cat([xp[:, t:t + L] for t in range(3)], dim=-1) @ W + b


def _group_norm(h, g, be, groups):
    B, L, C = h.shape
    hg = h.reshape(B, L, groups, C // groups)
    mu = hg.mean(dim=(1, 3), keepdim=True)
    var = ((hg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((hg - mu) * torch.rsqrt(var + 1e-5)).reshape(B, L, C) * g + be


def _layer_norm(x, g):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g


def _resblock(w: PackedNet, pfx: str, x, esum):
    dt, Ce = w.dtype, float(w.dims.cond_channels)
    C = x.shape[-1]
    ss = esum @ w.v(f"{pfx}_mlp_w") + Ce * w.v(f"{pfx}_mlp_b")
    scale, shift = ss[:, None, :C], ss[:, None, C:]
    h = _rnd(_conv3(x, w.v(f"{pfx}_w1"), w.v(f"{pfx}_b1")), dt)
    h = _group_norm(h, w.v(f"{pfx}_g1"), w.v(f"{pfx}_be1"), w.dims.groups)
    h = _rnd(F.silu(h * (scale + Ce) + shift), dt)
    h = _rnd(_conv3(h, w.v(f"{pfx}_w2"), w.v(f"{pfx}_b2")), dt)
    h = _group_norm(h, w.v(f"{pfx}_g2"), w.v(f"{pfx}_be2"), w.dims.groups)
    return _rnd(F.silu(h) + x, dt)


def _attention(w: PackedNet, i: int, x):
    dt = w.dtype
    B, L, _ = x.shape
    H, D = w.dims.heads, w.dims.dim_head
    n = _rnd(_layer_norm(x, w.v(f"b{i}_attn_g")), dt)
    q, k, v = (
        t.reshape(B, L, H, D)
        for t in _rnd(n @ w.v(f"b{i}_wqkv"), dt).split(H * D, dim=-1)
    )
    q = _rnd(q.softmax(dim=-1) * D ** -0.5, dt)  # over the head channels
    k = _rnd(k.softmax(dim=1), dt)  # over the positions
    s = torch.einsum("blhd,bjhd->bhlj", q, k)
    o = _rnd(torch.einsum("bhlj,bjhe->blhe", s, v).reshape(B, L, H * D), dt)
    o = _rnd(o @ w.v(f"b{i}_wo") + w.v(f"b{i}_bo"), dt)
    return _rnd(x + _layer_norm(o, w.v(f"b{i}_out_g")), dt)


def emb_sum(w: PackedNet, emb: torch.Tensor) -> torch.Tensor:
    """``[B, Ce*E]`` FiLM input -> float32 sum over the Ce channels ``[B, E]``."""
    return emb.float().reshape(emb.shape[0], w.dims.cond_channels, -1).sum(1)


def _stage_core(w: PackedNet, i: int, x, esum):
    x = _resblock(w, f"b{i}r1", x, esum)
    x = _resblock(w, f"b{i}r2", x, esum)
    x = _attention(w, i, x)
    return _rnd(_conv3(x, w.v(f"b{i}_wp"), w.v(f"b{i}_bp")), w.dtype)


def _final_core(w: PackedNet, x, esum):
    x = _resblock(w, "final", x, esum)
    return _rnd(x @ w.v("final_fw") + w.v("final_fb"), w.dtype)  # [B, L]


def stage_plain(w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stage_kernel``: ``x [BG, L*C]`` -> ``[BG, L*Cout]``."""
    L = w.dims.seq_len
    h = _stage_core(w, i, x.float().reshape(x.shape[0], L, -1), emb_sum(w, emb))
    return h.reshape(x.shape[0], -1).to(w.dtype)


def final_plain(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``final_kernel``: ``x [BG, L*C]`` -> ``[BG, L]``."""
    L = w.dims.seq_len
    return _final_core(w, x.float().reshape(x.shape[0], L, -1), emb_sum(w, emb)).to(w.dtype)


def _hybrid_open(w: PackedNet, i: int, x):
    """Stage ``i - 1``'s k3 projection, with which hybrid stage ``i`` (or the
    hybrid final block, ``i`` = n_stages) opens; stage 0 opens on x."""
    if i == 0:
        return x
    return _rnd(_conv3(x, w.v(f"b{i - 1}_wp"), w.v(f"b{i - 1}_bp")), w.dtype)


def hybrid_stage_plain(w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``hybrid_stage_kernel``: ``x [BG, L*C_{i-1}]`` (stage
    0: the init conv's ``[BG, L*C_0]``) -> ``[BG, L*C_i]``, ``C_i`` =
    ``dims.cins[i]``: stage i - 1's projection, then stage i's two
    ResnetBlocks."""
    L, esum = w.dims.seq_len, emb_sum(w, emb)
    h = _hybrid_open(w, i, x.float().reshape(x.shape[0], L, -1))
    h = _resblock(w, f"b{i}r2", _resblock(w, f"b{i}r1", h, esum), esum)
    return h.reshape(x.shape[0], -1).to(w.dtype)


def hybrid_final_plain(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``hybrid_final_kernel``: ``x [BG, L*C_{n-1}]`` ->
    ``[BG, L]``: the last stage's projection, the final ResnetBlock, the
    head."""
    L, n = w.dims.seq_len, len(w.dims.block_channels)
    h = _hybrid_open(w, n, x.float().reshape(x.shape[0], L, -1))
    return _final_core(w, h, emb_sum(w, emb)).to(w.dtype)


def full_plain(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``full_kernel``: ``x [BG, L*dim0]`` (the init conv's
    output) -> ``[BG, L]``, the chain of :func:`stage_plain` over every stage
    and :func:`final_plain`, rounded at the same points."""
    L, esum = w.dims.seq_len, emb_sum(w, emb)
    h = x.float().reshape(x.shape[0], L, -1)
    for i in range(len(w.dims.block_channels)):
        h = _stage_core(w, i, h, esum)
    return _final_core(w, h, esum).to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _control(w: PackedNet, cuda_cores: bool) -> None:
    if cuda_cores and w.dtype != torch.float32:
        raise ValueError("cuda_cores: the CUDA-core control of stage_kernel and final_kernel "
                         f"is float32 only, not {w.dtype}")


def _net_operands(w: PackedNet, x: torch.Tensor, emb: torch.Tensor, cols: int):
    """Check ``x [BG, cols]`` and the FiLM input ``emb [BG, Ce*E]`` against
    the pack; the pointers of the launch's leading operands (x, emb, the
    weights, the layout)."""
    d = w.dims
    check_operand("x", x, (x.shape[0], cols), w.dtype, w.device)
    check_operand("emb", emb, (x.shape[0], d.cond_channels * d.emb_dim), w.dtype, w.device)
    return ptr(x), ptr(emb), ptr(w.flat), ptr(w.layout)


def stage_apply(w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor,
                cuda_cores: bool = False) -> torch.Tensor:
    """Network stage ``i`` on ``x [BG, L*C_i]`` with FiLM input ``emb [BG, Ce*E]``.

    ``cuda_cores=True`` launches the float32 CUDA-core control
    (``STAGE_KERNEL_CUDA_CORES``) in place of the tensor cores; no main path
    does. It raises for a bf16 pack, which has no such instance."""
    _control(w, cuda_cores)
    if not on_cuda(x):
        return stage_plain(w, i, x, emb)
    d = w.dims
    L, C, Cout = d.seq_len, d.cins[i], d.block_channels[i]
    BG = x.shape[0]
    ops = _net_operands(w, x, emb, L * C)
    out = torch.empty((BG, L * Cout), dtype=w.dtype, device=x.device)
    args = (*ops, i, ptr(out), BG, L, C, Cout, d.emb_dim, d.cond_channels, d.groups)
    if cuda_cores:  # the control takes no dtype
        STAGE_KERNEL_CUDA_CORES(x, *args)
    else:
        STAGE_KERNEL(x, DTYPE_CODE[w.dtype], *args)
    return out


def final_apply(w: PackedNet, x: torch.Tensor, emb: torch.Tensor,
                cuda_cores: bool = False) -> torch.Tensor:
    """Final ResnetBlock + head on ``x [BG, L*C]`` -> ``[BG, L]``;
    ``cuda_cores`` as :func:`stage_apply` (``FINAL_KERNEL_CUDA_CORES``)."""
    _control(w, cuda_cores)
    if not on_cuda(x):
        return final_plain(w, x, emb)
    d = w.dims
    L, C = d.seq_len, d.block_channels[-1]
    BG = x.shape[0]
    ops = _net_operands(w, x, emb, L * C)
    out = torch.empty((BG, L), dtype=w.dtype, device=x.device)
    args = (*ops, len(d.block_channels), ptr(out), BG, L, C, d.emb_dim, d.cond_channels,
            d.groups)
    if cuda_cores:
        FINAL_KERNEL_CUDA_CORES(x, *args)
    else:
        FINAL_KERNEL(x, DTYPE_CODE[w.dtype], *args)
    return out


def full_apply(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The whole core after the init conv, one launch: ``x [BG, L*dim0]``
    with FiLM input ``emb [BG, Ce*E]`` -> ``[BG, L]``."""
    if not on_cuda(x):
        return full_plain(w, x, emb)
    d = w.dims
    L, BG = d.seq_len, x.shape[0]
    ops = _net_operands(w, x, emb, L * w.w["init_w"].shape[1])
    out = torch.empty((BG, L), dtype=w.dtype, device=x.device)
    FULL_KERNEL(x, DTYPE_CODE[w.dtype], *ops, ptr(out), BG, L, d.emb_dim, d.cond_channels,
                d.groups, w.cmax)
    return out


def _hybrid(handle: KernelCounter, w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor,
            out_cols: int, C: int) -> torch.Tensor:
    """Launch a hybrid kernel for record ``i`` (stage i, or the final block
    at i = n_stages), whose input is ``[BG, L*C_{i-1}]``."""
    d = w.dims
    L, BG = d.seq_len, x.shape[0]
    Cin = d.cins[max(i - 1, 0)]
    ops = _net_operands(w, x, emb, L * Cin)
    out = torch.empty((BG, out_cols), dtype=w.dtype, device=x.device)
    handle(x, DTYPE_CODE[w.dtype], *ops, i, ptr(out), BG, L, Cin, C, d.emb_dim, d.cond_channels,
           d.groups)
    return out


def hybrid_stage_apply(w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Hybrid stage ``i`` on ``x [BG, L*C_{i-1}]`` with FiLM input ``emb
    [BG, Ce*E]`` -> ``[BG, L*C_i]`` (see :func:`hybrid_stage_plain`)."""
    if not on_cuda(x):
        return hybrid_stage_plain(w, i, x, emb)
    C = w.dims.cins[i]
    return _hybrid(HYBRID_STAGE_KERNEL, w, i, x, emb, w.dims.seq_len * C, C)


def hybrid_final_apply(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Hybrid final block on ``x [BG, L*C_{n-1}]`` -> ``[BG, L]`` (see
    :func:`hybrid_final_plain`)."""
    if not on_cuda(x):
        return hybrid_final_plain(w, x, emb)
    d = w.dims
    return _hybrid(HYBRID_FINAL_KERNEL, w, len(d.block_channels), x, emb, d.seq_len,
                   d.block_channels[-1])


def init_conv(w: PackedNet, x: torch.Tensor) -> torch.Tensor:
    """Init conv (1 -> dim0 channels, k7) on ``x [BG, L]`` (rounded to the
    compute dtype first) -> float32 values ``[BG, L, dim0]`` rounded to it.
    Plain PyTorch: the JAX package runs it in XLA too."""
    L = x.shape[1]
    xp = F.pad(_rnd(x.float(), w.dtype), (3, 3))
    cols = torch.stack([xp[:, t:t + L] for t in range(7)], dim=-1)  # [BG, L, 7]
    return _rnd(cols @ w.v("init_w") + w.v("init_b"), w.dtype)


def stacked_denoiser_apply(
    w: PackedNet, x: torch.Tensor, t: Optional[torch.Tensor], z_cond: Optional[torch.Tensor],
    input_emb: Optional[torch.Tensor] = None, fuse_stages: bool = False,
) -> torch.Tensor:
    """Core forward: ``x [BG, 1, L]`` -> ``[BG, 1, L]`` in the compute dtype.

    ``t=None`` for the non-temporal decoder core; ``input_emb``
    (``compute_input_emb``) may be precomputed, and a conditioned
    denoiser's class / region embedding (``compute_extra_emb``) is folded
    into it by the caller, as the JAX package's pipeline does.
    The FiLM input and the init conv run in plain PyTorch, as XLA runs
    them in the JAX package; then ``fuse_stages=False`` launches one
    ``stage_kernel`` per stage and ``final_kernel``, ``True`` one
    ``full_kernel``. With attention between launches
    (:data:`XLA_ATTENTION`) at L > 4, as ``stacked_denoiser_pallas_apply``
    does: one ``hybrid_stage_kernel`` launch per stage, each followed by
    the stage's attention in plain PyTorch, then ``hybrid_final_kernel``;
    ``fuse_stages=True`` raises ``ValueError`` there."""
    emb = compute_emb_s_stacked(w.aux, t, z_cond, input_emb).to(w.dtype)
    BG = x.shape[0]
    h = init_conv(w, x[:, 0, :]).reshape(BG, -1).to(w.dtype)
    if _use_xla_attention(w.dims):
        if fuse_stages:
            raise ValueError("fuse_stages is unsupported for L > 4 with attention between "
                             "launches (XLA_ATTENTION; see _use_xla_attention)")
        for i in range(len(w.dims.block_channels)):
            h = attention_stacked(w.w, i, hybrid_stage_apply(w, i, h, emb), w.dims)
        return hybrid_final_apply(w, h, emb)[:, None, :]
    if fuse_stages:
        return full_apply(w, h, emb)[:, None, :]
    for i in range(len(w.dims.block_channels)):
        h = stage_apply(w, i, h, emb)
    return final_apply(w, h, emb)[:, None, :]
