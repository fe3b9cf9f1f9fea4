"""Per-stage Hopper kernels for the conditional ResNet1D core.

Counterpart of :mod:`graspldm_tpu.models.stacked_pallas`. Two kernels, built
from ``csrc/resnet1d_blocks.cuh``:

* ``stage_kernel`` replaces ``stacked_pallas.py:_stage_kernel``: one network
  stage (2 ResnetBlocks, residual linear attention, k3 projection to the
  next width) over a block of rows;
* ``final_kernel`` replaces ``stacked_pallas.py:_final_kernel``: the final
  ResnetBlock and the 1x1 head to one channel.

Both are generic over L (4 for the denoiser, 16 for the VAE decoder) and the
stage widths, and take float32 or bfloat16 activations and weights. What
bounds them on the H100 and what the design does about it is in the note at
the top of ``csrc/kernels.cu``.

Beside each kernel is its plain PyTorch version (``stage_plain``,
``final_plain``): same math, rounding to the compute dtype at the same
points. A wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising if the launch fails; it never falls back.
Each wrapper counts its kernel launches (``STAGE_KERNEL.launches``, ...).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .stacked_denoiser import DenoiserDims, compute_emb_s_stacked

__all__ = [
    "KernelCounter",
    "STAGE_KERNEL",
    "FINAL_KERNEL",
    "PackedNet",
    "stage_plain",
    "final_plain",
    "stage_apply",
    "final_apply",
    "init_conv",
    "stacked_denoiser_apply",
]

# int64 record layout read by csrc/resnet1d_blocks.cuh (R_* / S_* / N_*)
REC_SIZE = 40
NET_HDR = 8
RES_SLOTS = ("mlp_w", "mlp_b", "w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2")
ATTN_SLOTS = ("attn_g", "wqkv", "wo", "bo", "out_g", "wp", "bp")
AUX_KEYS = ("fourier_w", "time_w1", "time_b1", "time_w2", "time_b2", "input_w", "input_b")
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-5  # the kernel path's LayerNorm eps in every dtype (as stacked_pallas)


class KernelCounter:
    """Launch count of one kernel: its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"KernelCounter({self.name!r}, launches={self.launches})"


STAGE_KERNEL = KernelCounter("stage_kernel")
FINAL_KERNEL = KernelCounter("final_kernel")


class PackedNet:
    """Kernel operands of one ResNet1D core in one compute dtype.

    All kernel weights live in one flat ``dtype`` buffer (each piece 8-element
    aligned for vector loads); ``layout`` is the int64 offset table the
    kernels read (a header, then one record per stage and one for the
    final block). ``aux`` holds the float32 embedding (and head) weights
    that run in plain PyTorch around the kernels.
    """

    def __init__(self, math_w: Dict[str, torch.Tensor], dims: DenoiserDims,
                 dtype: torch.dtype = torch.float32, device=None):
        if dtype not in DTYPE_CODE:
            raise ValueError(f"kernel dtype must be float32 or bfloat16, got {dtype}")
        self.dims, self.dtype = dims, dtype
        device = torch.device(device or "cpu")
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
        self.flat = torch.cat(chunks).to(device=device, dtype=dtype)
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
        self.layout = torch.tensor(layout, dtype=torch.int64, device=device)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def record_ptr(self, index: int) -> int:
        """Device address of record ``index`` (stages 0.., then final)."""
        return self.layout.data_ptr() + 8 * (NET_HDR + index * REC_SIZE)

    def v(self, name: str) -> torch.Tensor:
        """A weight as float32 values (exact for both dtypes)."""
        return self.w[name].float()


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, weights on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def stage_apply(w: PackedNet, i: int, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Network stage ``i`` on ``x [BG, L*C_i]`` with FiLM input ``emb [BG, Ce*E]``."""
    if not _on_cuda(x):
        return stage_plain(w, i, x, emb)
    from ..cuda_build import load_library

    d = w.dims
    L, C, Cout = d.seq_len, d.cins[i], d.block_channels[i]
    BG = x.shape[0]
    _check("x", x, (BG, L * C), w.dtype, w.device)
    _check("emb", emb, (BG, d.cond_channels * d.emb_dim), w.dtype, w.device)
    out = torch.empty((BG, L * Cout), dtype=w.dtype, device=x.device)
    rc = load_library().gl_stage_forward(
        DTYPE_CODE[w.dtype], _ptr(x), _ptr(emb), _ptr(w.flat),
        ctypes.c_void_p(w.record_ptr(i)), _ptr(out), BG, L, C, Cout, d.emb_dim,
        d.cond_channels, d.groups, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _raise_on(rc, "stage_kernel")
    STAGE_KERNEL.launches += 1
    return out


def final_apply(w: PackedNet, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Final ResnetBlock + head on ``x [BG, L*C]`` -> ``[BG, L]``."""
    if not _on_cuda(x):
        return final_plain(w, x, emb)
    from ..cuda_build import load_library

    d = w.dims
    L, C = d.seq_len, d.block_channels[-1]
    BG = x.shape[0]
    _check("x", x, (BG, L * C), w.dtype, w.device)
    _check("emb", emb, (BG, d.cond_channels * d.emb_dim), w.dtype, w.device)
    out = torch.empty((BG, L), dtype=w.dtype, device=x.device)
    rc = load_library().gl_final_forward(
        DTYPE_CODE[w.dtype], _ptr(x), _ptr(emb), _ptr(w.flat),
        ctypes.c_void_p(w.record_ptr(len(d.block_channels))), _ptr(out), BG, L, C,
        d.emb_dim, d.cond_channels, d.groups,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _raise_on(rc, "final_kernel")
    FINAL_KERNEL.launches += 1
    return out


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
    input_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Core forward through the stage kernels: ``x [BG, 1, L]`` -> ``[BG, 1, L]``
    in the compute dtype. ``t=None`` for the non-temporal decoder core;
    ``input_emb`` (``compute_input_emb``) may be precomputed."""
    emb = compute_emb_s_stacked(w.aux, t, z_cond, input_emb).to(w.dtype)
    BG = x.shape[0]
    h = init_conv(w, x[:, 0, :]).reshape(BG, -1).to(w.dtype)
    for i in range(len(w.dims.block_channels)):
        h = stage_apply(w, i, h, emb)
    return final_apply(w, h, emb)[:, None, :]
