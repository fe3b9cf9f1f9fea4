"""Weight bridge: JAX package variables (numpy) -> the port's ``state_dict``.

Takes the variable trees of :mod:`graspldm_tpu` models as nested dicts of
numpy arrays (``params``, ``batch_stats``, ``constants``), exactly as
``jax.tree.map(np.asarray, variables)`` gives them, and returns the port's
``state_dict`` for :class:`..models.GraspCVAE` / :class:`..models.GraspLatentDDM`,
the class- / region-conditioned denoisers, and the PVCNN2 family
(:class:`..models.PVCNN2`, :class:`..models.PVCNN2Encoder`,
:class:`..models.PointNet2`), whose key space is the port's own.
It is the inverse of :mod:`graspldm_tpu.utils.torch_convert`, so a round
trip through that converter checks both directions.

Layout changes: Dense ``[in, out]`` -> Linear ``[out, in]``; Conv ``WIO`` ->
``OIW``; Conv3d ``DHWIO`` -> ``OIDHW``; channel gains ``[C]`` -> ``[1, C, 1]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "grasp_ldm_state_dict",
    "class_conditioned_ldm_state_dict",
    "region_conditioned_ldm_state_dict",
    "grasp_cvae_state_dict",
    "pvconv_state_dict",
    "pvcnn_encoder_state_dict",
    "pvcnn2_state_dict",
    "pvcnn2_encoder_state_dict",
    "pointnet2_state_dict",
]

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"]))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv1x1(sd: StateDict, key: str, p: Mapping) -> None:
    """flax Dense acting on channels -> torch Conv1d(k=1) ``[out, in, 1]``."""
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"])[:, :, None])
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _gain(a) -> torch.Tensor:
    return _t(np.asarray(a).reshape(1, -1, 1))


def _resblock(sd: StateDict, pfx: str, p: Mapping) -> None:
    if "mlp_dense" in p:
        _linear(sd, f"{pfx}mlp.1", p["mlp_dense"])
    for blk in ("block1", "block2"):
        _conv1d(sd, f"{pfx}{blk}.proj", p[blk]["proj"])
        _norm(sd, f"{pfx}{blk}.norm", p[blk]["norm"])
    if "res_conv" in p:
        _conv1d(sd, f"{pfx}res_conv", p["res_conv"])


def _resnet1d(sd: StateDict, pfx: str, params: Mapping, constants: Mapping) -> None:
    """flax ResNet1D / TimeConditionedResNet1D subtree -> torch keys."""
    core = params["core"]
    _conv1d(sd, f"{pfx}init_conv", core["init_conv"])
    i = 0
    while f"blocks_{i}_res1" in core:
        b = f"{pfx}blocks.{i}."
        _resblock(sd, f"{b}0.", core[f"blocks_{i}_res1"])
        _resblock(sd, f"{b}1.", core[f"blocks_{i}_res2"])
        sd[f"{b}2.fn.norm.g"] = _gain(core[f"blocks_{i}_attn_norm"]["g"])
        attn = core[f"blocks_{i}_attn"]
        _conv1x1(sd, f"{b}2.fn.fn.to_qkv", attn["to_qkv"])
        _conv1x1(sd, f"{b}2.fn.fn.to_out.0", attn["to_out"])
        sd[f"{b}2.fn.fn.to_out.1.g"] = _gain(attn["out_norm"]["g"])
        _conv1d(sd, f"{b}3", core[f"blocks_{i}_proj"])
        i += 1
    _resblock(sd, f"{pfx}final_res_block.", core["final_res_block"])
    _conv1d(sd, f"{pfx}final_conv", core["final_conv"])
    if "input_emb" in params:
        _linear(sd, f"{pfx}input_emb_layers.0", params["input_emb"])
    if "time_mlp_1" in params:
        _linear(sd, f"{pfx}time_mlp.1", params["time_mlp_1"])
        _linear(sd, f"{pfx}time_mlp.3", params["time_mlp_2"])
        # random Fourier weights are constants, learned sinusoidal ones params
        pos = constants.get("sinu_pos_emb") or params.get("sinu_pos_emb")
        if pos is not None:
            sd[f"{pfx}time_mlp.0.weights"] = _t(pos["weights"])


def _shared_mlp(sd: StateDict, pfx: str, p: Mapping, stats: Mapping) -> None:
    j = 0
    while f"dense_{j}" in p:
        _conv1x1(sd, f"{pfx}layers.{3 * j}", p[f"dense_{j}"])
        bn = f"{pfx}layers.{3 * j + 1}"
        _norm(sd, bn, p[f"bn_{j}"])
        sd[f"{bn}.running_mean"] = _t(stats[f"bn_{j}"]["mean"])
        sd[f"{bn}.running_var"] = _t(stats[f"bn_{j}"]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        j += 1


def _conv3d(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"], (4, 3, 0, 1, 2)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _pvconv(sd: StateDict, pfx: str, p: Mapping, s: Mapping) -> None:
    # voxel_layers: 0 Conv3d, 1 GN, 2 SiLU, 3 Dropout, 4 Conv3d, 5 GN,
    # 6 SiLU or VoxelAttention (to_qkv, to_out), 7 SE (fc.0, fc.2)
    _conv3d(sd, f"{pfx}voxel_layers.0", p["voxel_conv1"])
    _norm(sd, f"{pfx}voxel_layers.1", p["voxel_norm1"])
    _conv3d(sd, f"{pfx}voxel_layers.4", p["voxel_conv2"])
    _norm(sd, f"{pfx}voxel_layers.5", p["voxel_norm2"])
    if "voxel_attn" in p:
        _attention1d(sd, f"{pfx}voxel_layers.6.", p["voxel_attn"])
    _linear(sd, f"{pfx}voxel_layers.7.fc.0", p["se"]["fc1"])
    _linear(sd, f"{pfx}voxel_layers.7.fc.2", p["se"]["fc2"])
    _shared_mlp(sd, f"{pfx}point_features.", p["point_features"], s["point_features"])


def _attention1d(sd: StateDict, pfx: str, p: Mapping) -> None:
    """flax ``Attention1D`` -> :class:`..models.layers.Attention1D` keys."""
    _conv1x1(sd, f"{pfx}to_qkv", p["to_qkv"])
    _conv1x1(sd, f"{pfx}to_out", p["to_out"])


def _pvcnn_encoder(sd: StateDict, pfx: str, params: Mapping, stats: Mapping) -> None:
    pv, pv_stats = params["pvcnn"], stats["pvcnn"]
    i = 0
    while f"stage_{i}" in pv:
        p, s = pv[f"stage_{i}"], pv_stats[f"stage_{i}"]
        stage = f"{pfx}pvcnn_modules.point_features.{i}."
        if "voxel_conv1" in p:
            _pvconv(sd, stage, p, s)
        else:
            _shared_mlp(sd, stage, p, s)
        i += 1
    _conv1x1(sd, f"{pfx}conv_downscale", params["conv_downscale"])
    if "global_attention" in params:
        ga = params["global_attention"]
        for name in ("q", "k", "v", "out"):
            _conv1x1(sd, f"{pfx}global_attention.{name}", ga[name])
        _norm(sd, f"{pfx}global_attention.norm", ga["norm"])
    _conv1x1(sd, f"{pfx}out_layer.0", params["out_conv"])
    _linear(sd, f"{pfx}out_layer.1", params["out_proj"])


def pvcnn_encoder_state_dict(variables: Mapping) -> StateDict:
    """PVCNNEncoder variables (``params``, ``batch_stats``) ->
    :class:`..models.pvcnn.PVCNNEncoder` state dict."""
    sd: StateDict = {}
    _pvcnn_encoder(sd, "", variables["params"], variables["batch_stats"])
    return sd


def pvconv_state_dict(variables: Mapping) -> StateDict:
    """PVConv variables -> :class:`..models.pvcnn.PVConv` state dict."""
    sd: StateDict = {}
    _pvconv(sd, "", variables["params"], variables["batch_stats"])
    return sd


def grasp_ldm_state_dict(variables: Mapping) -> StateDict:
    """GraspLatentDDM variables -> :class:`..models.GraspLatentDDM` state dict."""
    sd: StateDict = {}
    consts = variables.get("constants", {}).get("denoiser", {})
    _resnet1d(sd, "", variables["params"]["denoiser"], consts)
    return sd


def class_conditioned_ldm_state_dict(variables: Mapping) -> StateDict:
    """ClassConditionedGraspLatentDDM variables -> the port module's state
    dict: the shared core as :func:`grasp_ldm_state_dict`, plus ``cls_embed``."""
    sd = grasp_ldm_state_dict(variables)
    _linear(sd, "cls_embed", variables["params"]["denoiser"]["cls_embed"])
    return sd


def region_conditioned_ldm_state_dict(variables: Mapping) -> StateDict:
    """RegionConditionedGraspLatentDDM variables -> the port module's state
    dict: the shared core, plus ``region_mlp_1`` / ``region_mlp_2``."""
    sd = grasp_ldm_state_dict(variables)
    for name in ("region_mlp_1", "region_mlp_2"):
        _linear(sd, name, variables["params"]["denoiser"][name])
    return sd


def grasp_cvae_state_dict(variables: Mapping) -> StateDict:
    """GraspCVAE variables -> :class:`..models.GraspCVAE` state dict."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _pvcnn_encoder(sd, "encoder.pc_encoder.", p["pc_encoder"], stats["pc_encoder"])
    ge = p["grasp_encoder"]
    _linear(sd, "encoder.grasp_encoder.in_layer", ge["in_layer"])
    _resnet1d(sd, "encoder.grasp_encoder.net.", ge["net"], {})
    _linear(sd, "encoder.grasp_encoder.out_layer", ge["out_layer"])
    _linear(sd, "bottleneck.mu", p["bottleneck"]["mu"])
    _linear(sd, "bottleneck.logvar", p["bottleneck"]["logvar"])
    dc = p["decoder_core"]
    _linear(sd, "decoder.in_layer", dc["in_layer"])
    _resnet1d(sd, "decoder.net.", dc["net"], {})
    _linear(sd, "decoder.tmrp", p["head_tmrp"])
    _linear(sd, "decoder.class_logits", p["head_class"])
    if "head_qualities" in p:
        _linear(sd, "decoder.qualities", p["head_qualities"])
    return sd


def _count(p: Mapping, fmt: str) -> int:
    n = 0
    while fmt.format(n) in p:
        n += 1
    return n


def _pvcnn2(sd: StateDict, pfx: str, p: Mapping, s: Mapping) -> None:
    """flax PVCNN2 (``sa{i}_conv{b}``, ``sa{i}_module``, ``fp{i}_module``,
    ``fp{i}_conv{b}``) -> ``sa_layers.{i}.{b}`` / ``fp_layers.{i}.{b}``."""
    for i in range(_count(p, "sa{}_module")):
        n = _count(p, f"sa{i}_conv{{}}")
        for b in range(n):
            _pvconv(sd, f"{pfx}sa_layers.{i}.{b}.", p[f"sa{i}_conv{b}"], s[f"sa{i}_conv{b}"])
        _shared_mlp(sd, f"{pfx}sa_layers.{i}.{n}.mlps.0.", p[f"sa{i}_module"]["mlp"],
                    s[f"sa{i}_module"]["mlp"])
    for i in range(_count(p, "fp{}_module")):
        _shared_mlp(sd, f"{pfx}fp_layers.{i}.0.mlp.", p[f"fp{i}_module"]["mlp"],
                    s[f"fp{i}_module"]["mlp"])
        for b in range(_count(p, f"fp{i}_conv{{}}")):
            _pvconv(sd, f"{pfx}fp_layers.{i}.{b + 1}.", p[f"fp{i}_conv{b}"],
                    s[f"fp{i}_conv{b}"])


def pvcnn2_state_dict(variables: Mapping) -> StateDict:
    """PVCNN2 variables (``params``, ``batch_stats``) -> :class:`..models.PVCNN2`
    state dict."""
    sd: StateDict = {}
    _pvcnn2(sd, "", variables["params"], variables["batch_stats"])
    return sd


def pvcnn2_encoder_state_dict(variables: Mapping) -> StateDict:
    """PVCNN2Encoder variables -> :class:`..models.PVCNN2Encoder` state dict."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _pvcnn2(sd, "pvcnn_modules.", p["pvcnn2"], stats["pvcnn2"])
    _conv1x1(sd, "conv_downscale", p["conv_downscale"])
    _conv1x1(sd, "out_layer.0", p["out_conv"])
    _linear(sd, "out_layer.1", p["out_proj"])
    return sd


def pointnet2_state_dict(variables: Mapping) -> StateDict:
    """PointNet2 (SSG / MSG) variables -> :class:`..models.PointNet2` state
    dict: ``sa{i}_module`` / ``sa{i}_msg`` / ``sa{i}_global`` ->
    ``sa_layers.{i}.mlps.{j}``, ``fp{i}_module`` -> ``fp_layers.{i}.mlp``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    i = 0
    while True:
        if f"sa{i}_module" in p:
            _shared_mlp(sd, f"sa_layers.{i}.mlps.0.", p[f"sa{i}_module"]["mlp"],
                        s[f"sa{i}_module"]["mlp"])
        elif f"sa{i}_msg" in p or f"sa{i}_global" in p:
            name = f"sa{i}_msg" if f"sa{i}_msg" in p else f"sa{i}_global"
            for j in range(_count(p[name], "mlp_{}")):
                _shared_mlp(sd, f"sa_layers.{i}.mlps.{j}.", p[name][f"mlp_{j}"],
                            s[name][f"mlp_{j}"])
        else:
            break
        i += 1
    for i in range(_count(p, "fp{}_module")):
        _shared_mlp(sd, f"fp_layers.{i}.mlp.", p[f"fp{i}_module"]["mlp"], s[f"fp{i}_module"]["mlp"])
    return sd
