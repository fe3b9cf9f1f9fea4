"""Weight bridge: JAX package variables (numpy) -> the port's ``state_dict``.

Takes the variable trees of :mod:`graspldm_tpu` models as nested dicts of
numpy arrays (``params``, ``batch_stats``, ``constants``), exactly as
``jax.tree.map(np.asarray, variables)`` gives them, and returns the port's
``state_dict`` for :class:`..models.GraspCVAE` / :class:`..models.GraspLatentDDM`.
It is the inverse of :mod:`graspldm_tpu.utils.torch_convert`, so a round
trip through that converter checks both directions.

Layout changes: Dense ``[in, out]`` -> Linear ``[out, in]``; Conv ``WIO`` ->
``OIW``; Conv3d ``DHWIO`` -> ``OIDHW``; channel gains ``[C]`` -> ``[1, C, 1]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["grasp_ldm_state_dict", "grasp_cvae_state_dict"]

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
        sd[f"{pfx}time_mlp.0.weights"] = _t(constants["sinu_pos_emb"]["weights"])


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


def _pvcnn_encoder(sd: StateDict, pfx: str, params: Mapping, stats: Mapping) -> None:
    pv, pv_stats = params["pvcnn"], stats["pvcnn"]
    i = 0
    while f"stage_{i}" in pv:
        p, s = pv[f"stage_{i}"], pv_stats[f"stage_{i}"]
        stage = f"{pfx}pvcnn_modules.point_features.{i}."
        if "voxel_conv1" in p:
            # voxel_layers: 0 Conv3d, 1 GN, 2 SiLU, 3 Dropout, 4 Conv3d,
            # 5 GN, 6 SiLU, 7 SE (fc.0, fc.2)
            _conv3d(sd, f"{stage}voxel_layers.0", p["voxel_conv1"])
            _norm(sd, f"{stage}voxel_layers.1", p["voxel_norm1"])
            _conv3d(sd, f"{stage}voxel_layers.4", p["voxel_conv2"])
            _norm(sd, f"{stage}voxel_layers.5", p["voxel_norm2"])
            _linear(sd, f"{stage}voxel_layers.7.fc.0", p["se"]["fc1"])
            _linear(sd, f"{stage}voxel_layers.7.fc.2", p["se"]["fc2"])
            _shared_mlp(sd, f"{stage}point_features.", p["point_features"],
                        s["point_features"])
        else:
            _shared_mlp(sd, stage, p, s)
        i += 1
    _conv1x1(sd, f"{pfx}conv_downscale", params["conv_downscale"])
    _conv1x1(sd, f"{pfx}out_layer.0", params["out_conv"])
    _linear(sd, f"{pfx}out_layer.1", params["out_proj"])


def grasp_ldm_state_dict(variables: Mapping) -> StateDict:
    """GraspLatentDDM variables -> :class:`..models.GraspLatentDDM` state dict."""
    sd: StateDict = {}
    consts = variables.get("constants", {}).get("denoiser", {})
    _resnet1d(sd, "", variables["params"]["denoiser"], consts)
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
