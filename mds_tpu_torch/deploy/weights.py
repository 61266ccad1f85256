"""Weights for the port: JAX variables → state_dict, and reference files.

The port's module names are the reference torch layout. The key tables and
the mappings below are this package's own numpy-only copy of
mds_tpu/deploy/torch_import.py: for BiSeNetV2 `_CONVBN_BLOCKS`,
`_PLAIN_CONVS`, `_head_blocks` (:39-85) and `bisenetv2_to_torch`
(:654-710), where only the per-dataset affine of `bisenetv2_origin` is split
further, into one BatchNorm2d(affine=True) per dataset; for BiSeNetV1 the
inverse of `resnet18_torchvision_to_resnet` (:499-528) and
`bisenetv1_from_torch` (:766-820). BatchNorm2d's `num_batches_tracked` may
be absent: a state_dict without torch's version metadata loads strictly
without it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_AUX_HEADS = ("aux2.", "aux3.", "aux4.", "aux5_4.", "conv_out16.", "conv_out32.")

# JAX module path → torch module path of each ConvBNReLU / ConvBN
_CONVBN_BLOCKS = {
    "detail/S1_1": "detail.S1_1", "detail/S1_2": "detail.S1_2",
    "detail/S2_1": "detail.S2_1", "detail/S2_2": "detail.S2_2",
    "detail/S2_3": "detail.S2_3", "detail/S3_1": "detail.S3_1",
    "detail/S3_2": "detail.S3_2", "detail/S3_3": "detail.S3_3",
    "segment/S1S2/conv": "segment.S1S2.conv",
    "segment/S1S2/left_1": "segment.S1S2.left_1",
    "segment/S1S2/left_2": "segment.S1S2.left_2",
    "segment/S1S2/fuse": "segment.S1S2.fuse",
    "segment/S5_5/conv_gap": "segment.S5_5.conv_gap",
    "segment/S5_5/conv_last": "segment.S5_5.conv_last",
    "bga/left1_convbn": "bga.left1_convbn",
    "bga/left2_convbn": "bga.left2_convbn",
    "bga/right1": "bga.right1",
    "bga/right2_convbn": "bga.right2_convbn",
    "bga/conv": "bga.conv",
}
for _stage, _n in (("S3", 2), ("S4", 2), ("S5_4", 4)):
    for _i in range(1, _n + 1):
        _tag = f"{_stage}_{_i}"
        _parts = ["conv1", "conv2"] + (
            ["dwconv1", "dwconv2", "shortcut_1", "shortcut_2"] if _i == 1
            else ["dwconv"])
        for _p in _parts:
            _CONVBN_BLOCKS[f"segment/{_tag}/{_p}"] = f"segment.{_tag}.{_p}"

_PLAIN_CONVS = {
    "bga/left1_conv": "bga.left1_conv",
    "bga/right2_conv": "bga.right2_conv",
}


def _head_blocks(n_heads: int, aux: bool) -> Dict:
    """Per-dataset SegmentHead paths: (JAX path, kind) → torch path, kind
    "convbn1" for a single-BN ConvBNReLU, "conv_b" for a conv with bias."""
    out = {}
    for hname in ["head"] + (["aux2", "aux3", "aux4", "aux5_4"] if aux else []):
        for i in range(n_heads):
            ours, theirs = f"{hname}_{i}", f"{hname}.{i}"
            out[f"{ours}/conv", "convbn1"] = f"{theirs}.conv"
            if hname != "head":
                out[f"{ours}/conv1", "convbn1"] = f"{theirs}.conv1"
            out[f"{ours}/conv_out", "conv_b"] = f"{theirs}.conv2"
    return out


def _get(tree: Mapping, path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def _oihw(k: np.ndarray) -> np.ndarray:
    return np.asarray(k).transpose(3, 2, 0, 1)  # HWIO → OIHW


def bisenetv2_to_torch(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """JAX BiSeNetV2 (params, batch_stats) trees → reference-layout arrays."""
    out: Dict[str, np.ndarray] = {}

    def dump_convbn(ours, theirs):
        out[f"{theirs}.conv.weight"] = _oihw(_get(params, f"{ours}/conv/kernel"))
        out[f"{theirs}.affine_weight"] = _get(params, f"{ours}/bn/scale")
        out[f"{theirs}.affine_bias"] = _get(params, f"{ours}/bn/bias")
        mean, var = _get(stats, f"{ours}/bn/mean"), _get(stats, f"{ours}/bn/var")
        for i in range(mean.shape[0]):
            out[f"{theirs}.bn.{i}.running_mean"] = mean[i]
            out[f"{theirs}.bn.{i}.running_var"] = var[i]

    for ours, theirs in _CONVBN_BLOCKS.items():
        dump_convbn(ours, theirs)
    for ours, theirs in _PLAIN_CONVS.items():
        out[f"{theirs}.weight"] = _oihw(_get(params, f"{ours}/kernel"))

    mean, var = _get(stats, "segment/S5_5/bn/mean"), _get(stats, "segment/S5_5/bn/var")
    scale, bias = _get(params, "segment/S5_5/bn/scale"), _get(params, "segment/S5_5/bn/bias")
    for i in range(mean.shape[0]):
        out[f"segment.S5_5.bn.{i}.running_mean"] = mean[i]
        out[f"segment.S5_5.bn.{i}.running_var"] = var[i]
        out[f"segment.S5_5.bn.{i}.weight"] = scale[i]
        out[f"segment.S5_5.bn.{i}.bias"] = bias[i]

    n_heads = sum(1 for k in params if k.startswith("head_"))
    for (ours, kind), theirs in _head_blocks(n_heads, "aux2_0" in params).items():
        if kind == "conv_b":
            out[f"{theirs}.weight"] = _oihw(_get(params, f"{ours}/kernel"))
            out[f"{theirs}.bias"] = _get(params, f"{ours}/bias")
        else:
            dump_convbn(ours, theirs)
    return out


# BiSeNetV1: JAX module path → torch module path of each single-BN
# ConvBNReLU1 (`<torch>.conv.weight`, `<torch>.bn.*`)
_V1_CONVBN = {
    "cp/conv_avg": "cp.conv_avg", "cp/conv_head32": "cp.conv_head32",
    "cp/conv_head16": "cp.conv_head16", "cp/arm16/conv": "cp.arm16.conv",
    "cp/arm32/conv": "cp.arm32.conv", "sp/conv1": "sp.conv1",
    "sp/conv2": "sp.conv2", "sp/conv3": "sp.conv3", "sp/conv_out": "sp.conv_out",
    "ffm/convblk": "ffm.convblk", "conv_out/conv": "conv_out.conv",
}
# plain BNs (JAX path → torch BatchNorm2d) and the convs in front of them
_V1_RAW_BN = {"cp/arm16/bn_atten": "cp.arm16.bn_atten",
              "cp/arm32/bn_atten": "cp.arm32.bn_atten", "ffm/bn": "ffm.bn"}
_V1_PLAIN_CONVS = {"cp/arm16/conv_atten": "cp.arm16.conv_atten",
                   "cp/arm32/conv_atten": "cp.arm32.conv_atten",
                   "ffm/conv": "ffm.conv"}


def _dump_bn(out: Dict, params: Mapping, stats: Mapping, ours: str, theirs: str):
    """A flax nn.BatchNorm's four variables → BatchNorm2d keys."""
    out[f"{theirs}.weight"] = _get(params, f"{ours}/scale")
    out[f"{theirs}.bias"] = _get(params, f"{ours}/bias")
    out[f"{theirs}.running_mean"] = _get(stats, f"{ours}/mean")
    out[f"{theirs}.running_var"] = _get(stats, f"{ours}/var")


def resnet18_to_torch(params: Mapping, stats: Mapping,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX Resnet18 (params, batch_stats) subtrees → torchvision keys under
    `prefix` (mds_tpu/models/resnet.py names `layer{i}_{b}`,
    `downsample_conv`, `downsample_bn`)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}conv1.weight"] = _oihw(_get(params, "conv1/kernel"))
    _dump_bn(out, params, stats, "bn1", f"{prefix}bn1")
    for li in range(1, 5):
        for b in range(2):
            o, t = f"layer{li}_{b}", f"{prefix}layer{li}.{b}"
            for i in (1, 2):
                out[f"{t}.conv{i}.weight"] = _oihw(_get(params, f"{o}/conv{i}/kernel"))
                _dump_bn(out, params, stats, f"{o}/bn{i}", f"{t}.bn{i}")
            if "downsample_conv" in params[o]:
                out[f"{t}.downsample.0.weight"] = _oihw(
                    _get(params, f"{o}/downsample_conv/kernel"))
                _dump_bn(out, params, stats, f"{o}/downsample_bn", f"{t}.downsample.1")
    return out


def bisenetv1_to_torch(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """JAX BiSeNetV1 (params, batch_stats) trees → reference-layout arrays;
    the aux heads when the tree has them."""
    out = resnet18_to_torch(params["cp"]["resnet"], stats["cp"]["resnet"], "cp.resnet.")
    heads = ["conv_out"] + (["conv_out16", "conv_out32"] if "conv_out16" in params else [])
    blocks = dict(_V1_CONVBN, **{f"{h}/conv": f"{h}.conv" for h in heads[1:]})
    for ours, theirs in blocks.items():
        out[f"{theirs}.conv.weight"] = _oihw(_get(params, f"{ours}/conv/kernel"))
        _dump_bn(out, params, stats, f"{ours}/bn", f"{theirs}.bn")
    for ours, theirs in _V1_RAW_BN.items():
        _dump_bn(out, params, stats, ours, theirs)
    for ours, theirs in _V1_PLAIN_CONVS.items():
        out[f"{theirs}.weight"] = _oihw(_get(params, f"{ours}/kernel"))
    for h in heads:
        out[f"{h}.conv_out.weight"] = _oihw(_get(params, f"{h}/conv_out/kernel"))
        out[f"{h}.conv_out.bias"] = _get(params, f"{h}/conv_out/bias")
    return out


def bisenetv1_state_dict_from_jax(params: Mapping,
                                  batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BiSeNetV1 variables (numpy arrays, nested dicts) → the port's
    state_dict, for load_state_dict(strict=True)."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in bisenetv1_to_torch(params, batch_stats).items()}


def bisenetv2_state_dict_from_jax(params: Mapping,
                                  batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BiSeNetV2 variables (numpy arrays, nested dicts) → the port's
    state_dict, for load_state_dict(strict=True)."""
    out: Dict[str, np.ndarray] = {}
    for key, v in bisenetv2_to_torch(params, batch_stats).items():
        block, _, leaf = key.rpartition(".")
        if leaf in ("affine_weight", "affine_bias") and v.ndim == 2:
            # per-dataset affine: one BatchNorm2d(affine=True) per dataset
            for i, row in enumerate(v):
                out[f"{block}.bn.{i}.{leaf[len('affine_'):]}"] = row
        else:
            out[key] = v
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_reference_weights(model: nn.Module, state: Mapping) -> nn.Module:
    """Load a reference-layout mapping (numpy arrays or tensors) strictly.
    Aux-head entries (BiSeNetV2's aux2-aux5_4, BiSeNetV1's conv_out16 and
    conv_out32) are dropped when the model has no aux heads (`aux` False)."""
    has_aux = getattr(model, "aux", True)
    sd = {k: torch.as_tensor(np.array(v)) for k, v in state.items()
          if has_aux or not k.startswith(_AUX_HEADS)}
    model.load_state_dict(sd, strict=True)
    return model
