"""Weights for the port: JAX variables → state_dict, and reference files.

The port's module names are the reference torch layout. The key tables and
the mappings below are this package's own numpy-only copy of
mds_tpu/deploy/torch_import.py: for BiSeNetV2 `_CONVBN_BLOCKS`,
`_PLAIN_CONVS`, `_head_blocks` (:39-85) and `bisenetv2_to_torch`
(:654-710), where only the per-dataset affine of `bisenetv2_origin` is split
further, into one BatchNorm2d(affine=True) per dataset; for BiSeNetV1 the
inverse of `resnet18_torchvision_to_resnet` (:499-528) and
`bisenetv1_from_torch` (:766-820); for snp_rn18 the inverse of
`swiftnet_backbone_from_torch` (:283) and `semseg_from_torch` (:343), and
the graph nets' parameters in JAX's own names; for BiSeNetV2Contrast the
inverse of `bisenetv2_contrast_from_torch` (:184), and that importer
itself (`load_contrast_reference`). BatchNorm2d's `num_batches_tracked` may
be absent: a state_dict without torch's version metadata loads strictly
without it.
"""

from __future__ import annotations

import re
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


def _dump_convbn(out: Dict, params: Mapping, stats: Mapping, ours: str, theirs: str):
    """A JAX ConvBNReLU (shared affine, stacked per-dataset stats) →
    reference-layout keys."""
    out[f"{theirs}.conv.weight"] = _oihw(_get(params, f"{ours}/conv/kernel"))
    out[f"{theirs}.affine_weight"] = _get(params, f"{ours}/bn/scale")
    out[f"{theirs}.affine_bias"] = _get(params, f"{ours}/bn/bias")
    mean, var = _get(stats, f"{ours}/bn/mean"), _get(stats, f"{ours}/bn/var")
    for i in range(mean.shape[0]):
        out[f"{theirs}.bn.{i}.running_mean"] = mean[i]
        out[f"{theirs}.bn.{i}.running_var"] = var[i]


def _trunk_to_torch(params: Mapping, stats: Mapping, out: Dict) -> None:
    """BiSeNetV2's DetailBranch, SegmentBranch and BGALayer."""
    for ours, theirs in _CONVBN_BLOCKS.items():
        _dump_convbn(out, params, stats, ours, theirs)
    for ours, theirs in _PLAIN_CONVS.items():
        out[f"{theirs}.weight"] = _oihw(_get(params, f"{ours}/kernel"))
    mean, var = _get(stats, "segment/S5_5/bn/mean"), _get(stats, "segment/S5_5/bn/var")
    scale, bias = _get(params, "segment/S5_5/bn/scale"), _get(params, "segment/S5_5/bn/bias")
    for i in range(mean.shape[0]):
        out[f"segment.S5_5.bn.{i}.running_mean"] = mean[i]
        out[f"segment.S5_5.bn.{i}.running_var"] = var[i]
        out[f"segment.S5_5.bn.{i}.weight"] = scale[i]
        out[f"segment.S5_5.bn.{i}.bias"] = bias[i]


def bisenetv2_to_torch(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """JAX BiSeNetV2 (params, batch_stats) trees → reference-layout arrays."""
    out: Dict[str, np.ndarray] = {}
    _trunk_to_torch(params, stats, out)
    n_heads = sum(1 for k in params if k.startswith("head_"))
    for (ours, kind), theirs in _head_blocks(n_heads, "aux2_0" in params).items():
        if kind == "conv_b":
            out[f"{theirs}.weight"] = _oihw(_get(params, f"{ours}/kernel"))
            out[f"{theirs}.bias"] = _get(params, f"{ours}/bias")
        else:
            _dump_convbn(out, params, stats, ours, theirs)
    return out


def bisenetv2_contrast_to_torch(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """JAX BiSeNetV2Contrast (params, batch_stats) trees → reference-layout
    arrays (the inverse of mds_tpu/deploy/torch_import.py
    `bisenetv2_contrast_from_torch` :184): the trunk, the unified head
    `head.conv` + `head.proj.conv` (ConvNorm's bias-free 1×1), the aux heads
    with their `conv1`, `projHead.conv1` + `projHead.conv_last` and the
    per-dataset aux heads `dataset_aux_head.{i}` where the tree has them."""
    out: Dict[str, np.ndarray] = {}
    _trunk_to_torch(params, stats, out)
    heads = {h: h for h in ("head", "aux2", "aux3", "aux4", "aux5_4") if h in params}
    i = 0
    while f"dataset_aux_head_{i}" in params:
        heads[f"dataset_aux_head_{i}"] = f"dataset_aux_head.{i}"
        i += 1
    for ours, theirs in heads.items():
        for block in ("conv", "conv1"):
            if block in params[ours]:
                _dump_convbn(out, params, stats, f"{ours}/{block}", f"{theirs}.{block}")
        out[f"{theirs}.proj.conv.weight"] = _oihw(_get(params, f"{ours}/conv_out/kernel"))
    _dump_convbn(out, params, stats, "proj_head/conv1", "projHead.conv1")
    out["projHead.conv_last.weight"] = _oihw(_get(params, "proj_head/conv_out/kernel"))
    out["projHead.conv_last.bias"] = _get(params, "proj_head/conv_out/bias")
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


def detect_torch_layout(sd: Mapping) -> str:
    """The layout of a torch state_dict — the port's copy of
    mds_tpu/deploy/torch_import.py `detect_torch_layout` (:606): 'semseg',
    'bisenetv2_contrast', 'hrnet_ref', 'hrnet_imagenet', 'bisenetv1',
    'swin', 'resnet18' or 'bisenetv2'."""
    if "backbone.conv1.weight" in sd and "unify_prototype" in sd:
        return "semseg"
    if "projHead.conv_last.weight" in sd:
        return "bisenetv2_contrast"
    if any(k.startswith(("transition1.", "stage2.0.branches")) for k in sd):
        return "hrnet_ref" if "conv1.conv.weight" in sd else "hrnet_imagenet"
    if "cp.resnet.conv1.weight" in sd:
        return "bisenetv1"
    if "patch_embed.proj.weight" in sd and any(k.startswith("layers.0.blocks.") for k in sd):
        return "swin"
    if "fc.weight" in sd or ("conv1.weight" in sd and "layer1.0.conv1.weight" in sd
                             and "detail.S1_1.conv.weight" not in sd):
        return "resnet18"
    return "bisenetv2"


def load_reference_weights(model: nn.Module, state: Mapping) -> nn.Module:
    """Load a reference-layout mapping (numpy arrays or tensors) strictly.
    Aux-head entries (BiSeNetV2's aux2-aux5_4, BiSeNetV1's conv_out16 and
    conv_out32) are dropped when the model has no aux heads (`aux` False)."""
    has_aux = getattr(model, "aux", True)
    sd = {k: torch.as_tensor(np.array(v)) for k, v in state.items()
          if has_aux or not k.startswith(_AUX_HEADS)}
    model.load_state_dict(sd, strict=True)
    return model


def _tensors(arrays: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}


def bisenetv2_contrast_state_dict_from_jax(params: Mapping,
                                           batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BiSeNetV2Contrast variables (numpy arrays, nested dicts) → the
    port's state_dict, for load_state_dict(strict=True)."""
    return _tensors(bisenetv2_contrast_to_torch(params, batch_stats))


def _sgd_train_state(to_state_dict, params: Mapping, batch_stats: Mapping, opt_state,
                     step) -> Dict:
    """A JAX train state of SGD groups (`opt_state` the JAX package's
    `SGDGroupsState`, with `count` and the momentum `trace`) → the port's
    checkpoint state (engine/checkpoints.py `train_state`), through
    `to_state_dict(params, batch_stats)`."""
    model = to_state_dict(params, batch_stats)
    trace = to_state_dict(opt_state.trace, batch_stats)
    momentum = {k: {"momentum_buffer": v} for k, v in trace.items()
                if not k.endswith(("running_mean", "running_var"))}
    return {"model": model,
            "optimizer": {"count": int(np.asarray(opt_state.count)), "state": momentum},
            "step": int(np.asarray(step))}


def train_state_from_jax(params: Mapping, batch_stats: Mapping, opt_state,
                         step: int) -> Dict:
    """A JAX BiSeNetV2 train state (numpy trees; `opt_state` the JAX
    package's `SGDGroupsState`) → the port's checkpoint state: the model's
    state_dict, GroupSGD's momentum buffers by parameter name with the step
    count, and the step. A run of the JAX package resumes in the port from
    it."""
    return _sgd_train_state(bisenetv2_state_dict_from_jax, params, batch_stats,
                            opt_state, step)


def contrast_state_from_jax(params: Mapping, batch_stats: Mapping, opt_state, step,
                            bank, teacher: Mapping = None, prototypes=None):
    """A JAX ContrastTrainer's state (numpy trees; `bank` its MemoryBank,
    `teacher` its {"params", "batch_stats"} or None, `prototypes` its
    (U, P, D) slots with num_prototype > 1, else None) → (state, extras) as
    the port's ContrastTrainer checkpoint holds them (its `load`)."""
    state = _sgd_train_state(bisenetv2_contrast_state_dict_from_jax, params, batch_stats,
                             opt_state, step)
    extras = {"bank_feats": torch.from_numpy(np.array(bank.feats, np.float32)),
              "bank_ptr": torch.from_numpy(np.array(bank.ptr, np.int32)),
              "bank_count": torch.from_numpy(np.array(bank.count, np.int32))}
    if teacher is not None:
        extras["teacher"] = bisenetv2_contrast_state_dict_from_jax(
            teacher["params"], teacher["batch_stats"])
    if prototypes is not None:
        extras["prototypes"] = torch.from_numpy(np.array(prototypes, np.float32))
    return state, extras


_PROJ_WEIGHT = re.compile(r"^(.*\.proj)\.weight$")
# the bias-free ConvNorm's bias (a plain-1×1 projection's) and the dead
# conv1 block the reference builds in an aux=False head
_DROPPED = re.compile(r"^(.*\.proj\.bias|head\.conv1\..*|dataset_aux_head\.\d+\.conv1\..*)$")


def load_contrast_reference(model: nn.Module, state: Mapping) -> Dict[str, np.ndarray]:
    """Load a reference contrast-family state_dict (BiSeNetV2_Contrast,
    _WN, _BN; the port's copy of mds_tpu/deploy/torch_import.py
    `bisenetv2_contrast_from_torch` :184) into a BiSeNetV2Contrast: the
    names are the port's own, a plain `<head>.proj.weight` goes to
    `<head>.proj.conv.weight`, a `proj.bias` and an aux=False head's dead
    `conv1` are dropped, keys the model lacks are ignored. Every model key
    outside the aux heads (and BN's num_batches_tracked) must be there.
    Returns the extras: the (U, P, D) `prototypes` buffer where present."""
    extras: Dict[str, np.ndarray] = {}
    own = model.state_dict()
    sd = {}
    for k, v in state.items():
        if k == "prototypes":
            extras["prototypes"] = np.asarray(v)
            continue
        if _DROPPED.match(k):
            continue
        m = _PROJ_WEIGHT.match(k)
        k = f"{m.group(1)}.conv.weight" if m else k
        if k in own:
            sd[k] = torch.as_tensor(np.array(v))
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")
               and not k.startswith(_AUX_HEADS + ("dataset_aux_head.",))]
    if missing:
        raise KeyError(f"contrast state_dict lacks {missing[:5]} ({len(missing)} keys)")
    model.load_state_dict(sd, strict=False)
    return extras


def _dump_slots(out: Dict, params: Mapping, stats: Mapping, ours: str, theirs: str,
                levels: bool):
    """A SharedListBN's (n_slots, C) variables → BatchNorm2d keys: one per
    slot under `theirs.{slot}` (levels), else slot 0 under `theirs`. Its
    per-dataset mode's (n_slots, n_datasets, C) → one per (slot, dataset)
    under `theirs.{slot}.{dataset}`, else `theirs.{dataset}`."""
    scale, bias = _get(params, f"{ours}/scale"), _get(params, f"{ours}/bias")
    mean, var = _get(stats, f"{ours}/mean"), _get(stats, f"{ours}/var")
    for i in range(scale.shape[0] if levels else 1):
        t = f"{theirs}.{i}" if levels else theirs
        sets = [(t, (i,))] if scale.ndim == 2 else [
            (f"{t}.{d}", (i, d)) for d in range(scale.shape[1])]
        for name, at in sets:
            out[f"{name}.weight"], out[f"{name}.bias"] = scale[at], bias[at]
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = mean[at], var[at]


def swiftnet_to_torch(params: Mapping, stats: Mapping,
                      prefix: str = "backbone.") -> Dict[str, np.ndarray]:
    """JAX SwiftNetPyramid (params, batch_stats) subtrees → reference-layout
    arrays: the inverse of mds_tpu/deploy/torch_import.py
    `swiftnet_backbone_from_torch` (:283)."""
    out: Dict[str, np.ndarray] = {f"{prefix}conv1.weight": _oihw(_get(params, "conv1/kernel"))}
    _dump_slots(out, params, stats, "bn1", f"{prefix}bn1", True)
    for li in range(1, 5):
        b = 0
        while f"layer{li}_{b}" in params:
            o, t = f"layer{li}_{b}", f"{prefix}layer{li}.{b}"
            for i in (1, 2):
                out[f"{t}.conv{i}.weight"] = _oihw(_get(params, f"{o}/conv{i}/kernel"))
                _dump_slots(out, params, stats, f"{o}/bn{i}", f"{t}.bn{i}", True)
            if "downsample_conv" in params[o]:
                out[f"{t}.downsample.0.weight"] = _oihw(
                    _get(params, f"{o}/downsample_conv/kernel"))
                _dump_slots(out, params, stats, f"{o}/downsample_bn",
                            f"{t}.downsample.1", False)
            b += 1
    for j in range(4):
        out[f"{prefix}upsample_bottlenecks.{j}.weight"] = _oihw(_get(params, f"bneck{j}/kernel"))
    i = 0
    while f"blend{i}" in params:
        t = f"{prefix}upsample_blends.{i}.blend_conv"
        out[f"{t}.conv.weight"] = _oihw(_get(params, f"blend{i}/conv/kernel"))
        _dump_slots(out, params, stats, f"blend{i}/bn", f"{t}.norm", False)
        i += 1
    return out


def semseg_to_torch(params: Mapping, stats: Mapping,
                    buffers: Mapping) -> Dict[str, np.ndarray]:
    """JAX SemsegModel (snp_rn18) variables → reference-layout arrays: the
    inverse of mds_tpu/deploy/torch_import.py `semseg_from_torch` (:343)."""
    out = swiftnet_to_torch(params["backbone"], stats["backbone"])
    _dump_slots(out, params, stats, "logits_bn", "logits.norm", False)
    out["logits.conv.weight"] = _oihw(_get(params, "logits_conv/kernel"))
    out["logits.conv.bias"] = _get(params, "logits_conv/bias")
    out["unify_prototype"] = _get(params, "unify_prototype")
    i = 0
    while f"aux_prototype_{i}" in params:
        out[f"aux_prototype.{i}"] = _get(params, f"aux_prototype_{i}")
        i += 1
    for i in range(len(buffers)):
        out[f"bipartite_graphs.{i}"] = _get(buffers, f"bi_graph_{i}")
    return out


def semseg_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               buffers: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SemsegModel variables (numpy arrays, nested dicts) → the port's
    state_dict, for load_state_dict(strict=True)."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in semseg_to_torch(params, batch_stats, buffers).items()}


# JAX graph-net module paths → the port's
_GRAPH_NAMES = ((r"^gcn_layers_(\d+)/", r"gcn_layers.\1/"), (r"^att1_(\d+)/", r"att1.\1/"),
                (r"^netD_(\d+)/Dense_0/", r"netD.\1.hidden/"),
                (r"^netD_(\d+)/Dense_1/", r"netD.\1.out/"))


def bgnn_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX graph-net params → the port's state_dict, for every net of
    mds_tpu/models/gnn.py: LearnableTopologyBGNN in each fork (linear_adj,
    unlabel_node_features, the (T, M) or (T+M)² adjacency, GAT's `weight`
    and `attn`, each `netD_i`'s two Dense layers), SelfAttentionGNN and
    LearnableTopologyGAT. Dense kernels are transposed into nn.Linear
    weights; every other leaf (the GCN/GSAGE/GAT (in, out) weights, node
    features, adjacency) is kept as it is. A leaf that is not an array
    (optax's MaskedNode in a multi_transform's moments) is left out."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}{k}/")
            return
        if not hasattr(node, "shape"):
            return
        key = path
        for pat, rep in _GRAPH_NAMES:
            key = re.sub(pat, rep, key)
        key = key.rstrip("/").replace("/", ".")
        if key.endswith(".kernel"):
            out[key[:-len("kernel")] + "weight"] = np.asarray(node).T
        else:
            out[key] = np.asarray(node)

    walk(params, "")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _adamw_state(mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                 count) -> Dict:
    """Port AdamW state (engine/optim.py `optimizer_state`) from two state
    dicts of moments, the running stats left out."""
    keep = [k for k in mu if not k.endswith(("running_mean", "running_var"))
            and not k.startswith("bipartite_graphs.")]
    return {"count": int(np.asarray(count)),
            "state": {k: {"mu": mu[k], "nu": nu[k]} for k in keep}}


def alternating_state_from_jax(seg_params: Mapping, batch_stats: Mapping,
                               buffers: Mapping, seg_opt_state, gnn_params: Mapping,
                               gnn_opt_state) -> Dict:
    """JAX AlternatingTrainer states (numpy trees; each `opt_state` optax
    adamw's, whose first entry holds count, mu and nu, or in adv mode the
    GNN's multi_transform of two) → the port's: the
    seg model's state_dict, the GNN's, and both AdamW states with their
    step counts, as engine/gnn_trainer.py's `load_states` takes them."""
    sa = seg_opt_state[0]
    seg = semseg_state_dict_from_jax(seg_params, batch_stats, buffers)
    return {"seg": seg, "gnn": bgnn_state_dict_from_jax(gnn_params),
            "seg_optimizer": _adamw_state(
                semseg_state_dict_from_jax(sa.mu, batch_stats, buffers),
                semseg_state_dict_from_jax(sa.nu, batch_stats, buffers), sa.count),
            "gnn_optimizer": gnn_optimizer_state_from_jax(gnn_opt_state)}


def gnn_optimizer_state_from_jax(opt_state) -> Dict:
    """The graph net's AdamW state from optax adamw's, or from the
    multi_transform of the adversarial GNN (JAX's `_make_gnn_tx`: one adamw
    for the discriminators `netD_*`, one for the rest), merged by name."""
    if hasattr(opt_state, "inner_states"):
        adams = [s.inner_state[0] for s in opt_state.inner_states.values()]
    else:
        adams = [opt_state[0]]
    mu, nu = {}, {}
    for a in adams:
        mu.update(bgnn_state_dict_from_jax(a.mu))
        nu.update(bgnn_state_dict_from_jax(a.nu))
    return _adamw_state(mu, nu, adams[0].count)
