"""The port's HRNet weight loaders (mds_tpu_torch/deploy/weights.py
`load_reference_weights` with `hrnet_backbone_from_torch` and the
multi-dataset layout) against JAX's importers (mds_tpu/deploy/
torch_import.py `hrnet_backbone_from_torch` :408, `hrnet_ref_from_torch`
:531), on the CPU at f32, at tests/test_hrnet.py's TINY_STAGES with 2
datasets.

For each layout the test builds a state dict of random arrays under every
key JAX's importer reads (and keys it does not: the ImageNet classifier
heads, a third stat set, num_batches_tracked); it goes through JAX's
importer and JAX's HRNetBackbone, and through the port's loader into the
port's HRNetW48 (the backbone grafted, the rest left as it was). The
branches must agree (rel ≤ 1e-4), and the port's backbone must hold
exactly the arrays JAX's importer put in its tree. `Trainer.finetune_from`
names the reason for each of the three layouts the trainer does not take.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hrnet import TINY_STAGES
from torch_flagship_parity import nchw, nhwc, one_torch_thread, rel  # noqa: F401
from mds_tpu_torch.deploy.weights import (
    detect_torch_layout,
    hrnet_backbone_to_torch,
    load_reference_weights,
)
from mds_tpu_torch.models.hrnet import HRNetW48
from mds_tpu_torch.models.layers import ConvBNReLU

F32 = 1e-4
N_BN = 2


def _imagenet_names(name: str):
    """The port's block name → its (conv weight, BN) keys in the ImageNet
    classification layout."""
    if name in ("conv1", "conv2"):
        return f"{name}.weight", f"bn{name[-1]}"
    m = re.match(r"^(.*)\.(conv\d)$", name)
    if m and (name.startswith("layer1.") or ".branches." in name):
        return f"{name}.weight", f"{m.group(1)}.bn{m.group(2)[-1]}"
    if name.endswith(".downsample"):
        return f"{name}.0.weight", f"{name}.1"
    return f"{name}.0.weight", f"{name}.1"  # transitions and fuse layers


def _bn(rng, out, key, c):
    out[f"{key}.weight"] = rng.normal(1, 0.1, c).astype(np.float32)
    out[f"{key}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    out[f"{key}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
    out[f"{key}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    out[f"{key}.num_batches_tracked"] = np.array(7)


def imagenet_state(rng):
    """Every key JAX's `hrnet_backbone_from_torch` reads, for TINY_STAGES,
    with the classifier heads it drops."""
    model = HRNetW48((3, 4), 16, n_bn=N_BN, stages=TINY_STAGES)
    out = {}
    for name, m in model.backbone.named_modules():
        if isinstance(m, ConvBNReLU):
            conv, bn = _imagenet_names(name)
            w = m.conv.weight
            out[conv] = rng.normal(0, 0.3, tuple(w.shape)).astype(np.float32)
            _bn(rng, out, bn, w.shape[0])
    out["incre_modules.0.0.conv1.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    out["classifier.weight"] = np.zeros((10, 2048), np.float32)
    return out


def ref_state(rng):
    """The reference multi-dataset layout: the port's own backbone keys,
    with a third stat set and a projection head JAX does not read."""
    model = HRNetW48((3, 4), 16, n_bn=N_BN, stages=TINY_STAGES)
    out = {}
    for k, t in model.backbone.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, tuple(t.shape)).astype(np.float32)
        elif k.endswith("affine_weight"):
            out[k] = rng.normal(1, 0.1, tuple(t.shape)).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.3 if k.endswith("conv.weight") else 0.1,
                                tuple(t.shape)).astype(np.float32)
        if k.endswith(".bn.1.running_mean"):
            out[k.replace(".bn.1.", ".bn.2.")] = np.zeros(t.shape, np.float32)
    out["cls_head.weight"] = np.zeros((19, 720, 1, 1), np.float32)
    return out


@pytest.mark.parametrize("layout", ["hrnet_imagenet", "hrnet_ref"])
def test_loader_matches_jax_importer(layout):
    from mds_tpu.deploy import torch_import as ti
    from mds_tpu.models.hrnet import HRNetBackbone as JB

    rng = np.random.default_rng(0)
    sd = imagenet_state(rng) if layout == "hrnet_imagenet" else ref_state(rng)
    assert detect_torch_layout(sd) == layout
    importer = ti.hrnet_backbone_from_torch if layout == "hrnet_imagenet" else ti.hrnet_ref_from_torch
    params, stats = importer(sd, n_bn=N_BN)

    model = HRNetW48((3, 4), 16, n_bn=N_BN, stages=TINY_STAGES)
    model.init_weights(torch.Generator().manual_seed(0))
    rest = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("backbone.")}
    # the state_dict handed in as tensors, as torch.load gives it
    load_reference_weights(model, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    # the port's backbone holds exactly JAX's tree
    want = hrnet_backbone_to_torch(params, stats, "backbone.")
    got = {k: v for k, v in model.state_dict().items()
           if k.startswith("backbone.") and not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert all(torch.equal(model.state_dict()[k], v) for k, v in rest.items())

    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jb = JB(stages=TINY_STAGES, n_bn=N_BN)
    jxs = [jnp.asarray(x), jnp.asarray(x[:1])]
    branches = jax.jit(lambda v, xs: jb.apply(v, xs, train=False))(
        {"params": params, "batch_stats": stats}, jxs)
    with torch.no_grad():
        ours = model.eval().backbone([nchw(x), nchw(x[:1])])
    for g, w in zip(ours, branches):
        for ds in range(N_BN):
            assert rel(nhwc(g[ds]), np.asarray(w[ds])) <= F32


def test_loader_refuses_what_does_not_fit():
    from mds_tpu_torch.models.bisenetv2 import BiSeNetV2

    rng = np.random.default_rng(0)
    sd = ref_state(rng)
    del sd["conv1.affine_weight"]
    with pytest.raises(KeyError, match="conv1.affine_weight"):
        load_reference_weights(HRNetW48((3, 4), 16, n_bn=N_BN, stages=TINY_STAGES), sd)
    with pytest.raises(ValueError, match="does not fit"):
        load_reference_weights(BiSeNetV2(n_classes=(3,)), imagenet_state(rng))


@pytest.mark.parametrize("layout,sd,reason", [
    ("hrnet_imagenet", {"transition1.0.0.weight": torch.zeros(1)}, "HRNet trains in neither"),
    ("hrnet_ref", {"conv1.conv.weight": torch.zeros(1),
                   "stage2.0.branches.0.0.conv1.conv.weight": torch.zeros(1)},
     "HRNet trains in neither"),
    ("swin", {"patch_embed.proj.weight": torch.zeros(1),
              "layers.0.blocks.0.norm1.weight": torch.zeros(1)},
     "bisenetv1_swin trains in neither"),
])
def test_finetune_from_names_the_reason(tmp_path, layout, sd, reason):
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.trainer import Trainer

    assert detect_torch_layout(sd) == layout
    t = Trainer(Configer(config_file="configs/test_synthetic.json"),
                work_dir=str(tmp_path), device="cpu")
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(NotImplementedError, match=reason):
        t.finetune_from(str(tmp_path / "w.pth"))
    for name in ("hrnet_w48", "bisenetv1_swin"):
        cfg = Configer(config_file="configs/test_synthetic.json", args_parser=["model_name", name])
        with pytest.raises(NotImplementedError, match="trains in neither package"):
            Trainer(cfg, work_dir=str(tmp_path), device="cpu")
