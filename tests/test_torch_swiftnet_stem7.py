"""Kernel 6 in SwiftNet: the port's eval route (bf16, set_stem_impl("kernel");
on the CPU the wrapper runs its plain version) against JAX's own route
(mds_tpu/models/swiftnet.py fuse7: the Pallas kernel in interpret mode) on
the tiny flagship config of tests/torch_flagship_parity.py.

The input is 8×2048, the smallest whose deepest pyramid level passes JAX's
W ≥ 512 Mosaic guard, so that JAX takes its kernel too.
- Per level: 3 calls a dataset; each level's input goes to kernel 6 with
  its own level's BN folded in: the level input against JAX's (rel <
  1e-2), the port's kernel on JAX's level input against JAX's kernel call
  there (read out of JAX's jitted forward; rel < 1e-2, bit-equal share >
  0.99, as tests/test_torch_bisenetv1.py holds the kernel), and the routed
  output far (rel > 5e-2) from the conv under any other level's BN (the
  levels' BNs made distinct).
- The model: its routed logits against JAX's routed bf16 logits, rel <
  2e-2, and argmax agreement ≥ 0.99. The bench's 0.995 is not this random
  model's to give at this size: JAX's own routed and plain bf16 paths
  agree on 0.9937-0.9985 of its pixels (seeds 0-2 measured), as the port's
  plain path does with JAX's; chip_smoke.py holds 0.995 on the card at
  full width (PERF.md §6).
- A SEG step (AdamW on every parameter, the BN stats moved in train mode)
  leaves the cached folds stale: the next routed eval forward rebuilds
  every level's fold, and its logits equal those of a model that never
  cached one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    configers, jax_semseg, nchw, nhwc, one_torch_thread, port_semseg, rel, tiny)
from mds_tpu_torch.models.layers import bn_eval, bn_fold, conv2d, set_stem_impl
from mds_tpu_torch.ops import stem as tstem

H, W = 8, 2048


@pytest.fixture
def stem_route():
    set_stem_impl("kernel")
    yield
    set_stem_impl("plain")


def _spy_stem7(monkeypatch):
    """The kernel-6 wrapper's calls (arguments and output)."""
    from mds_tpu_torch.ops import stem

    real, seen = stem.stem7_conv_bn_relu_s2, []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, out))
        return out

    monkeypatch.setattr(stem, "stem7_conv_bn_relu_s2", spy)
    return seen


def test_kernel6_route_per_level_matches_jax(monkeypatch, stem_route):
    from mds_tpu.models import layers as jl
    from mds_tpu.models.semseg import SemsegModel
    from mds_tpu.ops.pallas import stem as jstem

    cfg = tiny()
    _, v = jax_semseg(cfg, seed=0)
    bn1 = v["params"]["backbone"]["bn1"]
    for i, mult in enumerate((1.0, 1.6, 0.6)):  # levels far apart
        bn1["scale"][i] *= mult
    jm = SemsegModel.from_configer(configers(cfg)[0], dtype=jnp.bfloat16)
    vj = jax.tree_util.tree_map(jnp.asarray, v)
    x = np.random.default_rng(4).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    real, calls = jstem.stem7_conv_bn_relu_s2, []

    def recorded(*args, **kw):  # JAX's kernel calls: (input, output)
        out = real(*args, **kw)
        calls.append((args[0], out))
        return out

    def run(v, x):
        want = [jm.apply(v, x, ds, method=jm.eval_logits) for ds in range(2)]
        return want, list(calls)

    monkeypatch.setattr(jstem, "stem7_conv_bn_relu_s2", recorded)
    jl.set_stem_impl("pallas")
    try:
        want, jcalls = jax.jit(run)(vj, jnp.asarray(x))
    finally:
        jl.set_stem_impl("plain")
    assert len(jcalls) == 6  # 3 levels × 2 datasets
    tm = port_semseg(cfg, v, torch.bfloat16).eval()
    seen = _spy_stem7(monkeypatch)
    outs = []
    for ds in range(2):
        seen.clear()
        with torch.no_grad():
            got = nhwc(tm.eval_logits(nchw(x, torch.bfloat16), ds))
        assert len(seen) == 3
        for level, (args, out) in enumerate(seen):
            xin = args[0]
            assert tuple(xin.shape) == (1, 3, H // 2 ** level, W // 2 ** level)
            assert xin.is_contiguous(memory_format=torch.channels_last)
            if ds:  # the same input and folds as dataset 0's
                assert torch.equal(out, outs[level])
                continue
            jin, jout = (np.asarray(a, np.float32) for a in jcalls[level])
            assert rel(nhwc(xin), jin) < 1e-2  # the same level input (bf16)
            outs.append(out)
            mine = nhwc(out)
            # the port's kernel on JAX's input, with this level's fold
            with torch.no_grad():
                on_jin = nhwc(tstem.stem7_conv_bn_relu_s2_plain(
                    nchw(jin, torch.bfloat16), tm.backbone.conv1.weight,
                    *bn_fold(tm.backbone.bn1[level])))
            assert rel(on_jin, jout) < 1e-2, level
            assert (on_jin == jout).mean() > 0.99, level
            for other in {0, 1, 2} - {level}:
                with torch.no_grad():
                    wrong = torch.relu(bn_eval(tm.backbone.bn1[other], conv2d(
                        tm.backbone.conv1, xin, torch.bfloat16), torch.bfloat16))
                assert rel(mine, nhwc(wrong)) > 5e-2, (level, other)
        w = np.asarray(want[ds], np.float32)
        assert got.shape == w.shape
        assert rel(got, w) < 2e-2
        assert (got.argmax(-1) == w.argmax(-1)).mean() >= 0.99


def test_stale_folds_rebuilt_after_a_seg_step(stem_route):
    from mds_tpu_torch.engine.optim import AdamW

    cfg = tiny()
    _, v = jax_semseg(cfg, seed=5)
    tm = port_semseg(cfg, v, torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, 64, 64, generator=gen).to(torch.bfloat16)
    tm.eval()
    with torch.no_grad():
        tm.eval_logits(x, 0)
    packs = tm.backbone._packs
    folds = {k: e[1] for k, e in packs._entries.items()}
    assert sorted(folds) == ["fold/0", "fold/1", "fold/2"]
    opt = AdamW(list(tm.parameters()), lambda _: 1e-2)
    tm.train()
    # 128×128 in the train step: torch's CPU bf16 conv weight gradient reads
    # uninitialized memory at a 1×1 input with stride 2 (64×64's deepest
    # level has one), see PERF.md §7
    feats = tm.features([torch.randn(1, 3, 128, 128, generator=gen) for _ in range(2)])
    sum(f.float().square().mean() for f in feats).backward()
    opt.step()
    tm.eval()
    fresh = port_semseg(cfg, v, torch.bfloat16).eval()  # no cached fold
    fresh.load_state_dict(tm.state_dict())
    with torch.no_grad():
        routed, want = tm.eval_logits(x, 0), fresh.eval_logits(x, 0)
    assert torch.equal(routed, want)  # a stale fold would part them
    for k, (s, b) in folds.items():
        new_s, new_b = packs._entries[k][1]
        assert not torch.equal(new_s, s) and not torch.equal(new_b, b), k
