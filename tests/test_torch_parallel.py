"""The parallel layer (mds_tpu_torch/parallel/) at world 2 on the CPU.

Two gloo ranks run as subprocesses that import only the port
(tests/torch_parallel_worker.py), in one launch for the whole file: the
SyncBN train step, both train norms alone, the dropout masks, the global
OHEM pool, the eval hist, tiled inference and the halo conv. The parent runs the same functions
without a group (the world-1 side) and JAX's counterparts on
`make_mesh(2)` (tests/conftest.py gives JAX 8 CPU devices).

The SyncBN step is BiSeNetV2 at test width with two datasets, 4 images of
64×128 a dataset, dropout on, rows 0-1 on rank 0 and 2-3 on rank 1, the
two halves' pixel values shifted apart (0-127 against 128-255) so that
local and global moments differ. Gates:
- f64: world 2 against world 1, every tensor rel ≤ 1e-10 (measured
  6.4e-15, the rounding of two summation orders): the same step;
- f32, plain and `fused_up_loss`: against the f64 world-1 step (the exact
  one) at the port's own f32 gates (tests/test_torch_train.py: loss ≤ 1e-6,
  running stats ≤ 1e-5, parameters ≤ 5e-4; measured 2.9e-8, 6.1e-6,
  2.1e-4), and against the f32 world-1 step at twice that step's own
  distance from the exact one (the repo's rule for ill-conditioned f32
  cases; the world-1 f32 step lies 4.1e-6 and 4.7e-4 from it, the world-2
  step 4.4e-6 and 4.7e-4 from the world-1 one);
- each dataset's BN slots after the step differ from the local-BN run's
  (rel ≥ 1e-2; measured 0.92 and 1.15): a missing all_reduce in the norms
  fails the f64 gate.
"""

import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from mds_tpu.evaluation.evaluator import make_logits_fn as j_make_logits_fn
from mds_tpu.models import bisenetv2 as jb
from mds_tpu.parallel import mesh as jmesh
from mds_tpu.parallel import spatial as jspatial
from mds_tpu_torch.ops.dropout import DropoutU8, dropout_u8_plain
from mds_tpu_torch.parallel import mesh, spatial
from torch_eval_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import as_port, make_variables, seg_batch

N_CLASSES = (19, 7)
OHEM_THRESH = -math.log(0.7)
DROP_SHAPE = (4, 16, 6, 10)


def _shifted_batch(rng, n):
    im, lb = seg_batch(rng, 4, 64, 128, n)
    im = im.astype(np.int32) // 2
    im[2:] += 128
    return im.astype(np.uint8), lb


def _ohem_inputs(rng):
    """(losses, valid) of each case, (2 · rows, ...) so each rank holds
    half: the threshold branch (most pixels above −log 0.7), the top-k
    fallback (1% above), and an odd split (n_min = 37, the hard pixels all
    on rank 1)."""
    out = {}
    shape = (4, 16, 33)
    lo = rng.uniform(0, 2, shape)
    out["threshold"] = (lo, rng.random(shape) > 0.05)
    few = rng.uniform(0, 0.3, shape)
    few[rng.random(shape) < 0.01] += 1.0
    out["topk"] = (few, rng.random(shape) > 0.05)
    odd = rng.uniform(0, 0.3, (2, 1, 19, 31))
    odd[1] += rng.uniform(0.0, 0.05, odd[1].shape)
    valid = np.ones(odd.shape, bool)
    valid.reshape(-1)[:2 * 589 - 37 * 16 - 5] = False  # n_valid = 597: n_min = 37
    out["odd"] = (odd, valid)
    return {k: (a.astype(np.float32), v) for k, (a, v) in out.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(6)
    params, stats = make_variables(N_CLASSES, 2, 5)
    inp = {"n_classes": np.asarray(N_CLASSES), "thresh": np.asarray(OHEM_THRESH),
           "drop_shape": np.asarray(DROP_SHAPE), "tile_n": np.asarray(4)}
    inp.update({"sd_" + k: v for k, v in as_port(params, stats).items()})
    for i, n in enumerate(N_CLASSES):
        inp[f"im{i}"], inp[f"lb{i}"] = _shifted_batch(rng, n)
    for c, (losses, valid) in _ohem_inputs(rng).items():
        inp[f"losses_{c}"], inp[f"valid_{c}"] = losses, valid
    lb = rng.integers(0, 4, (1, 64, 256))
    inp["tile_im_local"] = (lb * 20).astype(np.float32)[:, None].repeat(3, 1)
    lb2 = np.repeat(np.repeat(rng.integers(0, 4, (1, 16, 64)), 2, 1), 2, 2)
    inp["tile_im_down"] = (lb2 * 20).astype(np.float32)[:, None].repeat(3, 1)
    inp["tile_margin_local"], inp["tile_margin_down"] = np.asarray(32), np.asarray(16)
    inp["tile_im_model"] = rng.integers(0, 256, (1, 3, 32, 256)).astype(np.float32)
    inp["tile_margin_model"] = np.asarray(32)
    norm_x = rng.normal(0, 1, (4, 6, 5, 7))
    norm_x[2:] = 3.0 + 2.0 * norm_x[2:]  # the ranks' halves apart
    inp["norm_x"], inp["norm_g"] = norm_x, rng.normal(0, 1, norm_x.shape)
    inp["halo_x"] = rng.normal(0, 1, (1, 8, 16, 64)).astype(np.float32)
    inp["halo_k"] = rng.normal(0, 0.2, (4, 8, 3, 3)).astype(np.float32)
    np.savez(d / "inputs.npz", **inp)
    return str(d), np.load(d / "inputs.npz"), (params, stats)


@pytest.fixture(scope="module")
def runs(inputs):
    """(rank 0's results, rank 1's, world 1's, JAX's tiled logits): the
    world-2 launch and JAX's compile run while the parent computes world
    1."""
    d, inp, (params, stats) = inputs
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        job = pool.submit(w.launch, 2, d, ["steps", "norms", "dropout", "ohem", "eval", "tiles",
                                           "halo"])
        jtiles = pool.submit(lambda: {name: _jax_tiles(inp, name, params, stats)
                                      for name in ("local", "down", "model")})
        one = w.norms(inp)
        for prefix, dt, fused, local in w.STEPS[:3]:
            one.update(w.seg_step(inp, dt, fused, local, prefix=prefix))
        one.update(w.dropout_masks(DROP_SHAPE))
        one.update(w.ohem_cases(inp))
        one.update(w.eval_hists())
        one.update(w.tiles(inp, n_tiles=2))
        job.result()
    r0, r1 = (dict(np.load(f"{d}/rank{r}.npz")) for r in range(2))
    return r0, r1, one, jtiles.result()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _errors(got, want, prefix_got, prefix_want):
    """Worst rel max-diff of the loss, the running stats and the parameters."""
    err = {"loss": _rel(got[prefix_got + "loss"], want[prefix_want + "loss"]),
           "stats": 0.0, "params": 0.0}
    for k in want:
        if not k.startswith(prefix_want) or k == prefix_want + "loss" or k[:3] == "sd_":
            continue
        name = k[len(prefix_want):]
        kind = "stats" if "running" in name else "params"
        err[kind] = max(err[kind], _rel(got[prefix_got + name], want[k]))
    return err


def test_syncbn_step_f64_equals_world1(runs):
    r0, r1, one, _ = runs
    for k, v in r0.items():
        if k.startswith("f64_"):
            assert np.array_equal(v, r1[k]), k  # the ranks hold one state
    err = _errors(r0, one, "f64_", "f64_")
    assert max(err.values()) <= 1e-10, err


@pytest.mark.parametrize("route", ["f32_", "fused_"])
def test_syncbn_step_f32(runs, route):
    r0, r1, one, _ = runs
    for k, v in r0.items():
        if k.startswith(route):
            assert np.array_equal(v, r1[k]), k
    exact = _errors(r0, one, route, "f64_")
    assert exact["loss"] <= 1e-6 and exact["stats"] <= 1e-5 and exact["params"] <= 5e-4, exact
    own = _errors(one, one, route, "f64_")  # the world-1 f32 step's own error
    got = _errors(r0, one, route, route)
    for kind, floor in (("loss", 1e-6), ("stats", 1e-5), ("params", 1e-4)):
        assert got[kind] <= max(2 * own[kind], floor), (kind, got, own)


def test_syncbn_differs_from_local_bn(runs):
    """Local BN's stats (each rank's own moments, then averaged) are not
    SyncBN's, in each dataset's slot: the batch halves are shifted apart."""
    r0, r1, _, _ = runs
    for slot in (0, 1):
        keys = [k[4:] for k in r0 if k.startswith("f32_") and f".bn.{slot}.running_var" in k]
        assert keys
        assert max(_rel(r0["local_" + k], r0["f32_" + k]) for k in keys) >= 1e-2
        assert all(np.array_equal(r0["local_" + k], r1["local_" + k]) for k in keys)


@pytest.mark.parametrize("norm", ["dataset_norm", "bn_eval"])
def test_sync_norms_equal_world1(runs, norm):
    """Each train norm on the ranks' halves in a SyncBN step: outputs and
    input gradients are the rows of world 1's, the running stats world
    1's (f64, rel ≤ 1e-12); the gradient reaches through the other rank's
    moments (without global_sum's backward it would differ by O(1))."""
    r0, r1, one, _ = runs
    for k in ("y", "dx"):
        got = np.concatenate([r0[f"{norm}_{k}"], r1[f"{norm}_{k}"]])
        assert _rel(got, one[f"{norm}_{k}"]) <= 1e-12, (k, _rel(got, one[f"{norm}_{k}"]))
    for k in ("mean", "var"):
        np.testing.assert_array_equal(r0[f"{norm}_{k}"], r1[f"{norm}_{k}"])
        assert _rel(r0[f"{norm}_{k}"], one[f"{norm}_{k}"]) <= 1e-12


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dropout_masks_are_rows_of_world1(runs, dtype):
    r0, r1, one, _ = runs
    for what in ("mask", "grad"):
        k = f"{what}_{dtype}"
        assert np.array_equal(np.concatenate([r0[k], r1[k]]), one[k]), k
    assert not np.array_equal(r0[f"mask_{dtype}"], r1[f"mask_{dtype}"])
    assert 0.85 < one[f"mask_{dtype}"].mean() < 0.95


@pytest.mark.parametrize("case", ["threshold", "topk", "odd"])
def test_ohem_global_pool(inputs, runs, case):
    """The ranks' shares sum to the world-1 value, each rank's gradient is
    its rows of world 1's; the case takes the branch it names."""
    _, inp, _ = inputs
    r0, r1, one, _ = runs
    losses, valid = inp[f"losses_{case}"].ravel(), inp[f"valid_{case}"].ravel()
    n_min = valid.sum() // 16
    n_above = (valid & (losses > OHEM_THRESH)).sum()
    assert (n_above >= n_min) == (case == "threshold"), (n_above, n_min)
    if case == "odd":
        assert n_min % 2 == 1
    total = r0[f"ohem_{case}"] + r1[f"ohem_{case}"]
    assert _rel(total, one[f"ohem_{case}"]) <= 1e-6, (total, one[f"ohem_{case}"])
    g = np.concatenate([r0[f"ohem_grad_{case}"], r1[f"ohem_grad_{case}"]])
    np.testing.assert_array_equal(g != 0, one[f"ohem_grad_{case}"] != 0)
    assert _rel(g, one[f"ohem_grad_{case}"]) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_global_kth_is_the_sorted_value(dtype):
    """The global pool's cutoff (no group here: the all_reduce is the
    identity) is the n_min-th largest by the sort, for every n_min, over
    ties, −0.0, negatives and the −∞ of ignored pixels."""
    from mds_tpu_torch.losses.ohem_ce import _global_kth

    rng = np.random.default_rng(3)
    x = rng.standard_normal(97) * 4
    x[::5] = np.round(x[::5])  # ties
    x[1::11] = -0.0
    x[2::7] = -np.inf
    x = torch.tensor(x, dtype=dtype)
    want = x.sort(descending=True).values
    for n_min in range(1, x.numel() + 1):
        got = _global_kth(x, torch.tensor(n_min))
        assert got.dtype == dtype and got == want[n_min - 1], (n_min, got, want[n_min - 1])


def test_eval_hist_world2_equals_world1(runs):
    r0, r1, one, _ = runs
    for i in range(2):
        assert r0[f"hist{i}"].dtype == np.int64
        np.testing.assert_array_equal(r0[f"hist{i}"], one[f"hist{i}"])
        np.testing.assert_array_equal(r1[f"hist{i}"], one[f"hist{i}"])
        assert one[f"hist{i}"].sum() > 0
    np.testing.assert_array_equal(r0["mious"], one["mious"])


def _jax_tiles(inp, name, params, stats):
    """JAX's tiled_inference on make_mesh(2), NCHW out."""
    im = jnp.asarray(np.transpose(inp[f"tile_im_{name}"], (0, 2, 3, 1)))
    n = int(inp["tile_n"])
    if name == "model":
        model = jb.BiSeNetV2(n_classes=N_CLASSES, n_bn=2, dtype=jnp.float32)
        fn = jax.jit(j_make_logits_fn(model, {"params": params, "batch_stats": stats},
                                      w.MEAN, w.STD), static_argnums=1)
        n = N_CLASSES[0]
    else:
        def fn(x, ds, _down=name == "down"):
            x = x[:, ::2, ::2] if _down else x
            cls = jnp.clip(jnp.round(x[..., 0] / 20.0), 0, n - 1).astype(jnp.int32)
            return jax.nn.one_hot(cls, n)
    out = jspatial.tiled_inference(fn, im, n, mesh=jmesh.make_mesh(2),
                                   margin=int(inp[f"tile_margin_{name}"]))
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


@pytest.mark.parametrize("name", ["local", "down", "model"])
def test_tiled_inference_matches_jax(inputs, runs, name):
    """World 2 (a tile a rank) and world 1 with n_tiles=2 (one batch)
    against JAX's on make_mesh(2): logits rel ≤ 1e-4; the oracles exact."""
    r0, r1, one, jtiles = runs
    want = jtiles[name]
    np.testing.assert_array_equal(r0[f"tile_{name}"], r1[f"tile_{name}"])
    for got in (r0[f"tile_{name}"], one[f"tile_{name}"]):
        assert got.shape == want.shape
        assert _rel(got, want) <= (1e-4 if name == "model" else 0.0), _rel(got, want)
    if name == "local":
        lb = np.round(inputs[1]["tile_im_local"][:, 0] / 20)
        np.testing.assert_array_equal(want.argmax(1), lb)


def test_halo_conv3x3_world2(inputs, runs):
    """Rank 0's and rank 1's W-shards against JAX's halo conv on
    make_mesh(2) and the unsharded conv."""
    _, inp, _ = inputs
    r0, r1, _, _ = runs
    got = np.concatenate([r0["halo"], r1["halo"]], axis=-1)
    x, k = inp["halo_x"], inp["halo_k"]
    whole = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                       padding=1).numpy()
    j = jspatial.halo_conv3x3(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                              jnp.asarray(np.transpose(k, (2, 3, 1, 0))), jmesh.make_mesh(2))
    j = np.transpose(np.asarray(j), (0, 3, 1, 2))
    assert _rel(got, whole) <= 1e-5 and _rel(got, j) <= 1e-5, (_rel(got, whole), _rel(got, j))
    assert r0["collectives"] == r1["collectives"] > 0


@pytest.mark.parametrize("size,n_tiles,margin", [
    (2048, 8, 96), (2048, 2, 96), (2048, 1, 96), (256, 2, 32), (128, 2, 16),
    (1000, 3, 50), (97, 4, 7), (4096, 16, 128)])
def test_plan_tiles_matches_jax(size, n_tiles, margin):
    assert spatial.plan_tiles(size, n_tiles, margin) == jspatial.plan_tiles(
        size, n_tiles, margin)


@pytest.mark.parametrize("offset", [0, 1, 3, 2 * 16 * 6 * 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_offset_is_a_slice_of_the_whole_draw(offset, dtype):
    """The plain dropout at an element offset equals that slice of the draw
    over a larger tensor, forward and backward (the mask regenerated)."""
    rng = np.random.default_rng(3)
    whole = torch.from_numpy(rng.normal(0, 1, (4, 16, 6, 10)).astype(np.float32)).to(dtype)
    n = whole[2:].numel()
    ref = dropout_u8_plain(whole, 123, 456, 26)
    part = whole.reshape(-1)[offset:offset + n].reshape(whole[2:].shape)
    got = dropout_u8_plain(part, 123, 456, 26, offset)
    np.testing.assert_array_equal(got.float().numpy().ravel(),
                                  ref.reshape(-1)[offset:offset + n].float().numpy())
    x = part.clone().requires_grad_(True)
    g = torch.ones_like(x)
    DropoutU8.apply(x, 123, 456, 26, offset).backward(g)
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  dropout_u8_plain(g, 123, 456, 26, offset).float().numpy())


def test_helpers_without_a_group():
    """No group: rank 0 of 1, reductions the identity, no step marked;
    shard_batch places rows as JAX's shard_batch does on make_mesh(2)."""
    assert (mesh.rank(), mesh.world(), mesh.initialized()) == (0, 1, False)
    t = torch.arange(6.0)
    assert mesh.all_reduce(t) is t and torch.equal(mesh.global_sum(t), t)
    with mesh.data_parallel(sync_bn=True):
        assert not mesh.sync_active() and mesh.shard_index() == 0
    assert mesh.pad_batch_to(7, 2) == jmesh.pad_batch_to(7, jmesh.make_mesh(2)) == 8
    x = np.arange(24).reshape(4, 6)
    arr = jmesh.shard_batch({"x": x}, jmesh.make_mesh(2))["x"]
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(mesh.shard_batch({"x": [x]}, r, 2)["x"][0],
                                      np.asarray(s.data))
    with pytest.raises(ValueError):
        mesh.shard_batch(x, 0, 3)
