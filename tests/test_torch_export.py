"""The port's deploy artifact (mds_tpu_torch/deploy/export.py) on the CPU at
(1, 64, 128, 3).

- f32 on the plain route: the port's export → save → load against JAX's
  (mds_tpu/deploy/export.py, the StableHLO round trip) on the same carried
  weights, for BiSeNetV2 and BiSeNetV1: label agreement >= 0.999.
- bf16 with the served routes, on the stem route, and BiSeNetV1 on the
  stem route: labels bit-equal to the eager E2EModel, one
  `mds_tpu_torch::` node per kernel call in the graph, and every weight,
  fold and packed table an op reads a parameter, buffer or constant of
  the artifact (none computed per call).
- The custom ops' fakes against their bodies (torch.library.opcheck), the
  artifact read back (input shape, graph text), loaded and run in a
  process without jax or mds_tpu, and refused where it cannot run.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.deploy import export as jexport
from mds_tpu.models import bisenetv1 as jv1
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy import export as texport
from mds_tpu_torch.deploy.e2e import E2EModel, E2EModule
from mds_tpu_torch.deploy.weights import bisenetv1_to_torch, load_reference_weights
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import custom_ops
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import bisenetv2_pair, randomize_bn, seeded_variables

H, W = 64, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.asarray([0.3038, 0.3383, 0.3034], np.float32)
STD = np.asarray([0.2071, 0.2088, 0.209], np.float32)
AGREE = 0.999
SERVED = {"detail_s1s2_fused": 1, "stemblock_fused": 1, "detail_tail_fused": 1,
          "depthwise3x3": 16, "upsample_argmax": 1}


def frame(seed):
    return np.random.default_rng(seed).integers(0, 256, (1, H, W, 3)).astype(np.uint8)


def set_routes(stem="plain", served=False):
    """The route switches of models/layers.py: the stem kernel, and with
    `served` every other deploy route; set_routes() is the plain path."""
    tl.set_stem_impl(stem)
    tl.set_detail_fuse(served)
    tl.set_detail_tail(served)
    tl.set_depthwise_impl("kernel" if served else "plain")
    tl.set_pred_impl("fused" if served else "plain")


def round_trip(tmp_path, model, name, **kw):
    """The port's artifact of `model` at (H, W), saved and loaded back."""
    ep = texport.export_model(model, (H, W), MEAN, STD, device="cpu", **kw)
    path = str(tmp_path / f"{name}.pt2")
    texport.save_exported(ep, path)
    return ep, path, texport.load_exported_obj(path)


def jax_round_trip(tmp_path, jm, v):
    blob = jexport.export_model(jm, v, (H, W), mean=MEAN, std=STD)
    path = str(tmp_path / "jax.shlo")
    jexport.save_exported(blob, path)
    return jexport.load_exported(path)


def test_bisenetv2_f32_artifact_matches_jax(tmp_path):
    jm, v, tm = bisenetv2_pair((5,), 1, False, jnp.float32, torch.float32, 4, (H, W))
    ep, _, art = round_trip(tmp_path, tm, "v2")
    assert texport.graph_ops(ep) == {}  # the plain route reaches no kernel
    call = jax_round_trip(tmp_path, jm, v)
    for seed in (0, 1):
        want = np.asarray(call(frame(seed)))
        got = art.call(frame(seed)).numpy()
        share = float((got == want).mean())
        print(f"bisenetv2 f32 artifact vs JAX, frame {seed}: label agreement {share}")
        assert got.dtype == np.int32 and got.shape == want.shape == (1, H, W)
        assert np.unique(want).size > 1 and share >= AGREE


def test_bisenetv1_f32_artifact_matches_jax(tmp_path):
    jm = jv1.BiSeNetV1(n_classes=(19,), aux=False)
    v = seeded_variables(jm, 3, [jnp.zeros((1, H, W, 3), jnp.float32)], train=True)
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=False)
    load_reference_weights(tm, bisenetv1_to_torch(v["params"], v["batch_stats"]))
    _, _, art = round_trip(tmp_path, tm, "v1")
    want = np.asarray(jax_round_trip(tmp_path, jm, v)(frame(4)))
    got = art.call(frame(4)).numpy()
    share = float((got == want).mean())
    print(f"bisenetv1 f32 artifact vs JAX: label agreement {share}")
    assert np.unique(want).size > 1 and share >= AGREE


def _v2_bf16(seed=4):
    tm = MODELS["bisenetv2"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    tm.init_weights(torch.Generator().manual_seed(seed))
    return randomize_bn(tm, seed)


def _v1_bf16(seed=2):
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    tm.init_weights(torch.Generator().manual_seed(seed))
    return randomize_bn(tm, seed)


def check_artifact(tm, ep, art, ops, name):
    """The artifact's graph holds `ops` and reads every weight as an input
    of its own; its labels equal the eager E2EModel's bit for bit, and
    running it builds nothing in the model's PackCaches."""
    assert texport.graph_ops(ep) == ops
    assert texport.graph_ops(art.program) == ops
    # no fold, cast or pack runs per call: each op's weights are inputs of
    # the artifact (parameters, buffers, constants), none computed by it
    assert texport.computed_weights(ep) == []
    assert len(ep.constants) >= sum(ops.values())
    # export_model drops torch.export's per-cast metadata assertions
    assert not [n for n in ep.graph.nodes
                if n.target is torch.ops.aten._assert_tensor_metadata.default]
    builds = [m._packs.builds for m in tm.modules() if hasattr(m, "_packs")]
    got = art.infer(frame(5))
    assert builds == [m._packs.builds for m in tm.modules() if hasattr(m, "_packs")]
    want = E2EModel(tm, MEAN, STD, device="cpu").infer(frame(5))
    print(f"{name}: bit-equal share {float((got == want).mean())}, "
          f"{np.unique(want).size} classes")
    assert np.unique(want).size > 1
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """BiSeNetV2's bf16 artifact with every deploy route on, saved and
    loaded back: (model, ExportedProgram, path, loaded artifact)."""
    tm = _v2_bf16()
    set_routes("kernel", True)
    try:
        return (tm, *round_trip(tmp_path_factory.mktemp("served"), tm, "v2"))
    finally:
        set_routes()


def test_served_artifact_bit_equal_to_eager(served):
    tm, ep, _, art = served
    set_routes("kernel", True)
    try:
        check_artifact(tm, ep, art, SERVED, "v2_served")
    finally:
        set_routes()


@pytest.mark.parametrize("name,model,ops", [
    ("v2_stem", _v2_bf16, {"stem_conv_bn_relu_s2": 2}),
    ("v1_stem", _v1_bf16, {"stem7_conv_bn_relu_s2": 2}),
])
def test_stem_route_artifact_bit_equal_to_eager(tmp_path, name, model, ops):
    tm = model()
    set_routes("kernel")
    try:
        check_artifact(tm, *round_trip(tmp_path, tm, name)[::2], ops, name)
    finally:
        set_routes()


def test_artifact_reads_back_and_runs_without_jax(served, tmp_path):
    _, _, path, art = served
    assert art.input_shape == (1, H, W, 3) and art.device == torch.device("cpu")
    text = texport.graph_text(art.program)
    for op in SERVED:
        assert f"torch.ops.mds_tpu_torch.{op}.default" in text
    with pytest.raises(ValueError, match="uint8"):
        art.call(np.zeros((1, H, W + 2, 3), np.uint8))
    want = art.infer(frame(7))
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from mds_tpu_torch.deploy.export import load_exported_obj\n"
        f"art = load_exported_obj({path!r})\n"
        f"im = np.random.default_rng(7).integers(0, 256, {(1, H, W, 3)}).astype(np.uint8)\n"
        f"np.save({str(tmp_path / 'labels.npy')!r}, art.infer(im))\n"
        "assert not {'jax', 'flax', 'mds_tpu'} & set(sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "labels.npy"), want)


def test_artifact_refused_where_it_cannot_run(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        texport.export_model(_v1_bf16(), (H, W))
    # the CPU artifact marked as a CUDA one: loading it needs a card
    cuda_path = str(tmp_path / "cuda.pt2")
    with zipfile.ZipFile(served[2]) as src, zipfile.ZipFile(cuda_path, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith("/extra/mds_tpu_torch.json"):
                data = json.dumps({"device": "cuda:0"}).encode()
            dst.writestr(item, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_exported_obj(cuda_path)
    bare = tmp_path / "bare.zip"
    zipfile.ZipFile(bare, "w").close()
    with pytest.raises(ValueError, match="not an artifact"):
        texport.artifact_device(str(bare))


def test_trace_without_a_real_frame_first_raises():
    """The folds and packs are made by a real frame before the trace; a
    trace that meets an unbuilt PackCache entry stops."""
    m = E2EModule(_v2_bf16(), MEAN, STD)
    set_routes("kernel", True)
    try:
        with torch.no_grad(), pytest.raises(RuntimeError, match="PackCache entry"):
            torch.export.export(m, (torch.zeros((1, H, W, 3), dtype=torch.uint8),),
                                strict=False)
    finally:
        set_routes()


def _bf16_cl(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def _fold(c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1


def _conv(o, i, k, seed):
    return torch.randn((o, i, k, k), generator=torch.Generator().manual_seed(seed)) * 0.2


def _params(shapes, seed):
    out = []
    for j, (o, i, k) in enumerate(shapes):
        out += [_conv(o, i, k, seed + j), *_fold(o, seed + j)]
    return out


OPCHECK = {
    "stem_conv_bn_relu_s2": lambda: (_bf16_cl((1, 3, 8, 12), 0), _conv(16, 3, 3, 1)
                                     .to(torch.bfloat16), *_fold(16, 2), True, None),
    "detail_s1s2_fused": lambda: (_bf16_cl((1, 3, 8, 12), 0), _params(
        [(64, 3, 3), (64, 64, 3), (64, 64, 3)], 3), []),
    "stemblock_fused": lambda: (_bf16_cl((2, 3, 8, 12), 0), _params(
        [(16, 3, 3), (8, 16, 1), (16, 8, 3), (16, 32, 3)], 4), []),
    "stem7_conv_bn_relu_s2": lambda: (_bf16_cl((1, 3, 8, 12), 0), _conv(64, 3, 7, 5),
                                      *_fold(64, 6), True, None),
    "detail_tail_fused": lambda: (_bf16_cl((1, 64, 8, 12), 0), _params(
        [(64, 64, 3), (64, 64, 3), (128, 64, 3), (128, 128, 3), (128, 128, 3)], 7), []),
    "depthwise3x3": lambda: (_bf16_cl((1, 16, 9, 12), 0), _conv(96, 1, 3, 8)
                             .to(torch.bfloat16), 2),
    "upsample_argmax": lambda: (_bf16_cl((1, 5, 4, 6), 0), 8),
}


@pytest.mark.parametrize("name", sorted(OPCHECK))
def test_custom_op_fake_matches_its_body(name):
    """Each op's fake gives the shape, dtype and strides its body returns
    (channels_last maps, a contiguous int32 label map), and the op is
    registered as it should be (torch.library.opcheck)."""
    op = getattr(custom_ops, name)
    torch.library.opcheck(op, OPCHECK[name](),
                          test_utils=("test_schema", "test_faketensor",
                                      "test_autograd_registration"))
    assert name in custom_ops.KERNELS
