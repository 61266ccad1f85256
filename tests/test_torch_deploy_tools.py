"""The port's deploy and data tools on the CPU, each against its JAX
counterpart where one exists:

- tools/segment_torch.py compile (--fp16 --ckpt) | run | test on .npy and
  .png frames of another size than the engine's: run's output equals the
  artifact's labels put through tools/segment.py's resize recipe
  (:64-77), and test reports the kernels' nodes;
- tools/serve_torch.py --engine in a process of its own: the artifact's
  input shape and labels over HTTP;
- tools/demo_torch.py against tools/demo.py on carried f32 weights, a
  70×100 frame (the /32 rounding for the BGA and the nearest resize back);
- tools/demo_video_torch.py: a .npy stack at a fixed batch with a padded
  tail, each frame as its single-frame prediction;
- tools/calc_class_weight_torch.py and tools/label_tools_torch.py against
  tools/calc_class_weight.py and tools/label_tools.py: the same JSON, the
  same listing, the same mask files.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.labels import get_spec
from mds_tpu_torch.data.transforms import resize_image
from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.deploy.export import load_exported_obj
from mds_tpu_torch.deploy.server import InferenceServer
from mds_tpu_torch.engine.checkpoints import CheckpointManager
from mds_tpu_torch.engine.trainer import build_model
from mds_tpu_torch.models import layers as tl
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import bisenetv2_pair, randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
CONFIG = os.path.join(ROOT, "configs", "bisenetv2_city.json")
SYNTHETIC = os.path.join(ROOT, "configs", "test_synthetic.json")
H, W = 64, 128  # the engine's input
SERVED = {"detail_s1s2_fused": 1, "stemblock_fused": 1, "detail_tail_fused": 1,
          "depthwise3x3": 16, "upsample_argmax": 1}

sys.path.insert(0, TOOLS)
import calc_class_weight_torch  # noqa: E402
import demo_torch  # noqa: E402
import demo_video_torch  # noqa: E402
import label_tools_torch  # noqa: E402
import segment_torch  # noqa: E402


def plain_routes():
    tl.set_stem_impl("plain")
    tl.set_detail_fuse(False)
    tl.set_detail_tail(False)
    tl.set_depthwise_impl("plain")
    tl.set_pred_impl("plain")


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """configs/bisenetv2_city.json's model (seeded, random BN) in a
    checkpoint, compiled by segment_torch compile --fp16 --ckpt for the CPU
    at 64×128: (engine path, the model, the engine loaded)."""
    d = tmp_path_factory.mktemp("engine")
    model = build_model(Configer(config_file=CONFIG), torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(4))
    randomize_bn(model, 4)
    CheckpointManager(str(d / "ckpt")).maybe_save(
        {"model": {k: v.clone() for k, v in model.state_dict().items()}, "step": 0},
        force=True)
    path = str(d / "v2.pt2")
    try:
        segment_torch.main(["compile", "--config", CONFIG, "--ckpt", str(d / "ckpt"),
                            "--engine", path, "--size", str(H), str(W), "--fp16",
                            "--device", "cpu"])
    finally:
        plain_routes()
    return path, model, load_exported_obj(path)


def jax_run_recipe(art, im):
    """tools/segment.py cmd_run (:64-78) on the artifact's call."""
    h, w = im.shape[:2]
    eh, ew = art.input_shape[1:3]
    im_in = np.asarray(Image.fromarray(im).resize((ew, eh), Image.BILINEAR))
    out = np.asarray(art.call(im_in[None].astype(np.uint8)))[0]
    out = np.asarray(Image.fromarray(out.astype(np.uint8)).resize((w, h), Image.NEAREST))
    palette = np.random.default_rng(123).integers(0, 256, (256, 3), np.uint8)
    return palette[np.clip(out, 0, 255)], out


@pytest.mark.parametrize("ext", [".npy", ".png"])
def test_segment_run_matches_the_jax_recipe(engine, tmp_path, ext):
    path, _, art = engine
    im = np.random.default_rng(1).integers(0, 256, (70, 100, 3)).astype(np.uint8)
    src, out = str(tmp_path / f"in{ext}"), str(tmp_path / f"out{ext}")
    if ext == ".npy":
        np.save(src, im)
    else:
        Image.fromarray(im).save(src)
    segment_torch.main(["run", path, src, out])
    got = np.load(out) if ext == ".npy" else np.asarray(Image.open(out))
    want, labels = jax_run_recipe(art, im)
    assert got.shape == (70, 100, 3) and np.unique(labels).size > 1
    np.testing.assert_array_equal(got, want)


def _city():
    spec = get_spec("cityscapes")
    return spec.mean, spec.std


def test_segment_test_reports_the_kernels(engine, capsys):
    path, model, art = engine
    segment_torch.main(["test", path, "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "FPS" in lines[0] and f"(1, {H}, {W}, 3)" in lines[0]
    rec = json.loads(lines[-1])
    assert rec["graph_ops"] == SERVED and rec["device"] == "cpu"
    assert rec["launches_per_frame"] == {}  # the CPU runs the plain versions
    # the engine holds the checkpoint's model on the served routes
    im = np.random.default_rng(1).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    tl.set_stem_impl("kernel")
    tl.set_detail_fuse(True)
    tl.set_detail_tail(True)
    tl.set_depthwise_impl("kernel")
    tl.set_pred_impl("fused")
    try:
        eager = E2EModel(model, *_city(), device="cpu").infer(im)
    finally:
        plain_routes()
    np.testing.assert_array_equal(art.infer(im), eager)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            segment_torch.main(["compile", "--config", CONFIG, "--engine", "x.pt2"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_engine(engine):
    """serve_torch.py --engine in a process without jax: the artifact's
    input shape in the metadata, its labels in the replies."""
    path, _, art = engine
    assert InferenceServer(art, name="x").in_shape == art.input_shape == (1, H, W, 3)
    with pytest.raises(ValueError, match="serves"):
        InferenceServer(art, (32, 32))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(TOOLS, "serve_torch.py"), "--engine", path,
         "--port", str(port), "--name", "v2"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}/v2"
    try:
        for _ in range(600):
            try:
                with urllib.request.urlopen(f"{url}/health/ready", timeout=5):
                    break
            except OSError:
                if proc.poll() is not None:
                    pytest.fail(f"serve_torch exited: {proc.stdout.read()}")
                time.sleep(0.2)
        with urllib.request.urlopen(f"{url}/models/v2", timeout=10) as r:
            assert json.loads(r.read())["inputs"][0]["shape"] == [1, H, W, 3]
        for seed in (2, 3):
            im = np.random.default_rng(seed).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
            req = urllib.request.Request(f"{url}/models/v2/infer", data=im.tobytes())
            with urllib.request.urlopen(req, timeout=120) as r:
                shape = json.loads(r.headers["X-Shape"])
                got = np.frombuffer(r.read(), np.int32).reshape(shape)
            np.testing.assert_array_equal(got, art.infer(im))
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
    assert f"serving v2 (1, {H}, {W}, 3)" in out and "(cpu)" in out
    assert "jax" not in out.lower()


@pytest.fixture(scope="module")
def f32_pair():
    """A JAX BiSeNetV2 (19 classes, f32) and the port's with its weights."""
    jm, v, tm = bisenetv2_pair((19,), 1, False, jnp.float32, torch.float32, 4, (64, 96))
    return jm, v, tm


def test_demo_matches_jax_demo(f32_pair, tmp_path, monkeypatch):
    """tools/demo.py and tools/demo_torch.py on one 70×100 PNG with the same
    f32 weights (JAX's Trainer and the port's build_eval_bundle stubbed to
    hand them over): rounded to 64×96 for the BGA, the labels back at
    70×100 by nearest resize, colored by the cityscapes palette."""
    import mds_tpu.engine.trainer as jtrainer
    from mds_tpu_torch.evaluation import drivers

    jm, v, tm = f32_pair
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    monkeypatch.setattr(jtrainer, "Trainer", lambda configer, compute_dtype=None:
                        types.SimpleNamespace(model=jm, state=state))
    monkeypatch.setattr(drivers, "build_eval_bundle", lambda *a, **k: tm)
    seen = []
    monkeypatch.setattr(tm, "pred", lambda x, d=0, real=tm.pred: seen.append(x.shape) or real(x, d))
    im = np.random.default_rng(5).integers(0, 256, (70, 100, 3)).astype(np.uint8)
    Image.fromarray(im).save(tmp_path / "in.png")
    monkeypatch.syspath_prepend(TOOLS)
    import demo as jdemo

    monkeypatch.setattr(sys, "argv", ["demo.py", "--config", CONFIG, "--img",
                                      str(tmp_path / "in.png"), "--out",
                                      str(tmp_path / "jax.png")])
    jdemo.main()
    demo_torch.main(["--config", CONFIG, "--img", str(tmp_path / "in.png"), "--out",
                     str(tmp_path / "port.npy"), "--device", "cpu"])
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.load(tmp_path / "port.npy")
    assert seen == [(1, 3, 64, 96)]
    assert got.shape == want.shape == (70, 100, 3)
    share = float((got == want).all(-1).mean())
    print(f"demo_torch vs demo.py: pixel agreement {share}")
    assert share >= 0.999 and np.unique(want.reshape(-1, 3), axis=0).shape[0] > 1
    assert set(map(tuple, got.reshape(-1, 3))) <= set(map(tuple, get_spec("cityscapes").palette))


def test_demo_video_batches_equal_single_frames(f32_pair, tmp_path, monkeypatch):
    from mds_tpu_torch.evaluation import drivers

    tm = f32_pair[2]
    monkeypatch.setattr(drivers, "build_eval_bundle", lambda *a, **k: tm)
    frames = np.random.default_rng(6).integers(0, 256, (5, 40, 60, 3)).astype(np.uint8)
    np.save(tmp_path / "frames.npy", frames)
    for out in ("colors.npy", "dir"):
        demo_video_torch.main(["--config", CONFIG, "--frames", str(tmp_path / "frames.npy"),
                               "--out", str(tmp_path / out), "--batch", "2",
                               "--size", "64", "64", "--device", "cpu"])
    got = np.load(tmp_path / "colors.npy")
    e2e = E2EModel(tm, *_city(), device="cpu")
    palette = get_spec("cityscapes").palette
    assert got.shape == (5, 64, 64, 3)
    for i, f in enumerate(frames):
        want = palette[e2e.infer(resize_image(f, (64, 64))[None])[0]]
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "dir" / f"frame_{i:06d}.png")), want)
    assert sorted(os.listdir(tmp_path / "dir")) == [f"frame_{i:06d}.png" for i in range(5)]


def _jax_tool(monkeypatch, capsys, name, argv):
    """tools/<name>.py's main with argv, its standard output."""
    monkeypatch.syspath_prepend(TOOLS)
    mod = __import__(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("dataset", ["0", "1"])
def test_calc_class_weight_matches_jax(monkeypatch, capsys, dataset):
    argv = ["--config", SYNTHETIC, "--dataset", dataset, "--max-n", "5"]
    want = json.loads(_jax_tool(monkeypatch, capsys, "calc_class_weight", argv))
    calc_class_weight_torch.main(argv)
    got = json.loads(capsys.readouterr().out)
    assert got["pixel_counts"] == want["pixel_counts"] and sum(got["pixel_counts"]) > 0
    assert got["class_weight"].keys() == want["class_weight"].keys()
    for a, b in ((got["class_weight"].values(), want["class_weight"].values()),
                 (got["mean"], want["mean"]), (got["std"], want["std"])):
        np.testing.assert_allclose(list(a), list(b), rtol=0, atol=1e-6)


def test_label_tools_match_jax(monkeypatch, capsys, tmp_path):
    for spec in ("cityscapes", "camvid"):
        want = _jax_tool(monkeypatch, capsys, "label_tools", ["names", "--spec", spec])
        label_tools_torch.main(["names", "--spec", spec])
        assert capsys.readouterr().out == want and len(want.splitlines()) > 10
    # color masks: the spec's class colors and a few colors of no class
    spec = get_spec("camvid")
    rng = np.random.default_rng(7)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        ids = rng.integers(0, spec.n_cats + 3, (24, 40))
        colors = np.concatenate([spec.palette[:spec.n_cats],
                                 rng.integers(0, 256, (3, 3)).astype(np.uint8)])
        Image.fromarray(colors[ids]).save(src / f"m{i}.png")
        np.save(src / f"m{i}.npy", colors[ids])
    _jax_tool(monkeypatch, capsys, "label_tools",
              ["rgb2id", "--spec", "camvid", "--in", str(src), "--out", str(tmp_path / "j")])
    label_tools_torch.main(["rgb2id", "--spec", "camvid", "--in", str(src), "--out",
                            str(tmp_path / "t")])
    for i in range(2):
        jb = (tmp_path / "j" / f"m{i}.png").read_bytes()
        assert (tmp_path / "t" / f"m{i}.png").read_bytes() == jb
        mask = np.asarray(Image.open(tmp_path / "j" / f"m{i}.png"))
        assert mask.min() < spec.n_cats and mask.max() == 255
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f"m{i}.npy"), mask)
