"""The port's serving path on the CPU: E2EModel behind InferenceServer over
loopback (the same raw-tensor protocol as mds_tpu/deploy/server.py), its
`instances` bounding how many requests run the model at once and any
exception from the model answered 400, as JAX's server does; the port
standing alone: neither the package, nor the serve path, nor
chip_smoke.py imports jax or anything of mds_tpu or reads a file under
mds_tpu/; and the port's own copies of the config, label-spec and weight
tables equal the JAX package's."""

import ast
import glob
import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.deploy.server import InferenceServer

HW = (32, 64)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served():
    model = MODELS["bisenetv2"](n_classes=(5,), aux=False)
    model.init_weights(torch.Generator().manual_seed(0))
    e2e = E2EModel(model, [0.3, 0.3, 0.3], [0.2, 0.2, 0.2], device="cpu")
    srv = InferenceServer(e2e, HW, name="test")
    httpd = srv.serve_background(0)
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, body):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=60) as r:
        shape = json.loads(r.headers["X-Shape"])
        return np.frombuffer(r.read(), np.int32).reshape(shape)


def test_health_and_metadata(served):
    _, url = served
    with urllib.request.urlopen(f"{url}/v2/health/ready", timeout=10) as r:
        assert r.status == 200
    with urllib.request.urlopen(f"{url}/v2/models/test", timeout=10) as r:
        meta = json.loads(r.read())
    assert meta["inputs"][0]["shape"] == [1, *HW, 3]


def test_raw_tensor_infer_matches_model(served):
    srv, url = served
    im = np.random.default_rng(0).integers(0, 256, (1, *HW, 3)).astype(np.uint8)
    out = _post(f"{url}/v2/models/test/infer", im.tobytes())
    assert out.shape == (1, *HW) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < 5
    np.testing.assert_array_equal(out, srv.model.infer(im))


def test_wrong_size_and_path(served):
    _, url = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/v2/models/test/infer", b"\0" * 10)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/v2/models/other/infer", b"\0" * 10)
    assert e.value.code == 404


class _Model:
    """Stands in for an E2EModel: each call holds for 0.2 s, counting the
    calls inside at once; with `fail`, it raises that exception."""

    def __init__(self, fail=None):
        self.now = self.most = 0
        self.fail = fail
        self.lock = threading.Lock()

    def infer(self, im):
        with self.lock:
            self.now += 1
            self.most = max(self.most, self.now)
        try:
            time.sleep(0.2)
            if self.fail is not None:
                raise self.fail
            return np.zeros(im.shape[:3], np.int32)
        finally:
            with self.lock:
                self.now -= 1


@pytest.mark.parametrize("instances", [None, 1, 3])
def test_server_instances_bound_concurrency(instances):
    """8 requests at once run the model at most `instances` at a time (2 by
    default, mds_tpu/deploy/server.py:29-39)."""
    model = _Model()
    kw = {} if instances is None else {"instances": instances}
    srv = InferenceServer(model, HW, name="test", **kw)
    raw = bytes(int(np.prod((1, *HW, 3))))
    threads = [threading.Thread(target=srv.infer, args=(raw,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert model.most == (2 if instances is None else instances)
    with pytest.raises(ValueError):
        InferenceServer(model, HW, instances=0)


def test_server_answers_400_on_any_exception():
    """An exception from the model other than the wrong size's ValueError
    answers 400 with its message (mds_tpu/deploy/server.py:83-88)."""
    srv = InferenceServer(_Model(fail=RuntimeError("the model failed")), HW,
                          name="test")
    httpd = srv.serve_background(0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v2/models/test/infer"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, bytes(int(np.prod((1, *HW, 3)))))
        assert e.value.code == 400 and e.value.read() == b"the model failed"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_e2e_normalizes_like_jax_graph():
    """(u8/255 − mean)/std in f32, then the model's dtype, NCHW view of the
    NHWC memory (channels_last)."""
    seen = {}

    class Probe(torch.nn.Module):
        dtype = torch.bfloat16

        def pred(self, x, dataset):
            seen["x"] = x
            return x[:, 0].round()

    im = np.random.default_rng(1).integers(0, 256, (1, 4, 6, 3)).astype(np.uint8)
    mean, std = np.asarray([0.1, 0.2, 0.3]), np.asarray([0.5, 0.6, 0.7])
    out = E2EModel(Probe(), mean, std, device="cpu").infer(im)
    x = seen["x"]
    assert x.dtype == torch.bfloat16 and x.shape == (1, 3, 4, 6)
    assert x.is_contiguous(memory_format=torch.channels_last)
    want = ((im.astype(np.float32) / 255.0 - mean.astype(np.float32))
            / std.astype(np.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(
        x.float().numpy(), torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    assert out.dtype == np.int32


def test_package_and_serve_path_import_no_jax():
    code = (
        "import sys\n"
        "import mds_tpu_torch\n"
        "from mds_tpu_torch.deploy import e2e, server\n"
        "from mds_tpu_torch.ops import build, conv3x3, stem\n"
        "assert 'jax' not in sys.modules and 'mds_tpu' not in sys.modules\n"
        "sys.path.insert(0, 'tools')\n"
        "import serve_torch\n"
        "m = serve_torch.build_e2e('configs/bisenetv2_city.json', device='cpu')\n"
        "assert m.model.n_classes == (19,)\n"
        "assert not {'jax', 'flax', 'mds_tpu'} & set(sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_serve_torch_requires_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import serve_torch

    monkeypatch.setattr(sys, "argv", ["serve_torch.py", "--config",
                                      os.path.join(ROOT, "configs/bisenetv2_city.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_torch.main()


def test_every_module_and_converter_import_no_mds_tpu(tmp_path):
    """Every module of mds_tpu_torch, build_e2e and the weight converter
    (fed a JAX variables tree as plain numpy) run in a process where neither
    jax nor mds_tpu gets imported."""
    import jax

    from mds_tpu.models.bisenetv2 import BiSeNetV2

    jm = BiSeNetV2(n_classes=(5, 7), n_bn=2)
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = jax.jit(lambda k: jm.init({"params": k, "dropout": k}, [x, x], train=True))(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, dict(v))
    with open(tmp_path / "v.pkl", "wb") as f:
        pickle.dump({k: tree[k] for k in ("params", "batch_stats")}, f)
    code = (
        "import importlib, pickle, pkgutil, sys\n"
        "import mds_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(mds_tpu_torch.__path__, 'mds_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert 'mds_tpu_torch.ops.conv3x3' in mods, mods\n"
        "sys.path.insert(0, 'tools')\n"
        "import serve_torch\n"
        "serve_torch.build_e2e('configs/bisenetv2_city.json', device='cpu')\n"
        "from mds_tpu_torch import MODELS\n"
        "from mds_tpu_torch.deploy.weights import bisenetv2_state_dict_from_jax\n"
        f"v = pickle.load(open({str(tmp_path / 'v.pkl')!r}, 'rb'))\n"
        "sd = bisenetv2_state_dict_from_jax(v['params'], v['batch_stats'])\n"
        "MODELS['bisenetv2']((5, 7), n_bn=2, aux=True).load_state_dict(sd, strict=True)\n"
        "bad = {'jax', 'jaxlib', 'flax', 'mds_tpu'} & set(sys.modules)\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith("ok")


_FILE_LINE = re.compile(r"^mds_tpu/\S+\.py:\d+(-\d+)?$")  # a citation


def _offences(path):
    """Imports of mds_tpu and string constants that name a path under
    mds_tpu/ (docstrings and file:line citations aside)."""
    tree = ast.parse(open(path).read(), path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out += [a.name for a in n.names if a.name.split(".")[0] in ("mds_tpu", "jax")]
        elif isinstance(n, ast.ImportFrom) and n.module:
            if n.module.split(".")[0] in ("mds_tpu", "jax"):
                out.append(n.module)
        elif (isinstance(n, ast.Constant) and isinstance(n.value, str)
              and id(n) not in docs):
            v = n.value
            if v == "mds_tpu" or v.startswith("mds_tpu.") or (
                    re.search(r"(^|[^\w])mds_tpu/", v) and not _FILE_LINE.match(v)):
                out.append(v)
    return out


def test_static_scan_finds_no_mds_tpu():
    files = sorted(glob.glob(os.path.join(ROOT, "mds_tpu_torch", "**", "*.py"),
                             recursive=True))
    files += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "tools", "cuda_shim", "rehearse.py")]
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "*_torch.py")))
    assert os.path.join(ROOT, "tools", "serve_torch.py") in files
    assert len(files) >= 21
    # the kernels' loaders: every module that launches a csrc/*.cu kernel
    loaders = {os.path.join("mds_tpu_torch", "ops", f"{m}.py") for m in (
        "build", "conv3x3", "depthwise", "dropout", "stem", "upsample_argmax")}
    assert loaders <= {os.path.relpath(f, ROOT) for f in files}
    found = {os.path.relpath(f, ROOT): _offences(f) for f in files}
    assert {k: v for k, v in found.items() if v} == {}
    # the scan does catch each kind of offence
    probe = os.path.join(ROOT, "tests", "torch_parity.py")
    assert "mds_tpu.deploy.torch_import" in _offences(probe)


def test_port_copies_equal_the_jax_tables():
    """Configer, get_spec and bisenetv2_to_torch of the port give what the
    JAX package's give."""
    import jax

    from mds_tpu.config import Configer as JConfiger
    from mds_tpu.data.labels import get_spec as j_get_spec
    from mds_tpu.deploy.torch_import import bisenetv2_to_torch as j_to_torch
    from mds_tpu.models.bisenetv2 import bisenetv2_origin
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import _raw_specs, get_spec
    from mds_tpu_torch.deploy.weights import bisenetv2_to_torch

    for path in glob.glob(os.path.join(ROOT, "configs", "*.json")):
        a, b = Configer(config_file=path), JConfiger(config_file=path)
        assert a.params_root == b.params_root and a.n_datasets == b.n_datasets
        for i in range(a.n_datasets):
            assert a.dataset_cfg(i) == b.dataset_cfg(i)
            assert a.n_cats(i) == b.n_cats(i)
        assert a.get("lr", "lr_start") == b.get("lr", "lr_start")
    for name in _raw_specs():
        a, b = get_spec(name), j_get_spec(name)
        assert a.n_cats == b.n_cats
        for f in ("mean", "std", "lut_eval", "lut_train"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    jm = bisenetv2_origin(n_classes=(5, 7), n_bn=2)
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = jax.jit(lambda k: jm.init({"params": k, "dropout": k}, [x, x], train=True))(
        jax.random.PRNGKey(1))
    p, s = (jax.tree_util.tree_map(np.asarray, v[c]) for c in ("params", "batch_stats"))
    a, b = bisenetv2_to_torch(p, s), j_to_torch(p, s)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
