"""The port's serving path on the CPU: E2EModel behind InferenceServer over
loopback (the same raw-tensor protocol as mds_tpu/deploy/server.py), and the
imports of the package and of the serve path leaving jax out."""

import json
import os
import subprocess
import sys
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
        "from mds_tpu_torch.ops import build, stem\n"
        "assert 'jax' not in sys.modules and 'mds_tpu' not in sys.modules\n"
        "sys.path.insert(0, 'tools')\n"
        "import serve_torch\n"
        "m = serve_torch.build_e2e('configs/bisenetv2_city.json', device='cpu')\n"
        "assert m.model.n_classes == (19,)\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
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
