"""HTTP inference service for the port — counterpart of
mds_tpu/deploy/server.py, with the same raw-tensor protocol:

  POST /v2/models/<name>/infer
    body  = raw uint8 NHWC bytes of shape (1, H, W, 3)
    reply = raw int32 label-map bytes, shape in the X-Shape header
  GET /v2/health/ready → 200
  GET /v2/models/<name> → JSON metadata

It wraps an E2EModel at the frame size it is given, or an artifact of
deploy/export.py (a path, as JAX's server takes its exported graph,
mds_tpu/deploy/server.py:30-45) at the artifact's own input shape, run on
the device the artifact was exported for. A semaphore of `instances`
(default 2, the reference's Triton instance group) bounds how many
requests run the model at once, as JAX's server does (:29-39); any
exception from `infer` answers 400 with its message (:83-88).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple, Union

import numpy as np

from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.deploy.export import Exported, load_exported_obj


class InferenceServer:
    def __init__(self, model: Union[E2EModel, Exported, str],
                 input_hw: Optional[Tuple[int, int]] = None,
                 name: str = "bisenetv2", instances: int = 2):
        """`model`: an E2EModel serving (1, *input_hw, 3) frames, or an
        artifact (loaded, or its path) serving its own input shape."""
        if instances < 1:
            raise ValueError(f"instances must be >= 1, got {instances}")
        if isinstance(model, (str, os.PathLike)):
            model = load_exported_obj(os.fspath(model))
        if isinstance(model, Exported):
            if input_hw is not None and tuple(input_hw) != model.input_shape[1:3]:
                raise ValueError(f"the artifact serves {model.input_shape}, not "
                                 f"{tuple(input_hw)}")
            self.in_shape = model.input_shape
        elif input_hw is None:
            raise ValueError("input_hw is needed to serve a model")
        else:
            self.in_shape = (1, int(input_hw[0]), int(input_hw[1]), 3)
        self.model = model
        self.name = name
        self.sem = threading.Semaphore(instances)

    def infer(self, raw: bytes) -> np.ndarray:
        n = int(np.prod(self.in_shape))
        if len(raw) != n:
            raise ValueError(f"expected {n} bytes for {self.in_shape}, got {len(raw)}")
        im = np.frombuffer(raw, np.uint8).reshape(self.in_shape)
        with self.sem:
            return self.model.infer(im)

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes = b"", headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/v2/health"):
                    self._reply(200, b"READY")
                elif self.path.startswith(f"/v2/models/{server_self.name}"):
                    meta = {
                        "name": server_self.name,
                        "inputs": [{"name": "input_image",
                                    "shape": list(server_self.in_shape),
                                    "datatype": "UINT8"}],
                        "outputs": [{"name": "preds", "datatype": "INT32"}],
                    }
                    self._reply(200, json.dumps(meta).encode(),
                                [("Content-Type", "application/json")])
                else:
                    self._reply(404)

            def do_POST(self):
                if not self.path.startswith(f"/v2/models/{server_self.name}/infer"):
                    self._reply(404)
                    return
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                try:
                    out = server_self.infer(raw)
                except Exception as e:  # wrong size, or the model failed
                    self._reply(400, str(e).encode())
                    return
                self._reply(200, out.tobytes(),
                            [("Content-Type", "application/octet-stream"),
                             ("X-Shape", json.dumps(list(out.shape)))])

        return Handler

    def serve(self, port: int = 8000, host: str = "0.0.0.0") -> None:
        with ThreadingHTTPServer((host, port), self.make_handler()) as httpd:
            httpd.serve_forever()

    def serve_background(self, port: int = 0,
                         host: str = "127.0.0.1") -> ThreadingHTTPServer:
        """Serve from a daemon thread; port 0 picks a free port
        (`httpd.server_address[1]`). Stop with shutdown() + server_close()."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
