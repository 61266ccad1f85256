"""HTTP inference service for the port — counterpart of
mds_tpu/deploy/server.py, with the same raw-tensor protocol:

  POST /v2/models/<name>/infer
    body  = raw uint8 NHWC bytes of shape (1, H, W, 3)
    reply = raw int32 label-map bytes, shape in the X-Shape header
  GET /v2/health/ready → 200
  GET /v2/models/<name> → JSON metadata

It wraps an E2EModel instead of an exported graph. A semaphore of
`instances` (default 2, the reference's Triton instance group) bounds how
many requests run the model at once, as JAX's server does
(mds_tpu/deploy/server.py:29-39); any exception from `infer` answers 400
with its message (:83-88).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np

from mds_tpu_torch.deploy.e2e import E2EModel


class InferenceServer:
    def __init__(self, model: E2EModel, input_hw: Tuple[int, int],
                 name: str = "bisenetv2", instances: int = 2):
        if instances < 1:
            raise ValueError(f"instances must be >= 1, got {instances}")
        self.model = model
        self.in_shape = (1, int(input_hw[0]), int(input_hw[1]), 3)
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
