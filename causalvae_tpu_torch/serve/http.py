"""Dependency-free HTTP front-end for the batching engine
(the port's own copy of ``causalvae_tpu/serve/http.py``).

Protocol (stdlib only):

    GET  /v1/health          -> {"status": "ok", "endpoints": [...], "stats": {...}}
    POST /v1/<endpoint>      body:  .npz with arrays  arg0, arg1, ...
                             reply: .npz with arrays  out0, out1, ...
                                    (flattened endpoint outputs)

Handler threads of a ``ThreadingHTTPServer`` all feed the single
``BatchingEngine`` worker, so simultaneous single-sample POSTs coalesce into
one padded device call.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from causalvae_tpu_torch.serve.engine import BatchingEngine


def encode_arrays(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"arg{i}": np.asarray(a) for i, a in enumerate(arrays)})
    return buf.getvalue()


def decode_arrays(data: bytes, prefix: str = "arg"):
    with np.load(io.BytesIO(data)) as z:
        names = sorted(
            (n for n in z.files if n.startswith(prefix)),
            key=lambda n: int(n[len(prefix):]),
        )
        return [z[n] for n in names]


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _encode_outputs(out) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"out{i}": np.asarray(x) for i, x in enumerate(_leaves(out))})
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    engine: BatchingEngine = None  # set by make_server
    server_version = "causalvae-serve/1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/v1/health":
            self._reply_json(200, {"status": "ok",
                                   "endpoints": self.engine.endpoint_names,
                                   "stats": dict(self.engine.stats)})
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if not self.path.startswith("/v1/"):
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        name = self.path[len("/v1/"):]
        try:
            n = int(self.headers.get("Content-Length", "0"))
            args = decode_arrays(self.rfile.read(n))
            out = self.engine.infer(name, *args)
            self._reply(200, _encode_outputs(out), "application/npz")
        except KeyError as e:
            self._reply_json(404, {"error": str(e)})
        except Exception as e:
            self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})


def make_server(engine: BatchingEngine, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); caller runs serve_forever/shutdown."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def serve(engine: BatchingEngine, host: str = "127.0.0.1", port: int = 8900,
          *, background: bool = False) -> ThreadingHTTPServer:
    """Start serving. background=True returns immediately; otherwise blocks
    until KeyboardInterrupt, then closes the server and the engine."""
    srv = make_server(engine, host, port)
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    try:
        print(f"serving on http://{srv.server_address[0]}:{srv.server_address[1]}/v1/…",
              flush=True)
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
    return srv


def request_npz(host: str, port: int, endpoint: str, arrays,
                timeout: Optional[float] = 60.0):
    """Minimal client: POST arrays to /v1/<endpoint>, return output arrays."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", f"/v1/{endpoint}", body=encode_arrays(arrays),
                     headers={"Content-Type": "application/npz"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:300]!r}")
        return decode_arrays(data, prefix="out")
    finally:
        conn.close()
