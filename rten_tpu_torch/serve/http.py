"""HTTP/JSON serving API over a continuous-batching engine.

Counterpart of ``rten_tpu/serve/http.py`` (``ServingServer`` :26), with the
same routes and JSON keys (standard library only, ``ThreadingHTTPServer``):

    POST /generate  {"prompt": [ids...], "max_new_tokens": N, "eos": [ids]}
                    → {"request_id": i, "tokens": [ids...], "finished": bool}
    GET  /healthz   → {"status": "ok", "active": n, "queued": n, "steps": n}
    GET  /stats     → {"steps": n, "max_batch": n, "max_len": n}

A background thread drives ``engine.step()`` under the server's lock
whenever there is work, so concurrent requests batch into the same decode
steps. That thread sets the engine's CUDA device before its first step.
A reply waits at most 300 s; ``"finished"`` says whether the request ended.
Works over ``ServingEngine`` and ``PagedServingEngine`` (whose ``max_len``
in ``/stats`` is null).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from rten_tpu_torch.serve.engine import Request


class ServingServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._stepper = threading.Thread(target=self._drive, daemon=True)

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                eng = outer.engine
                if self.path == "/healthz":
                    with outer._lock:
                        self._reply(200, {"status": "ok", "active": eng.n_active,
                                          "queued": len(eng.queue), "steps": eng.steps})
                elif self.path == "/stats":
                    with outer._lock:
                        self._reply(200, {"steps": eng.steps, "max_batch": eng.max_batch,
                                          "max_len": getattr(eng, "max_len", None)})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    prompt = [int(t) for t in payload["prompt"]]
                    req = Request(prompt=prompt, max_new_tokens=int(payload.get("max_new_tokens", 32)),
                                  eos_tokens=tuple(int(t) for t in payload.get("eos", ())))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                done = threading.Event()
                req._done_event = done  # type: ignore[attr-defined]
                try:
                    with outer._lock:
                        outer.engine.submit(req)
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                outer._work.set()
                done.wait(timeout=300)
                self._reply(200, {"request_id": req.request_id, "tokens": list(req.output),
                                  "finished": req.finished})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> None:
        self._stepper.start()
        self._http_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._stepper.join(timeout=5)

    def _drive(self) -> None:
        device = getattr(self.engine, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            self._work.wait(timeout=0.1)
            did_work = False
            with self._lock:
                if self.engine.has_work():
                    finished = self.engine.step()
                    did_work = True
                    for req in finished:
                        ev = getattr(req, "_done_event", None)
                        if ev is not None:
                            ev.set()
            if not did_work:
                self._work.clear()
