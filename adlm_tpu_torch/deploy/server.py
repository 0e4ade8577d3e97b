"""HTTP inference server over an exported ``.pt2`` artifact
(counterpart of ``adlm_tpu.deploy.server``).

The reference has no serving story (its eval scripts rebuild the torch
model per run, reference segmentation/eval_valid.py:64-101); this
completes the deployment path that ``deploy/export.py`` starts: a
process that loads ONE artifact (weights inside, no model code or
checkpoint directory) and serves it over HTTP.

* **Micro-batching.** The artifact's shapes are static at its batch B.
  Requests are queued and coalesced into that batch within a
  ``window_ms`` deadline; the tail is padded with zeros and the pad rows
  never leave the server.
* **Pipelined dispatch.** Each batch is written into a pinned host
  buffer and uploaded with a ``non_blocking`` copy; the outputs are
  copied back into pinned memory behind an event
  (``core/device.py::to_host_async``).  Batch n + 1 is queued on the
  card before batch n's outputs are read, so the host's work overlaps
  the device's.  All CUDA work runs on the batcher's one thread.
* **Precision.** The loaded call runs under ``ieee_f32``
  (``load_inference_artifact``), so a float32 artifact serves the
  eval's IEEE f32 numbers, not TF32 ones.
* Payloads are raw ``.npy`` bytes (``allow_pickle`` stays off),
  responses ``.npz`` of the requested outputs.

Endpoints:

* ``GET /healthz``: liveness and serving counters (requests, batches,
  mean batch fill);
* ``GET /metrics``: the same counters in Prometheus text format;
* ``GET /manifest``: the artifact manifest;
* ``POST /predict[?outputs=pred,nearest_proto]``: body one ``.npy``
  array, a single item ``input_shape[1:]`` or a batch ``(N,
  *input_shape[1:])`` with ``N ≤ B``; response ``.npz`` with the
  selected outputs sliced to N.

CLI: ``python -m adlm_tpu_torch.cli serve <artifact_dir> [--port ...]``.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from adlm_tpu_torch.core.device import host_numpy, resolve_device, to_host_async
from adlm_tpu_torch.deploy.export import load_inference_artifact


class _Pending:
    """One queued request of ``n`` rows; ``event`` fires when ``result``
    holds its slice of the outputs (or ``error`` is set)."""

    __slots__ = ("array", "n", "event", "result", "error")

    def __init__(self, array: np.ndarray):
        self.array = array
        self.n = array.shape[0]
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesces single and partial-batch requests into the artifact's
    fixed batch and runs them through ``call`` on a worker thread.

    ``submit`` blocks the calling (request-handler) thread until its
    rows come back; the worker collects requests for at most
    ``window_ms`` after the first arrival (or until the batch is full),
    pads the tail with zeros and dispatches.  ``call(images)`` takes the
    host batch (pinned on the card) and returns device tensors.
    """

    def __init__(self, call, batch: int, item_shape: Tuple[int, ...], dtype: Any,
                 window_ms: float = 5.0, device: Any = None):
        self._call = call
        self.batch = int(batch)
        self.item_shape = tuple(item_shape)
        self.dtype = np.dtype(dtype)
        self.window_s = float(window_ms) / 1000.0
        pin = resolve_device(device).type == "cuda"
        tdt = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        # two staging buffers, used in turn: a buffer is written again
        # two dispatches later, when the batch that read it has been
        # fetched (``_run`` holds at most one batch in flight), so its
        # upload has ended
        self._staging = [torch.empty((self.batch,) + self.item_shape, dtype=tdt,
                                     pin_memory=pin) for _ in range(2)]
        self._queue: List[_Pending] = []
        self._lock = threading.Condition()
        self._closed = False
        # serving counters (exposed via /healthz and /metrics)
        self.n_requests = 0
        self.n_items = 0
        self.n_batches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, array: np.ndarray,
               timeout: Optional[float] = 60.0) -> Dict[str, np.ndarray]:
        if array.shape[1:] != self.item_shape:
            raise ValueError(f"item shape {array.shape[1:]} != artifact item shape "
                             f"{self.item_shape}")
        if array.shape[0] > self.batch:
            raise ValueError(f"request rows {array.shape[0]} > artifact batch "
                             f"{self.batch}; split the request")
        if array.dtype != self.dtype:
            raise ValueError(f"dtype {array.dtype} != artifact dtype {self.dtype}")
        p = _Pending(np.ascontiguousarray(array))
        with self._lock:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self._queue.append(p)
            self.n_requests += 1
            self.n_items += p.n
            self._lock.notify()
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=30)

    # -- worker -----------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """Wait for work, then collect up to ``batch`` rows within the
        coalescing window."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if self._closed and not self._queue:
                return []
            taken: List[_Pending] = []
            rows = 0
            deadline = time.monotonic() + self.window_s
            while True:
                while self._queue and rows + self._queue[0].n <= self.batch:
                    p = self._queue.pop(0)
                    taken.append(p)
                    rows += p.n
                if rows >= self.batch or self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            return taken

    def _dispatch(self, taken: List[_Pending], staging: torch.Tensor):
        """Fill ``staging`` (zeros after the last row), run the call and
        start copying its outputs to the host."""
        x = staging.numpy()
        rows = 0
        for p in taken:
            x[rows:rows + p.n] = p.array
            rows += p.n
        x[rows:] = 0
        out = self._call(staging)
        names = list(out)
        return names, to_host_async([out[k] for k in names])

    def _run(self):
        inflight = None
        dispatched = 0
        while True:
            taken = self._take_batch()
            if not taken:
                if inflight is not None:
                    self._finish(*inflight)
                return  # closed and drained
            # queue this batch BEFORE fetching the previous one: the
            # device's work overlaps the host's (pipelining)
            enqueued = None
            try:
                enqueued = (taken, *self._dispatch(taken, self._staging[dispatched % 2]))
                self.n_batches += 1
            except Exception as e:  # noqa: BLE001 - reported to each caller
                self._fail(taken, e)
            dispatched += 1
            if inflight is not None:
                self._finish(*inflight)
                inflight = None
            if enqueued is None:
                continue
            # hold the new batch in flight ONLY if more work is already
            # queued (its fetch then overlaps the next dispatch);
            # otherwise fetch now so a lone request never waits for a
            # successor to arrive
            with self._lock:
                more = bool(self._queue)
            if more:
                inflight = enqueued
            else:
                self._finish(*enqueued)

    @staticmethod
    def _fail(taken: List[_Pending], e: BaseException) -> None:
        for p in taken:
            p.error = e
            p.event.set()

    def _finish(self, taken: List[_Pending], names: List[str], copies) -> None:
        try:
            host = dict(zip(names, host_numpy(copies)))
        except Exception as e:  # noqa: BLE001 - reported to each caller
            self._fail(taken, e)
            return
        rows = 0
        for p in taken:
            p.result = {k: v[rows:rows + p.n] for k, v in host.items()}
            rows += p.n
            p.event.set()


class InferenceServer:
    """ThreadingHTTPServer around a loaded artifact and a MicroBatcher.
    ``platform`` is the device to serve on (default the card)."""

    def __init__(self, artifact_dir: str, port: int = 0, host: str = "127.0.0.1",
                 platform: Optional[str] = None, window_ms: float = 5.0):
        call, manifest = load_inference_artifact(artifact_dir, platform)
        self.manifest = manifest
        shape = manifest["input"]["shape"]
        self.batcher = MicroBatcher(
            call, batch=shape[0], item_shape=tuple(shape[1:]),
            dtype=manifest["input"]["dtype"], window_ms=window_ms, device=platform)
        self.known_outputs = list(manifest["outputs"])
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_forever(self):
        self._httpd.serve_forever()

    def start(self):
        """Serve from a background thread (tests, embedding)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                b = server.batcher
                fill = b.n_items / (b.n_batches * b.batch) if b.n_batches else None
                if self.path.startswith("/healthz"):
                    self._send_json(200, {
                        "status": "ok", "batch": b.batch, "requests": b.n_requests,
                        "batches": b.n_batches, "mean_batch_fill": fill})
                elif self.path.startswith("/metrics"):
                    body = (
                        "# TYPE adlm_requests_total counter\n"
                        f"adlm_requests_total {b.n_requests}\n"
                        "# TYPE adlm_items_total counter\n"
                        f"adlm_items_total {b.n_items}\n"
                        "# TYPE adlm_batches_total counter\n"
                        f"adlm_batches_total {b.n_batches}\n"
                        "# TYPE adlm_batch_size gauge\n"
                        f"adlm_batch_size {b.batch}\n"
                        "# TYPE adlm_mean_batch_fill gauge\n"
                        f"adlm_mean_batch_fill {fill or 0.0:.6f}\n")
                    self._send(200, body.encode(), ctype="text/plain; version=0.0.4")
                elif self.path.startswith("/manifest"):
                    self._send_json(200, server.manifest)
                else:
                    self._send_json(404, {"error": "unknown path"})

            def do_POST(self):
                if not self.path.startswith("/predict"):
                    self._send_json(404, {"error": "unknown path"})
                    return
                outputs = None
                q = parse_qs(urlparse(self.path).query)
                if "outputs" in q:
                    outputs = q["outputs"][0].split(",")
                    bad = set(outputs) - set(server.known_outputs)
                    if bad:
                        self._send_json(400, {"error": f"unknown outputs {sorted(bad)}",
                                              "available": server.known_outputs})
                        return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                except (ValueError, OSError, EOFError) as e:
                    self._send_json(400, {"error": f"bad .npy body: {e}"})
                    return
                b = server.batcher
                single = arr.shape == b.item_shape
                if single:
                    arr = arr[None]
                try:
                    res = b.submit(arr)
                except (ValueError, TimeoutError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                except RuntimeError as e:
                    self._send_json(503, {"error": str(e)})
                    return
                if outputs is not None:
                    res = {k: res[k] for k in outputs}
                if single:
                    res = {k: v[0] for k, v in res.items()}
                buf = io.BytesIO()
                np.savez(buf, **res)
                self._send(200, buf.getvalue(), ctype="application/x-npz")

        return Handler
