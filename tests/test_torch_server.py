"""PyTorch port, the HTTP inference server (``adlm_tpu_torch.deploy.server``),
the four cases of ``tests/test_server.py``.

The serving contract: a process holding ONE fixed-batch artifact gives
per-request answers identical to calling the artifact directly:
micro-batch coalescing, tail padding, pipelined dispatch and the
single-item path are invisible to clients.  The artifact is a tiny
ProtoSeg program exported on the CPU, weights from the port's seeded
initializers (what it computes is held against the JAX package in
``test_torch_deploy.py``).
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.deploy import server as srv_mod
from adlm_tpu_torch.deploy.export import export_inference_artifact, load_inference_artifact
from adlm_tpu_torch.deploy.server import InferenceServer, MicroBatcher
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class

HW = 33
ITEM = (HW, HW, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = PPNetConfig(num_prototypes=6, num_classes=3, prototype_channels=8,
                      deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1), img_size=HW)
    model = PPNet(cfg, generator=torch.Generator().manual_seed(0))
    out = str(tmp_path_factory.mktemp("server") / "artifact")
    export_inference_artifact(model, default_proto_class(6, 3), out, batch=4, size=(HW, HW),
                              platforms=("cpu",), compute_dtype=torch.float32)
    call, manifest = load_inference_artifact(out, "cpu")
    return out, call, manifest


def _direct(call, x):
    """The artifact called once on ``x`` padded to its batch of 4."""
    pad = np.zeros((4 - len(x),) + ITEM, np.float32)
    return {k: v.numpy() for k, v in call(np.concatenate([x, pad])).items()}


def _post_npy(conn, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    conn.request("POST", path, body=buf.getvalue(),
                 headers={"Content-Type": "application/x-npy"})
    return conn.getresponse()


def _read_npz(resp):
    assert resp.status == 200, resp.read()
    return dict(np.load(io.BytesIO(resp.read())))


def test_microbatcher_splits_and_pads(artifact):
    """Requests of 1 and 2 rows coalesce into one padded batch-4 call and
    each caller gets exactly its own rows back."""
    _, call, _ = artifact
    x = np.random.RandomState(0).rand(3, *ITEM).astype(np.float32)
    b = MicroBatcher(call, batch=4, item_shape=ITEM, dtype="float32", window_ms=500.0,
                     device="cpu")
    results = {}

    def go(name, arr):
        results[name] = b.submit(arr)

    threads = [threading.Thread(target=go, args=("a", x[:1])),
               threading.Thread(target=go, args=("b", x[1:]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    b.close()
    assert not any(t.is_alive() for t in threads)
    assert b.n_batches == 1 and b.n_items == 3  # coalesced, not two calls
    # the rows' order in the batch follows the threads' race, which
    # changes nothing in a row's answer (eval mode: rows are independent)
    for name, rows in (("a", x[:1]), ("b", x[1:])):
        want = _direct(call, rows)
        assert set(results[name]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(results[name][k], v[:len(rows)], rtol=0, atol=1e-6)


def test_microbatcher_rejects_bad_requests(artifact):
    _, call, _ = artifact
    b = MicroBatcher(call, batch=4, item_shape=ITEM, dtype="float32", window_ms=1.0,
                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        b.submit(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="batch"):
        b.submit(np.zeros((5,) + ITEM, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        b.submit(np.zeros((1,) + ITEM, np.float64))
    b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(np.zeros((1,) + ITEM, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):  # the default device is the card
        MicroBatcher(call, batch=4, item_shape=ITEM, dtype="float32")


def test_http_server_end_to_end(artifact):
    """healthz, manifest, single-item and batch /predict, the outputs
    filter: responses equal the direct artifact call."""
    out, call, manifest = artifact
    server = InferenceServer(out, port=0, platform="cpu", window_ms=2.0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["batch"] == 4

        conn.request("GET", "/manifest")
        assert json.loads(conn.getresponse().read()) == manifest

        x = np.random.RandomState(1).rand(2, *ITEM).astype(np.float32)
        want = _direct(call, x)
        got = _read_npz(_post_npy(conn, "/predict", x))
        assert set(got) == {"pred", "grid_logits", "nearest_proto"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k][:2])

        # a single item drops the leading axis
        got1 = _read_npz(_post_npy(conn, "/predict?outputs=pred", x[0]))
        assert set(got1) == {"pred"}
        np.testing.assert_array_equal(got1["pred"], _direct(call, x[:1])["pred"][0])

        resp = _post_npy(conn, "/predict?outputs=nope", x[0])
        assert resp.status == 400
        assert "available" in json.loads(resp.read())

        conn.request("POST", "/predict", body=b"not an npy")
        assert conn.getresponse().status == 400

        resp = _post_npy(conn, "/predict", np.zeros((1, 32, 32, 3), np.float32))
        assert resp.status == 400
        assert "shape" in json.loads(resp.read())["error"]

        conn.request("GET", "/nowhere")
        assert conn.getresponse().status == 404

        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["requests"] >= 2 and health["batches"] >= 2

        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        metrics = {}
        for line in resp.read().decode().splitlines():
            if line and not line.startswith("#"):
                k, v = line.split()
                metrics[k] = float(v)
        assert metrics["adlm_requests_total"] == health["requests"]
        assert metrics["adlm_batches_total"] == health["batches"]
        assert metrics["adlm_batch_size"] == health["batch"]
    finally:
        server.close()


def test_serve_cli_wiring(tmp_path, monkeypatch):
    """``serve`` hands artifact_dir, port, host, platform and window to
    ``InferenceServer`` (the server loop itself is tested above); the
    platform defaults to the card."""
    from adlm_tpu_torch.cli import main as cli_main

    calls = []

    class Stub:
        def __init__(self, artifact_dir, port, host, platform, window_ms):
            calls.append(dict(artifact_dir=artifact_dir, port=port, host=host,
                              platform=platform, window_ms=window_ms))
            self.manifest = {"input": {"shape": [4, HW, HW, 3], "dtype": "float32"}}
            self.known_outputs = ["pred"]
            self.port = port

        def serve_forever(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(srv_mod, "InferenceServer", Stub)
    cli_main(["serve", str(tmp_path), "--port", "7001", "--window-ms", "3",
              "--platform", "cpu"])
    cli_main(["serve", str(tmp_path)])
    assert calls == [
        {"artifact_dir": str(tmp_path), "port": 7001, "host": "127.0.0.1",
         "platform": "cpu", "window_ms": 3.0},
        {"artifact_dir": str(tmp_path), "port": 8000, "host": "127.0.0.1",
         "platform": "cuda", "window_ms": 5.0}]
