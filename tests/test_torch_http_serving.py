"""The port's HTTP front end (guided_vae_nmf_torch/http_serving.py) on the
CPU, mirroring the non-stream tests of tests/test_http_serving.py: a real
client (urllib) on an ephemeral port drives POST /v1/enhance against a
live EnhancementService, plus /healthz, /stats, /metrics and the rejection
paths; the stream route answers 501 on a server without a stream factory
(tests/test_torch_http_stream.py serves it); a failed batch (a kernel that
does not build or launch) answers 500 with its message, a closed service
503; and `build_server` serves the shipped weights."""

import concurrent.futures as cf
import io
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import guided_vae_nmf_torch.serving as serving
from guided_vae_nmf_tpu.models import vae_init
from guided_vae_nmf_torch._build import KernelError
from guided_vae_nmf_torch.data.wav import read_wav, write_wav
from guided_vae_nmf_torch.http_serving import (
    EnhancementHTTPServer,
    build_server,
    main,
)
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig

torch.set_num_threads(2)

F, L, H = 513, 8, 16
CFG = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=2)
SV = ServeConfig(label_mode="none", noise_model="nmf", max_wait_ms=20.0)
MODELS = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "pretrained")


def _m1(seed=0):
    return module_from_params(vae_init(jax.random.PRNGKey(seed), [F, L, [H]]))


def _stack(serve=SV):
    svc = EnhancementService(_m1(), cfg=CFG, serve=serve, device="cpu")
    return svc, EnhancementHTTPServer(svc, port=0).start()


@pytest.fixture(scope="module")
def server():
    svc, srv = _stack()
    yield srv
    srv.close_all()


def _wav_bytes(x, fs=16000):
    buf = io.BytesIO()
    write_wav(buf, x, fs)
    return buf.getvalue()


def _post(srv, body, path="/v1/enhance"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers={"Content-Type": "audio/wav"})
    return urllib.request.urlopen(req, timeout=300)


def _code_and_body(srv, body=b"", path="/v1/enhance", method="POST"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=body if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_enhance_roundtrip(server):
    x = (0.1 * np.random.RandomState(0).randn(8000)).astype(np.float32)
    resp = _post(server, _wav_bytes(x))
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "audio/wav"
    assert float(resp.headers["X-Latency-S"]) > 0
    assert int(resp.headers["X-Batch-Size"]) >= 1
    s, fs = read_wav(io.BytesIO(resp.read()))
    assert fs == 16000 and s.shape == x.shape and np.all(np.isfinite(s))

    n, _ = read_wav(io.BytesIO(
        _post(server, _wav_bytes(x), "/v1/enhance?track=noise").read()))
    assert n.shape == x.shape and np.all(np.isfinite(n))

    # track=both: one run's Wiener partition; s + n is the PCM16 body
    sn, _ = read_wav(io.BytesIO(
        _post(server, _wav_bytes(x), "/v1/enhance?track=both").read()))
    assert sn.shape == (len(x), 2)
    xq = np.round(x * 32768.0) / 32768.0
    np.testing.assert_allclose(sn.sum(axis=1), xq, atol=4.0 / 32768.0)


def test_healthz_and_stats(server):
    _post(server, _wav_bytes(np.zeros(4000, np.float32) + 0.01)).read()
    code, body = _code_and_body(server, path="/healthz", method="GET")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, body = _code_and_body(server, path="/stats", method="GET")
    st = json.loads(body)
    assert code == 200 and st["requests"] >= 1 and st["batches"] >= 1


def test_metrics_prometheus_endpoint(server):
    _post(server, _wav_bytes(np.zeros(4000, np.float32) + 0.01)).read()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    assert "# TYPE gvnmf_requests_total counter" in body
    assert 'gvnmf_request_latency_seconds{quantile="0.95"}' in body


def test_rejections(server):
    assert _code_and_body(server, b"")[0] == 400          # empty body
    assert _code_and_body(server, b"not a wav at all" * 4)[0] == 400
    assert _code_and_body(server, _wav_bytes(np.zeros(100), fs=8000))[0] \
        == 400                                           # wrong rate
    assert _code_and_body(server, _wav_bytes(np.ones(100)),
                          "/v1/enhance?track=x")[0] == 400
    assert _code_and_body(server, _wav_bytes(np.ones(100)),
                          "/v1/other")[0] == 404
    assert _code_and_body(server, path="/nope", method="GET")[0] == 404


def test_stream_route_answers_501(server):
    code, body = _code_and_body(server, b"\x00\x00" * 100,
                                "/v1/enhance_stream")
    assert code == 501 and "stream" in json.loads(body)["error"]


def test_multichannel_takes_first_channel(server):
    stereo = (0.1 * np.random.RandomState(1).randn(6000, 2)).astype(
        np.float32)
    s, _ = read_wav(io.BytesIO(_post(server, _wav_bytes(stereo)).read()))
    assert s.shape == (6000,)


def test_concurrent_clients_cobatch(server):
    rng = np.random.RandomState(2)
    bodies = [_wav_bytes((0.1 * rng.randn(8000)).astype(np.float32))
              for _ in range(6)]
    with cf.ThreadPoolExecutor(6) as pool:
        resps = list(pool.map(lambda b: _post(server, b), bodies))
    sizes = [int(r.headers["X-Batch-Size"]) for r in resps]
    for r in resps:
        assert r.status == 200
        r.read()
    assert max(sizes) >= 2              # at least one shared batch


def test_http_429_on_queue_full():
    svc, srv = _stack(ServeConfig(label_mode="none", noise_model="nmf",
                                  max_wait_ms=2000.0, max_queue=1))
    try:
        rng = np.random.RandomState(3)
        bodies = [_wav_bytes((0.1 * rng.randn(5000)).astype(np.float32))
                  for _ in range(12)]
        with cf.ThreadPoolExecutor(12) as pool:
            codes = [c for c, _ in pool.map(
                lambda b: _code_and_body(srv, b), bodies)]
        assert 429 in codes and 200 in codes, codes
    finally:
        srv.close_all()


def test_kernel_error_answers_500_and_closed_service_503(monkeypatch):
    """A KernelError (a RuntimeError) is a server fault: 500 with its
    message, not the 503 of a closed service."""
    def broken(*a, **kw):
        raise KernelError("mh_chain kernel: CUDA error 700")

    monkeypatch.setattr(serving, "enhance_waveform", broken)
    svc, srv = _stack()
    try:
        body = _wav_bytes(np.zeros(4000, np.float32) + 0.01)
        code, text = _code_and_body(srv, body)
        assert code == 500
        assert "KernelError" in json.loads(text)["error"]
        assert "CUDA error 700" in json.loads(text)["error"]
        svc.close()
        code, text = _code_and_body(srv, body)
        assert code == 503 and "closed" in json.loads(text)["error"]
    finally:
        srv.close_all()


def test_build_server_serves_the_shipped_weights():
    srv = build_server(MODELS, port=0, niter=1, device="cpu").start()
    try:
        x = (0.1 * np.random.RandomState(4).randn(6000)).astype(np.float32)
        resp = _post(srv, _wav_bytes(x))
        s, _ = read_wav(io.BytesIO(resp.read()))
        assert resp.status == 200 and s.shape == x.shape
        assert np.all(np.isfinite(s))
    finally:
        srv.close_all()


@pytest.mark.parametrize("kw", [dict(data_parallel=True)])
def test_build_server_refuses_what_is_not_ported(kw, monkeypatch):
    # data_parallel is ported; its mesh of every card raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_server(MODELS, port=0, **kw)


def test_main_takes_the_stream_flags(monkeypatch):
    """`--stream` (on by default), `--pooled_streams`, `--chunk_frames`,
    `--stream_residual`, `--max_streams` and `--tick_ms` reach
    build_server."""
    import guided_vae_nmf_torch.http_serving as hs

    seen = {}

    class Stop(Exception):
        pass

    def fake_build(models, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(hs, "build_server", fake_build)
    with pytest.raises(Stop):
        main(["--models", MODELS, "--device", "cpu", "--stream", "1",
              "--pooled_streams", "1", "--chunk_frames", "4",
              "--stream_residual", "1", "--max_streams", "3",
              "--tick_ms", "2.5"])
    assert {k: seen[k] for k in ("stream", "pooled_streams", "chunk_frames",
                                 "stream_residual", "max_streams",
                                 "tick_ms")} == dict(
        stream=True, pooled_streams=True, chunk_frames=4,
        stream_residual=True, max_streams=3, tick_ms=2.5)
    with pytest.raises(Stop):
        main(["--models", MODELS, "--device", "cpu"])
    assert seen["stream"] is True and seen["pooled_streams"] is False
    with pytest.raises(SystemExit):
        main(["--fast", "2"])
