"""The port's HTTP stream route (`POST /v1/enhance_stream` in
guided_vae_nmf_torch/http_serving.py) on the CPU, mirroring the stream
tests of tests/test_http_serving.py: Content-Length and chunked bodies
(odd-byte PCM16 boundaries), full duplex, 411 / 413 / 429, malformed or
truncated framing cut as aborted, the `streams` block of /stats and the
stream counters of /metrics, pooled sessions against dedicated streams,
and `build_server(stream=True)` serving the shipped weights (dedicated,
pooled, and under a streaming profile). A stream's PCM16 is held within
1 LSB of the same enhancer driven directly: the socket splits the body
where it likes, chunk boundaries follow the pushes, and with chunks of
more than 4 frames the overlap-add's float32 summation order follows the
chunk boundaries (in the JAX package too)."""

import http.client
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import guided_vae_nmf_torch.http_serving as hs
from guided_vae_nmf_tpu.models import dgm_init, vae_init
from guided_vae_nmf_torch.http_serving import EnhancementHTTPServer
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig
from guided_vae_nmf_torch.streaming import (
    MultiStreamM2Enhancer,
    PooledStreamSession,
    StreamingM2Enhancer,
    StreamingSPPEnhancer,
    StreamPoolDriver,
)
from guided_vae_nmf_torch.train import load_model

torch.set_num_threads(2)

F, L, H = 513, 8, 16
CFG = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1, nsamples_WF=2,
                 burnin_WF=1, nmf_rank=2)
SV = ServeConfig(label_mode="none", noise_model="nmf", max_wait_ms=20.0)
MODELS = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "pretrained")


def _svc():
    m1 = module_from_params(vae_init(jax.random.PRNGKey(0), [F, L, [H]]))
    return EnhancementService(m1, cfg=CFG, serve=SV, device="cpu")


def _spp():
    return StreamingSPPEnhancer(chunk_frames=8, device="cpu")


@pytest.fixture
def spp_server():
    svc = _svc()
    srv = EnhancementHTTPServer(svc, port=0, stream_factory=_spp).start()
    yield srv
    srv.close_all()


def _pcm16(x):
    return np.clip(np.round(np.asarray(x) * 32768.0),
                   -32768, 32767).astype("<i2").tobytes()


def _direct(enh, x):
    """The enhancer driven directly on the PCM16-quantized input."""
    xq = np.frombuffer(_pcm16(x), "<i2").astype(np.float32) / 32768.0
    return b"".join(_pcm16(o) for o in (enh.push(xq), enh.flush()) if o.size)


def _within_1_lsb(body, want):
    a = np.frombuffer(body, "<i2").astype(np.int32)
    b = np.frombuffer(want, "<i2").astype(np.int32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1


def _post_stream(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/enhance_stream", data=body,
        headers={"Content-Type": "audio/L16"})
    return urllib.request.urlopen(req, timeout=300)


def _stats(srv):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
        return json.loads(r.read())


def _raw_stream_post(port, payload_after_headers):
    """Open the stream route with chunked framing, send raw bytes, and
    return what the server sends until it closes or 3 s of silence."""
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        s.sendall(b"POST /v1/enhance_stream HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: audio/L16\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n")
        s.sendall(payload_after_headers)
        s.settimeout(3)
        got = b""
        try:
            while True:
                blk = s.recv(65536)
                if not blk:
                    break
                got += blk
        except TimeoutError:
            pass
        return got
    finally:
        s.close()


def _quiesced(srv, deadline_s=30):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        st = _stats(srv)["streams"]
        if st.get("active", 0) == 0 and st.get("started", 0) > 0:
            return st
        time.sleep(0.1)
    raise AssertionError(f"stream never quiesced: {st}")


def test_content_length_roundtrip(spp_server):
    x = (0.1 * np.random.RandomState(1).randn(9000)).astype(np.float32)
    with _post_stream(spp_server.port, _pcm16(x)) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("audio/L16")
        assert resp.headers.get("X-Chunk-Frames") == "8"
        body = resp.read()
    _within_1_lsb(body, _direct(_spp(), x))
    assert len(body) == 2 * len(x)


def test_chunked_request_odd_boundaries(spp_server):
    x = (0.1 * np.random.RandomState(2).randn(7001)).astype(np.float32)
    pcm = _pcm16(x)
    cuts = [0, 333, 334, 4097, 9000, len(pcm)]     # odd-sized chunks
    conn = http.client.HTTPConnection("127.0.0.1", spp_server.port,
                                      timeout=300)
    conn.request("POST", "/v1/enhance_stream",
                 body=iter([pcm[a:b] for a, b in zip(cuts, cuts[1:])]),
                 headers={"Content-Type": "audio/L16",
                          "Transfer-Encoding": "chunked"},
                 encode_chunked=True)
    resp = conn.getresponse()
    assert resp.status == 200
    body = resp.read()
    conn.close()
    _within_1_lsb(body, _direct(_spp(), x))


def test_full_duplex(spp_server):
    """Enhanced samples arrive before the request body ends."""
    x = (0.1 * np.random.RandomState(3).randn(16000)).astype(np.float32)
    pcm = _pcm16(x)
    first, rest = pcm[:12000], pcm[12000:]
    s = socket.create_connection(("127.0.0.1", spp_server.port), timeout=120)
    try:
        s.sendall(b"POST /v1/enhance_stream HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n"
                  b"Content-Type: audio/L16\r\n\r\n")
        s.sendall(f"{len(first):x}\r\n".encode() + first + b"\r\n")
        got = b""
        while b"\r\n\r\n" not in got:
            got += s.recv(65536)
        head, tail = got.split(b"\r\n\r\n", 1)
        assert b"200" in head.split(b"\r\n", 1)[0]
        while b"\r\n" not in tail:
            tail += s.recv(65536)
        assert int(tail.split(b"\r\n", 1)[0], 16) > 0
        s.sendall(f"{len(rest):x}\r\n".encode() + rest + b"\r\n0\r\n\r\n")
        while not tail.endswith(b"0\r\n\r\n"):
            blk = s.recv(65536)
            if not blk:
                break
            tail += blk
    finally:
        s.close()
    payload = b""
    while tail:
        line, tail = tail.split(b"\r\n", 1)
        n = int(line or b"0", 16)
        if n == 0:
            break
        payload, tail = payload + tail[:n], tail[n + 2:]
    _within_1_lsb(payload, _direct(_spp(), x))


def test_length_errors_411_413_and_empty(spp_server, monkeypatch):
    def code(headers, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", spp_server.port,
                                          timeout=60)
        conn.putrequest("POST", "/v1/enhance_stream")
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        c = conn.getresponse().status
        conn.close()
        return c

    assert code({}) == 411                        # no framing at all
    assert code({"Content-Length": "0"}) == 400   # empty body
    # a small cap; the drain limit below it, as the real ones stand
    monkeypatch.setattr(hs, "_MAX_BODY", 100)
    monkeypatch.setattr(hs._Handler, "_DRAIN_LIMIT", 50)
    assert code({"Content-Length": "1000"}, b"\x00" * 10) == 413


def test_capacity_429_and_stats():
    svc = _svc()
    srv = EnhancementHTTPServer(svc, port=0, max_streams=1,
                                stream_factory=_spp).start()
    try:
        hold = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        hold.sendall(b"POST /v1/enhance_stream HTTP/1.1\r\nHost: x\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        hold.sendall(b"400\r\n" + b"\x01\x00" * 512 + b"\r\n")
        got = b""
        while b"\r\n\r\n" not in got:
            got += hold.recv(65536)
        assert b"200" in got.split(b"\r\n", 1)[0]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_stream(srv.port, b"\x01\x00" * 256)
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") == "1"
        st = _stats(srv)["streams"]
        assert st["active"] == 1 and st["started"] == 1
        hold.sendall(b"0\r\n\r\n")
        while not got.endswith(b"0\r\n\r\n"):
            blk = hold.recv(65536)
            if not blk:
                break
            got += blk
        hold.close()
        st = _quiesced(srv)
        assert st["done"] == 1 and st["samples_in"] == 512
    finally:
        srv.close_all()


@pytest.mark.parametrize("payload", [
    b"400\r\n" + b"\x01\x00" * 512 + b"\r\nzzzz\r\n",       # garbage size
    b"400;ext=" + b"a" * 9000 + b"\r\n" + b"\x01\x00" * 512 + b"\r\n",
    b"400\r\n" + b"\x01\x00" * 256,                          # EOF in payload
    b"-8\r\n" + b"\x01\x00" * 512 + b"\r\n",                 # negative size
], ids=["garbage-size", "oversize-line", "truncated", "negative-size"])
def test_bad_framing_aborts_not_done(spp_server, payload):
    got = _raw_stream_post(spp_server.port, payload)
    assert not got.endswith(b"0\r\n\r\n")         # never cleanly ended
    st = _quiesced(spp_server)
    assert st["aborted"] == 1 and st.get("done", 0) == 0


def test_enhancer_failure_mid_stream_truncates(monkeypatch):
    class Broken:
        chunk_frames = 8

        def push(self, x):
            raise RuntimeError("device lost")

        def flush(self):
            return np.zeros(0, np.float32)

    svc = _svc()
    srv = EnhancementHTTPServer(svc, port=0, stream_factory=Broken).start()
    try:
        got = _raw_stream_post(srv.port, b"400\r\n" + b"\x01\x00" * 512
                               + b"\r\n0\r\n\r\n")
        assert b"200" in got.split(b"\r\n", 1)[0]
        assert not got.endswith(b"0\r\n\r\n")
        st = _quiesced(srv)
        assert st["aborted"] == 1
    finally:
        srv.close_all()


def test_empty_stream_and_metrics(spp_server):
    got = _raw_stream_post(spp_server.port, b"0\r\n\r\n")
    assert b"200" in got.split(b"\r\n", 1)[0] and got.endswith(b"0\r\n\r\n")
    st = _quiesced(spp_server)
    assert st["done"] == 1 and st.get("aborted", 0) == 0
    with urllib.request.urlopen(
            f"http://127.0.0.1:{spp_server.port}/metrics", timeout=60) as r:
        body = r.read().decode()
    assert "gvnmf_streams_started_total 1" in body
    assert "gvnmf_streams_done_total 1" in body
    assert "gvnmf_streams_active 0" in body
    assert "gvnmf_stream_samples_in_total 0" in body


def test_pooled_sessions_match_dedicated_streams():
    m2 = module_from_params(dgm_init(jax.random.PRNGKey(0),
                                     [F, F, 8, [32]]))
    kw = dict(label_mode="timo", soft_guidance=True, chunk_frames=4,
              context_frames=8, block_iters=2, e_steps=2, device="cpu")
    driver = StreamPoolDriver(MultiStreamM2Enhancer(m2, max_streams=2, **kw),
                              tick_ms=2.0)
    svc = _svc()
    srv = EnhancementHTTPServer(
        svc, port=0, max_streams=2,
        stream_factory=lambda: PooledStreamSession(driver)).start()
    srv._stream_driver = driver
    xs = [(0.1 * np.random.RandomState(10 + i).randn(n)).astype(np.float32)
          for i, n in enumerate((9000, 13000))]
    got, errors = {}, []

    def client(i):
        try:
            with _post_stream(srv.port, _pcm16(xs[i])) as r:
                got[i] = np.frombuffer(r.read(), "<i2").astype(np.int32)
        except Exception as e:          # reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors
        for i, x in enumerate(xs):
            want = np.frombuffer(_direct(StreamingM2Enhancer(m2, **kw), x),
                                 "<i2").astype(np.int32)
            assert len(got[i]) == len(x)
            assert np.abs(got[i] - want).max() <= 1
        assert _quiesced(srv)["done"] == 2
        assert not driver._pool._slots            # every slot released
    finally:
        srv.close_all()
    assert not driver._thread.is_alive()          # close_all stopped it


def _shipped_stream(srv, x):
    with _post_stream(srv.port, _pcm16(x)) as r:
        return r.headers["X-Chunk-Frames"], np.frombuffer(r.read(), "<i2")


def test_build_server_streams_the_shipped_weights():
    """build_server(stream=True) on the CPU: the stream equals a
    StreamingM2Enhancer with the shipped weights driven directly, and
    /stats counts it."""
    srv = hs.build_server(MODELS, port=0, niter=1, device="cpu").start()
    try:
        x = (0.1 * np.random.RandomState(4).randn(8000)).astype(np.float32)
        chunk, y = _shipped_stream(srv, x)
        assert chunk == "8" and len(y) == len(x)
        m2 = load_model(os.path.join(MODELS, "M2_ibm"), kind="dgm",
                        device="cpu")
        cdir = os.path.join(MODELS, "classifier_ibm")
        cls = load_model(cdir, kind="classifier", device="cpu")
        mean, std = (np.load(os.path.join(cdir, f"trainset_{n}.npy"))
                     for n in ("mean", "std"))
        enh = StreamingM2Enhancer(m2, classifier=cls, mean=mean, std=std,
                                  keep_masks=False, device="cpu")
        want = np.frombuffer(_direct(enh, x), "<i2")
        assert np.abs(y.astype(np.int32) - want).max() <= 1
        assert _quiesced(srv)["done"] == 1
    finally:
        srv.close_all()


@pytest.mark.parametrize("kw, chunk", [
    (dict(pooled_streams=True, max_streams=2, tick_ms=1.0), "8"),
    (dict(profile="streaming-low-latency"), "4"),
    (dict(profile="streaming-192ms", pooled_streams=True), "8"),
    (dict(chunk_frames=4, stream_residual=True), "4"),
])
def test_build_server_stream_options(kw, chunk):
    srv = hs.build_server(MODELS, port=0, niter=1, device="cpu",
                          **kw).start()
    try:
        x = (0.1 * np.random.RandomState(5).randn(6000)).astype(np.float32)
        got_chunk, y = _shipped_stream(srv, x)
        assert got_chunk == chunk and len(y) == len(x)
    finally:
        srv.close_all()
    if srv._stream_driver is not None:
        assert not srv._stream_driver._thread.is_alive()


def test_build_server_stream_off_answers_501():
    srv = hs.build_server(MODELS, port=0, niter=1, device="cpu",
                          stream=False).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_stream(srv.port, b"\x00\x00" * 100)
        assert ei.value.code == 501
    finally:
        srv.close_all()
