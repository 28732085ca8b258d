"""HTTP front end for the online enhancement service (stdlib only).

Counterpart of `guided_vae_nmf_tpu/http_serving.py`: a
`ThreadingHTTPServer` gives one thread per connection, each blocking on
:meth:`EnhancementService.enhance`, so concurrent requests co-batch onto
the card exactly as in-process callers do.

API:
  POST /v1/enhance      body = RIFF wav (16 kHz PCM16/float), response =
                        RIFF wav (PCM16) of the enhanced speech track.
                        `?track=noise` returns the noise estimate instead;
                        `?track=both` returns one run's Wiener partition as
                        a stereo wav (ch0 speech, ch1 noise). Headers:
                        X-Latency-S (service-side latency), X-Batch-Size.
  POST /v1/enhance_stream
                        online enhancement over one connection: body =
                        raw little-endian PCM16 mono at the service rate
                        (`audio/L16`), `Transfer-Encoding: chunked` or a
                        plain `Content-Length` body, both read as they
                        arrive; the response streams enhanced PCM16 back
                        with chunked transfer encoding as the enhancer
                        finalizes samples (`streaming`). Each connection
                        gets an enhancer from the server's
                        `stream_factory` (501 without one, 429 past
                        `max_streams`). Header: X-Chunk-Frames.
  GET  /healthz         {"status": "ok", "requests": N}.
  GET  /stats           the service's latency and batching counters, and
                        a `streams` block of the stream route's counters
                        (started / active / done / aborted / samples_in).
  GET  /metrics         the same counters in Prometheus text format.

Errors: 400 for a bad request, 429 (Retry-After) when the service's queue
is full, 503 when the service is closed, and 500 with the message for any
other failure, a kernel that does not build or launch included. A stream
that fails after its 200 ends with a truncated chunked body and a closed
connection.

Serve the shipped weights on the card:

    python -m guided_vae_nmf_torch.http_serving --models artifacts/pretrained --fast 1
"""

import argparse
import collections
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ._device import resolve_device
from .data.wav import read_wav, write_wav
from .serving import QueueFullError, ServiceClosedError

_MAX_BODY = 64 * 1024 * 1024            # 64 MB ~ 35 min of 16 kHz PCM16


class _Handler(BaseHTTPRequestHandler):
    service = None              # set by EnhancementHTTPServer
    stream_factory = None       # () -> fresh streaming enhancer, or None
    stream_sem = None           # bounds concurrent streams (429 beyond)
    stream_stats = None         # started / active / done / aborted / ...
    stream_lock = None          # guards stream_stats
    fs = 16000
    quiet = True

    protocol_version = "HTTP/1.1"
    # idle or slow clients release their handler thread
    timeout = 120
    # how much of an unread (rejected) body to drain so the error response
    # survives instead of racing a TCP reset
    _DRAIN_LIMIT = 8 * 1024 * 1024
    _body_left = 0

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    # ---- helpers ---------------------------------------------------------

    def _send(self, code, body, ctype="application/json", headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code, obj):
        self._send(code, json.dumps(obj).encode())

    def _error(self, code, msg):
        # drain a moderate unread body so keep-alive stays usable; beyond
        # the drain limit, close the connection
        if 0 < self._body_left <= self._DRAIN_LIMIT:
            self.rfile.read(self._body_left)
            self._body_left = 0
        headers = ()
        if self._body_left:
            self.close_connection = True
            headers = (("Connection", "close"),)
        self._send(code, json.dumps({"error": msg}).encode(),
                   headers=headers)

    # ---- routes ----------------------------------------------------------

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "requests": self.service.stats().get("requests", 0),
            })
        elif path == "/stats":
            stats = dict(self.service.stats())
            if self.stream_stats is not None:
                with self.stream_lock:
                    stats["streams"] = dict(self.stream_stats)
            self._send_json(200, stats)
        elif path == "/metrics":
            self._send(200, self._prometheus().encode(),
                       ctype="text/plain; version=0.0.4")
        else:
            self._error(404, f"unknown path {path}")

    def _prometheus(self):
        """The /stats counters in Prometheus text exposition format."""
        s = self.service.stats()
        lines = [
            "# TYPE gvnmf_requests_total counter",
            f"gvnmf_requests_total {s.get('requests', 0)}",
            "# TYPE gvnmf_batches_total counter",
            f"gvnmf_batches_total {s.get('batches', 0)}",
        ]
        if "mean_batch" in s:
            lines += [
                "# TYPE gvnmf_batch_size_mean gauge",
                f"gvnmf_batch_size_mean {s['mean_batch']:.6g}",
                "# TYPE gvnmf_request_latency_seconds summary",
                'gvnmf_request_latency_seconds{quantile="0.5"} '
                f"{s['p50_s']:.6g}",
                'gvnmf_request_latency_seconds{quantile="0.95"} '
                f"{s['p95_s']:.6g}",
                'gvnmf_request_latency_seconds{quantile="1"} '
                f"{s['max_s']:.6g}",
            ]
        if self.stream_stats is not None:
            with self.stream_lock:               # consistent snapshot
                st = dict(self.stream_stats)
            lines += [
                "# TYPE gvnmf_streams_started_total counter",
                f"gvnmf_streams_started_total {st.get('started', 0)}",
                "# TYPE gvnmf_streams_done_total counter",
                f"gvnmf_streams_done_total {st.get('done', 0)}",
                "# TYPE gvnmf_streams_aborted_total counter",
                f"gvnmf_streams_aborted_total {st.get('aborted', 0)}",
                "# TYPE gvnmf_streams_active gauge",
                f"gvnmf_streams_active {st.get('active', 0)}",
                "# TYPE gvnmf_stream_samples_in_total counter",
                f"gvnmf_stream_samples_in_total {st.get('samples_in', 0)}",
            ]
        return "\n".join(lines) + "\n"

    def do_POST(self):
        url = urlparse(self.path)
        chunked = "chunked" in (
            self.headers.get("Transfer-Encoding") or "").lower()
        if url.path == "/v1/enhance_stream":
            return self._do_enhance_stream(chunked)
        if chunked:
            self._body_left = _MAX_BODY + 1      # unknown framing: close
            return self._error(400, "chunked body only on /v1/enhance_stream")
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._body_left = _MAX_BODY + 1      # unknown framing: close
            return self._error(400, "bad Content-Length")
        self._body_left = max(0, length)
        if url.path != "/v1/enhance":
            return self._error(404, f"unknown path {url.path}")
        if length <= 0:
            return self._error(400, "empty body (expected RIFF wav)")
        if length > _MAX_BODY:
            return self._error(413, f"body over {_MAX_BODY} bytes")
        body = self.rfile.read(length)
        self._body_left = 0

        try:
            x, fs = read_wav(io.BytesIO(body))
        except Exception as e:      # scipy raises several types on garbage
            return self._error(400, f"not a readable RIFF wav: {e}")
        if fs != self.fs:
            return self._error(
                400, f"sample rate {fs} != service rate {self.fs}")
        if x.ndim > 1:                   # multi-channel: first channel
            x = x[:, 0]
        x = np.ascontiguousarray(x, np.float32)
        if x.size == 0:
            return self._error(400, "zero-length audio")
        if not np.all(np.isfinite(x)):
            return self._error(400, "waveform contains non-finite samples")

        track = parse_qs(url.query).get("track", ["speech"])[0]
        if track not in ("speech", "noise", "both"):
            return self._error(400, f"unknown track {track!r}")
        try:
            out = self.service.enhance(x)
        except QueueFullError as e:      # backpressure: retry with backoff
            return self._send(
                429, json.dumps({"error": str(e)}).encode(),
                headers=(("Retry-After", "1"),))
        except ServiceClosedError as e:
            return self._error(503, str(e))
        except Exception as e:
            # a failed batch, e.g. a kernel that does not build or launch
            # (KernelError, a RuntimeError): a server fault, not a drain
            self.log_error("enhancement failed: %r", e)
            return self._error(500, f"{type(e).__name__}: {e}")
        if track == "both":
            # one run's Wiener partition: s + n reconstructs the mixture
            y = np.stack([out["s"], out["n"]], axis=1)
        else:
            y = out["n" if track == "noise" else "s"]
        buf = io.BytesIO()
        write_wav(buf, y, self.fs)
        self._send(
            200, buf.getvalue(), ctype="audio/wav",
            headers=(("X-Latency-S", f"{out['latency_s']:.4f}"),
                     ("X-Batch-Size", str(out["batch_size"]))),
        )

    # ---- online streaming route ------------------------------------------

    def _iter_chunked(self):
        """Decode a `Transfer-Encoding: chunked` request body, yielding
        payload blocks as they arrive (http.server does not decode chunked
        requests). Raises ValueError on truncated or malformed framing, so
        the handler aborts the stream instead of answering a complete
        response; only a 0-size final chunk ends the body cleanly."""
        while True:
            line = self.rfile.readline(8192)
            if not line:
                raise ValueError("chunked body truncated (EOF in framing)")
            if not line.endswith(b"\n"):     # size line over 8 KB
                raise ValueError("chunk-size line too long")
            try:
                size = int(line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                raise ValueError(f"malformed chunk size {line[:32]!r}")
            if size < 0:   # int(b'-8', 16) parses; it is not valid framing
                raise ValueError(f"negative chunk size {size}")
            if size == 0:
                while True:                  # optional trailers, then CRLF
                    t = self.rfile.readline(1024)
                    if t in (b"\r\n", b"\n"):
                        return
                    if not t:
                        raise ValueError(
                            "chunked body truncated (EOF in trailers)")
            left = size
            while left:
                blk = self.rfile.read1(min(left, 65536))
                if not blk:
                    raise ValueError(
                        "chunked body truncated (EOF in payload)")
                left -= len(blk)
                yield blk
            if len(self.rfile.read(2)) < 2:  # chunk-terminating CRLF
                raise ValueError(
                    "chunked body truncated (EOF at chunk CRLF)")

    def _iter_sized(self, length):
        """Yield a Content-Length body as it arrives (read1: what the
        socket has, not a full block)."""
        left = length
        while left:
            blk = self.rfile.read1(min(left, 65536))
            if not blk:
                return
            left -= len(blk)
            yield blk

    def _do_enhance_stream(self, chunked):
        if self.stream_factory is None:
            self._body_left = _MAX_BODY + 1  # cannot drain an open stream
            return self._error(501, "streaming not configured "
                                    "(server has no stream_factory)")
        if not self.stream_sem.acquire(blocking=False):
            # past the cap the client retries (as the batch route's 429)
            self._body_left = _MAX_BODY + 1
            self.send_response_only(429)
            self.send_header("Retry-After", "1")
            body = json.dumps({"error": "stream capacity reached"}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            self._enhance_stream_locked(chunked)
        finally:
            self.stream_sem.release()

    def _enhance_stream_locked(self, chunked):
        if chunked:
            reader = self._iter_chunked()
        else:
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._body_left = _MAX_BODY + 1
                return self._error(
                    411, "need Content-Length or Transfer-Encoding: chunked")
            if length <= 0:
                return self._error(400, "empty body (expected PCM16)")
            if length > _MAX_BODY:
                self._body_left = _MAX_BODY + 1
                return self._error(413, f"body over {_MAX_BODY} bytes")
            self._body_left = length         # read by _iter_sized below
            reader = self._iter_sized(length)
        try:
            enhancer = self.stream_factory()
        except Exception as e:
            self._body_left = _MAX_BODY + 1
            return self._error(500, f"stream enhancer init failed: {e}")
        st = self.stream_stats
        with self.stream_lock:
            st["started"] += 1
            st["active"] += 1

        def emit(samples):
            if samples.size == 0:
                return
            pcm = np.clip(np.round(np.asarray(samples) * 32768.0),
                          -32768, 32767).astype("<i2").tobytes()
            self.wfile.write(f"{len(pcm):x}\r\n".encode() + pcm + b"\r\n")

        # every exit from here on counts once as 'done' or 'aborted' and
        # decrements 'active', header-write failures included
        total = 0
        carry = b""                          # odd-byte PCM16 alignment
        outcome = "aborted"
        try:
            self.send_response(200)
            self.send_header("Content-Type",
                             f"audio/L16; rate={self.fs}; channels=1")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Chunk-Frames", str(enhancer.chunk_frames))
            self.end_headers()
            for blk in reader:
                total += len(blk)
                if total > _MAX_BODY:        # 200 already sent: cut the
                    self.close_connection = True   # stream, no trailer
                    return
                buf = carry + blk
                n = len(buf) & ~1
                carry = buf[n:]
                if n:
                    x = np.frombuffer(buf[:n], "<i2").astype(np.float32)
                    emit(enhancer.push(x / 32768.0))
            emit(enhancer.flush())
            self.wfile.write(b"0\r\n\r\n")   # final chunk
            self._body_left = 0
            outcome = "done"
            with self.stream_lock:
                st["samples_in"] += total // 2
        except Exception as e:
            # mid-stream failure after the 200: the only signal left is a
            # truncated chunked body and a closed connection
            self.log_error("stream failed: %r", e)
            self.close_connection = True
        finally:
            # pooled sessions hold a shared slot: release it on abort
            # (no-op after a completed flush, and for plain enhancers)
            close = getattr(enhancer, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            with self.stream_lock:
                st[outcome] += 1
                st["active"] -= 1


class EnhancementHTTPServer:
    """Threaded HTTP wrapper around an EnhancementService.

    >>> srv = EnhancementHTTPServer(service, port=0).start()  # 0 = ephemeral
    >>> srv.port                                              # bound port
    >>> srv.close()                                           # HTTP only

    `close()` does not close the service (it may have in-process users);
    `close_all()` closes both and the stream pool's ticker, if any.
    `stream_factory` () -> a streaming enhancer (`push` / `flush` /
    `chunk_frames`) serves `/v1/enhance_stream`, at most `max_streams`
    connections at once."""

    def __init__(self, service, host="127.0.0.1", port=8571, fs=16000,
                 quiet=True, stream_factory=None, max_streams=8):
        self._service = service
        self._stream_driver = None   # set by build_server (pooled streams)
        handler = type("BoundHandler", (_Handler,), {
            "service": service, "fs": fs, "quiet": quiet,
            # staticmethod: a bare function in the class dict would bind
            # as a method and receive the handler as its argument
            "stream_factory": (None if stream_factory is None
                               else staticmethod(stream_factory)),
            "stream_sem": threading.BoundedSemaphore(max_streams),
            "stream_stats": collections.defaultdict(int),
            "stream_lock": threading.Lock(),
        })
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="gvnmf-http")
        self._thread.start()
        return self

    def close(self):
        if self._thread is not None:     # shutdown() waits on serve_forever
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    def close_all(self):
        """Close the HTTP front end, the stream pool's ticker thread (when
        `build_server` attached one) and the service (drains in-flight
        requests)."""
        self.close()
        if self._stream_driver is not None:
            self._stream_driver.shutdown()
        self._service.close()


def build_server(models_dir, host="127.0.0.1", port=8571, niter=100,
                 noise_model="spp", noise_gain=False, noise_gain_bands=1,
                 soft_labels=False, fast=False, wait_ms=20.0, warmup=False,
                 stream=True, chunk_frames=8, stream_residual=False,
                 pooled_streams=False, max_streams=8, tick_ms=5.0,
                 data_parallel=False, profile=None, device=None):
    """The serving stack from a pretrained-models directory (`M2_ibm/` and
    `classifier_ibm/`): an EnhancementService with DNN labels on `device`
    (the GPU unless named), the stream route (`stream`: a dedicated
    `StreamingM2Enhancer` a connection, or with `pooled_streams` one
    `MultiStreamM2Enhancer` of `max_streams` slots behind a
    `StreamPoolDriver` ticking every `tick_ms`), and the HTTP front end,
    returned unstarted; its `close_all()` tears the stack down.
    `profile` names a validated operating point (profiles.py): its
    offline settings override noise_model, soft_labels and the noise gain,
    and its streaming settings the stream knobs (chunk_frames,
    stream_residual, soft guidance, the noise gain and its bands, the
    adaptive budget). Stream connections keep no mask history.
    `data_parallel` shards both serving paths over a mesh
    (`parallel.data_parallel_mesh(device)`: every visible card, or the one
    named device): request batches through the service's sharded
    dispatch, and the pool's slot rows and their state over the mesh
    (max_streams is rounded up to a multiple of the mesh's size)."""
    from .mcem.engine import MCEMConfig
    from .profiles import get_profile
    from .serving import EnhancementService, ServeConfig
    from .train import load_classifier_meta, load_model, load_norm_stats

    mesh = None
    if data_parallel:
        from .parallel import data_parallel_mesh, pad_to_multiple

        mesh = data_parallel_mesh(device)
        max_streams = pad_to_multiple(max_streams, mesh.shape["data"])
    device = resolve_device(device)
    # the stream lanes may differ from the batch service under a
    # streaming-only profile
    stream_soft, stream_gain = soft_labels, noise_gain
    stream_bands = noise_gain_bands
    stream_adaptive = 0
    if profile is not None:
        prof = get_profile(profile)
        if prof.offline:
            noise_model = prof.noise_model
            soft_labels = prof.soft_guidance
            noise_gain = prof.cfg_overrides.get("noise_gain", False)
            noise_gain_bands = prof.cfg_overrides.get("noise_gain_bands", 1)
        st = prof.streaming or {}
        chunk_frames = st.get("chunk_frames", chunk_frames)
        stream_residual = st.get("residual_tracking", stream_residual)
        stream_soft = st.get("soft_guidance", soft_labels)
        stream_gain = st.get("noise_gain", noise_gain)
        stream_bands = st.get("noise_gain_bands", noise_gain_bands)
        stream_adaptive = st.get("adaptive_iters", 0)
    cdir = os.path.join(models_dir, "classifier_ibm")
    m2 = load_model(os.path.join(models_dir, "M2_ibm"), kind="dgm",
                    device=device)
    cls = load_model(cdir, kind="classifier", device=device)
    mean, std = load_norm_stats(cdir)
    cmeta = load_classifier_meta(cdir)
    svc = EnhancementService(
        m2, classifier=cls, mean=mean, std=std,
        cfg=MCEMConfig(niter=niter, noise_gain=noise_gain,
                       noise_gain_bands=noise_gain_bands),
        serve=ServeConfig(max_wait_ms=wait_ms, label_mode="dnn",
                          noise_model=noise_model, soft_guidance=soft_labels,
                          fast=fast, features=cmeta["features"],
                          dnn_threshold=cmeta["threshold"]),
        mesh=mesh, device=device)
    if warmup:
        print(f"warmup: {svc.warmup():.1f}s", flush=True)
        svc.reset_stats()

    stream_factory = None
    driver = None
    stream_kw = dict(classifier=cls, mean=mean, std=std,
                     chunk_frames=chunk_frames, soft_guidance=stream_soft,
                     residual_tracking=stream_residual,
                     noise_gain=stream_gain, noise_gain_bands=stream_bands,
                     adaptive_iters=stream_adaptive, label_mode="dnn",
                     features=cmeta["features"],
                     dnn_threshold=cmeta["threshold"],
                     # HTTP streams never expose masks; with the prefix
                     # trimming, a live connection runs at bounded memory
                     keep_masks=False, device=device)
    if stream and pooled_streams:
        from .streaming import (
            MultiStreamM2Enhancer,
            PooledStreamSession,
            StreamPoolDriver,
        )

        driver = StreamPoolDriver(
            MultiStreamM2Enhancer(m2, max_streams=max_streams, mesh=mesh,
                                  **stream_kw),
            tick_ms=tick_ms)

        def stream_factory():
            return PooledStreamSession(driver)
    elif stream:
        from .streaming import StreamingM2Enhancer

        def stream_factory():
            return StreamingM2Enhancer(m2, **stream_kw)

    srv = EnhancementHTTPServer(svc, host=host, port=port, quiet=False,
                                stream_factory=stream_factory,
                                max_streams=max_streams)
    srv._stream_driver = driver          # close_all() owns the ticker
    return srv


def _flag01(v):
    if v not in ("0", "1", "true", "false"):
        raise argparse.ArgumentTypeError(f"expected 0 or 1, got {v!r}")
    return v in ("1", "true")


def _fast_flag(v):
    return "trans" if v == "trans" else _flag01(v)


def main(argv=None):
    """The flags of the JAX package's scripts/serve_http.py (`--fast` also
    takes `trans`, `--device` names another device than the GPU);
    `--data_parallel 1` shards both serving paths over every visible card
    (over the one `--device` otherwise)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--models", default="artifacts/pretrained")
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--noise_model", default="spp")
    ap.add_argument("--noise_gain", type=_flag01, default=False)
    ap.add_argument("--noise_gain_bands", type=int, default=1)
    ap.add_argument("--soft_labels", type=_flag01, default=False)
    ap.add_argument("--fast", type=_fast_flag, default=False)
    ap.add_argument("--wait_ms", type=float, default=20.0)
    ap.add_argument("--warmup", type=_flag01, default=False)
    ap.add_argument("--stream", type=_flag01, default=True,
                    help="serve /v1/enhance_stream")
    ap.add_argument("--chunk_frames", type=int, default=8,
                    help="stream chunk in 16 ms frames")
    ap.add_argument("--stream_residual", type=_flag01, default=False,
                    help="stream residual tracking")
    ap.add_argument("--pooled_streams", type=_flag01, default=False,
                    help="co-batch concurrent streams in one pool")
    ap.add_argument("--max_streams", type=int, default=8,
                    help="concurrent stream cap (429 beyond)")
    ap.add_argument("--tick_ms", type=float, default=5.0,
                    help="pool co-batching window")
    ap.add_argument("--data_parallel", type=_flag01, default=False,
                    help="shard requests + pooled streams over every card "
                         "(a thread a shard: on host-paced paths it can be "
                         "slower than one card)")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    srv = build_server(
        a.models, host=a.host, port=a.port, niter=a.niter,
        noise_model=a.noise_model, noise_gain=a.noise_gain,
        noise_gain_bands=a.noise_gain_bands, soft_labels=a.soft_labels,
        fast=a.fast, wait_ms=a.wait_ms, warmup=a.warmup, stream=a.stream,
        chunk_frames=a.chunk_frames, stream_residual=a.stream_residual,
        pooled_streams=a.pooled_streams, max_streams=a.max_streams,
        tick_ms=a.tick_ms, data_parallel=a.data_parallel,
        profile=a.profile, device=a.device)
    srv.start()
    print(f"serving on http://{a.host}:{srv.port} (niter={a.niter}, "
          f"noise_model={a.noise_model}, soft={a.soft_labels}, "
          f"fast={a.fast}, stream={a.stream}, "
          f"pooled={a.pooled_streams})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close_all()


if __name__ == "__main__":
    main()
