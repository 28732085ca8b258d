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
                        501: the streaming enhancers are not ported yet
                        (ROADMAP Queue 1, item 1).
  GET  /healthz         {"status": "ok", "requests": N}.
  GET  /stats           the service's latency and batching counters.
  GET  /metrics         the same counters in Prometheus text format.

Errors: 400 for a bad request, 429 (Retry-After) when the service's queue
is full, 503 when the service is closed, and 500 with the message for any
other failure, a kernel that does not build or launch included.

Serve the shipped weights on the card:

    python -m guided_vae_nmf_torch.http_serving --models artifacts/pretrained --fast 1
"""

import argparse
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .data.wav import read_wav, write_wav
from .serving import QueueFullError, ServiceClosedError

_MAX_BODY = 64 * 1024 * 1024            # 64 MB ~ 35 min of 16 kHz PCM16


class _Handler(BaseHTTPRequestHandler):
    service = None              # set by EnhancementHTTPServer
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
            self._send_json(200, self.service.stats())
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
        return "\n".join(lines) + "\n"

    def do_POST(self):
        url = urlparse(self.path)
        if url.path == "/v1/enhance_stream":
            self._body_left = _MAX_BODY + 1      # cannot drain a stream
            return self._error(501, "streaming not configured (the "
                                    "streaming enhancers are not ported)")
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
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


class EnhancementHTTPServer:
    """Threaded HTTP wrapper around an EnhancementService.

    >>> srv = EnhancementHTTPServer(service, port=0).start()  # 0 = ephemeral
    >>> srv.port                                              # bound port
    >>> srv.close()                                           # HTTP only

    `close()` does not close the service (it may have in-process users);
    `close_all()` closes both."""

    def __init__(self, service, host="127.0.0.1", port=8571, fs=16000,
                 quiet=True):
        self._service = service
        handler = type("BoundHandler", (_Handler,), {
            "service": service, "fs": fs, "quiet": quiet})
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
        """Close the HTTP front end and the service (drains in-flight
        requests)."""
        self.close()
        self._service.close()


def build_server(models_dir, host="127.0.0.1", port=8571, niter=100,
                 noise_model="spp", noise_gain=False, noise_gain_bands=1,
                 soft_labels=False, fast=False, wait_ms=20.0, warmup=False,
                 stream=False, pooled_streams=False, data_parallel=False,
                 profile=None, device=None):
    """The serving stack from a pretrained-models directory (`M2_ibm/` and
    `classifier_ibm/`): an EnhancementService with DNN labels on `device`
    (the GPU unless named) and the HTTP front end, returned unstarted; its
    `close_all()` tears both down. `profile` names a validated operating
    point (profiles.py) whose offline settings override noise_model,
    soft_labels and the noise gain.

    The stream route is not ported yet, so `stream` defaults to False here
    (the JAX package's default is True); `stream`, `pooled_streams`
    (ROADMAP Queue 1, item 1) and `data_parallel` (item 5) raise
    NotImplementedError."""
    from .mcem.engine import MCEMConfig
    from .profiles import get_profile
    from .serving import EnhancementService, ServeConfig
    from .train import load_classifier_meta, load_model, load_norm_stats

    if stream or pooled_streams:
        raise NotImplementedError(
            "the streaming route is not ported yet (ROADMAP Queue 1, item 1)")
    if data_parallel:
        raise NotImplementedError(
            "data-parallel serving is not ported yet (ROADMAP Queue 1, "
            "item 5)")
    if profile is not None:
        prof = get_profile(profile)
        if prof.offline:
            noise_model = prof.noise_model
            soft_labels = prof.soft_guidance
            noise_gain = prof.cfg_overrides.get("noise_gain", False)
            noise_gain_bands = prof.cfg_overrides.get("noise_gain_bands", 1)
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
        device=device)
    if warmup:
        print(f"warmup: {svc.warmup():.1f}s", flush=True)
        svc.reset_stats()
    return EnhancementHTTPServer(svc, host=host, port=port, quiet=False)


def _flag01(v):
    if v not in ("0", "1", "true", "false"):
        raise argparse.ArgumentTypeError(f"expected 0 or 1, got {v!r}")
    return v in ("1", "true")


def _fast_flag(v):
    return "trans" if v == "trans" else _flag01(v)


def main(argv=None):
    """The flags of the JAX package's scripts/serve_http.py (`--fast` also
    takes `trans`, `--device` names another device than the GPU). The
    stream route's flags are accepted so that a command line written for
    that script runs, but `--stream 1`, `--pooled_streams 1` and
    `--data_parallel 1` raise NotImplementedError."""
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
    ap.add_argument("--stream", type=_flag01, default=False)
    ap.add_argument("--pooled_streams", type=_flag01, default=False)
    ap.add_argument("--data_parallel", type=_flag01, default=False)
    for name, typ in (("chunk_frames", int), ("stream_residual", _flag01),
                      ("max_streams", int), ("tick_ms", float)):
        ap.add_argument(f"--{name}", type=typ, help="stream route only")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    srv = build_server(
        a.models, host=a.host, port=a.port, niter=a.niter,
        noise_model=a.noise_model, noise_gain=a.noise_gain,
        noise_gain_bands=a.noise_gain_bands, soft_labels=a.soft_labels,
        fast=a.fast, wait_ms=a.wait_ms, warmup=a.warmup, stream=a.stream,
        pooled_streams=a.pooled_streams, data_parallel=a.data_parallel,
        profile=a.profile, device=a.device)
    srv.start()
    print(f"serving on http://{a.host}:{srv.port} (niter={a.niter}, "
          f"noise_model={a.noise_model}, soft={a.soft_labels}, "
          f"fast={a.fast})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close_all()


if __name__ == "__main__":
    main()
