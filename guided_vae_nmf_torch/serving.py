"""Online dynamic-batching enhancement service.

Counterpart of `guided_vae_nmf_tpu/serving.py` (`QueueFullError`,
`ServeConfig`, `EnhancementService`): concurrent clients call
`submit(waveform)` and get a Future; a collector thread groups pending
requests within a bounded wait window (`max_wait_ms`), buckets them by
padded frame count, coalesces short buckets into longer ones under load,
and runs one :func:`~guided_vae_nmf_torch.pipeline.enhance_waveform` batch
per group on the service's device (the fused engine, with the K1 / K2
kernels on CUDA); a fetcher thread copies each batch's PCM16 result to the
host and resolves its requests. Batch sizes are rounded up to a small
lattice with duplicated tail rows, as in the JAX package, which bounds the
shapes a deployment sees.

Determinism: every request has its own seed, `seed * 1_000_003 + rid`.
On the fused engine a batch's `torch.Generator` is seeded from its first
request's, as the JAX fused engine uses only the batch's leading key, so a
request's output depends on what else rode in its batch. On the eager
engine (`engine='xla'`) each row draws from its own seed by a counter
hash and its EM runs in float64 (`mcem.engine`), so a request gives the
same PCM alone or co-batched (the tests allow 1 LSB); its noise track is
the device's n, not x - s. At var_RW=0 with the 'spp' noise model
nothing is drawn at random and the output is deterministic.

With `mesh=` (a `parallel.Mesh`) each batch is split over the mesh's
"data" axis (`pipeline.enhance_waveform_sharded`): a batch is padded to a
lattice entry of at least the axis's size, and each shard's generator is
seeded from its first request's seed, so on a mesh of one device the
service is the unsharded one.
"""

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np
import torch

from ._build import build_all
from ._device import resolve_device
from .dsp import frame_count, pad_signal_for_stft
from .mcem.engine import MCEMConfig
from .models.rvae import refuse_rvae
from .parallel.mesh import data_size, pad_to_multiple, replicate
from .pipeline import (
    HOP,
    NFFT,
    _check_supported,
    _eager,
    enhance_waveform,
    enhance_waveform_sharded,
)

SERVE_LABEL_MODES = ("dnn", "timo", "none", "ones", "zeros")


class QueueFullError(RuntimeError):
    """submit() backpressure: the waiting queue is at ServeConfig.max_queue.
    Transient by design: retry with backoff (HTTP front end: 429)."""


class ServiceClosedError(RuntimeError):
    """submit() on a closed service (HTTP front end: 503)."""


@dataclass(frozen=True)
class ServeConfig:
    """Dynamic-batching policy (the JAX package's fields and defaults).

    max_batch: largest device batch. max_wait_ms: how long the collector
      holds the first request of a group open for company.
    bucket_multiple: frame-count lattice (the kernels need N % 16 == 0;
      128 matches the JAX package). batch_lattice: allowed device batch
      sizes; a group of 5 runs as 8 with duplicated tail rows.
    max_queue: submit() raises QueueFullError once this many requests wait
      (0: no bound). max_pad_waste: under load, shorter requests merge into
      the longest pending bucket while each wastes at most this share of
      its row's compute (0: no coalescing).
    engine: 'auto', 'fused' or 'xla' (see pipeline._use_fused); 'xla' is
      the replay-stable eager engine. fast: False, True or 'trans' (see
      pipeline._fast_kwargs)."""

    max_batch: int = 16
    max_wait_ms: float = 20.0
    bucket_multiple: int = 128
    batch_lattice: tuple = (1, 2, 4, 8, 16)
    max_queue: int = 256
    max_pad_waste: float = 0.5
    label_mode: str = "dnn"          # 'dnn' | 'timo' | 'none' (M1)
    target: str = "ibm"
    noise_model: str = "spp"         # serving default = real-noise config
    engine: str = "auto"             # 'auto' | 'fused' | 'xla'
    fast: bool = False
    soft_guidance: bool = False      # condition on classifier probabilities
    features: str = "power"          # 'power' | 'log-power'
    dnn_threshold: float = 0.5
    seed: int = 0


@dataclass
class _Request:
    x: np.ndarray                    # float32 waveform
    future: Future = field(default_factory=Future)
    rid: int = 0
    t_submit: float = 0.0
    n_frames: int = 0


class EnhancementService:
    """Shared-device online enhancement endpoint with dynamic batching.

    >>> svc = EnhancementService(m2, classifier=cls, mean=m, std=s)
    >>> fut = svc.submit(noisy_waveform)          # returns immediately
    >>> out = fut.result()                        # {'s': ..., 'n': ...}
    >>> svc.close()

    `enhance(x)` is the blocking form. Thread-safe: any number of producer
    threads may submit concurrently. The model and classifier must live on
    `device` (the GPU unless named); on CUDA the kernels are built here, so
    a toolchain fault fails the constructor and not each request.

    mesh: optional `parallel.Mesh` whose "data" axis the batches are split
    over (the largest batch_lattice entry must divide by it; single
    requests then pay duplicate rows); the service's device is then the
    axis's first and `device` is unused."""

    def __init__(self, model, classifier=None, mean=None, std=None,
                 cfg: MCEMConfig = MCEMConfig(),
                 serve: ServeConfig = ServeConfig(), mesh=None, device=None):
        refuse_rvae(model, "the service")
        if serve.label_mode not in SERVE_LABEL_MODES:
            raise ValueError(f"label_mode must be one of {SERVE_LABEL_MODES},"
                             f" got {serve.label_mode!r}")
        if serve.label_mode == "dnn" and classifier is None:
            raise ValueError("label_mode 'dnn' needs a classifier")
        _check_supported(serve.noise_model, serve.fast, cfg, serve.engine)
        lat = tuple(serve.batch_lattice)
        if not lat or list(lat) != sorted(set(lat)) or lat[0] < 1:
            raise ValueError("batch_lattice must be strictly increasing "
                             "positive sizes")
        if serve.max_batch > lat[-1]:
            raise ValueError(
                f"max_batch={serve.max_batch} exceeds the largest "
                f"batch_lattice entry {lat[-1]}")
        if serve.bucket_multiple < 16 or serve.bucket_multiple % 16:
            raise ValueError("bucket_multiple must be a multiple of 16 (the "
                             "chain kernel's frame tile)")
        self._mesh = mesh
        self._n_dev = 1
        if mesh is None:
            self._dev = resolve_device(device)
        else:
            self._n_dev = data_size(mesh)
            if lat[-1] % self._n_dev:
                raise ValueError("the largest batch_lattice entry must "
                                 "divide by the mesh data axis")
            self._dev = mesh.axis_devices("data")[0]
            self._replicas = (replicate(mesh, model),
                              replicate(mesh, classifier))
        if self._dev.type == "cuda":
            build_all()
        self._model = model
        self._cls = classifier
        self._mean = None if mean is None else torch.as_tensor(
            np.asarray(mean, np.float32), device=self._dev)
        self._std = None if std is None else torch.as_tensor(
            np.asarray(std, np.float32), device=self._dev)
        self._cfg = cfg
        self._serve = serve
        self._queue = deque()
        self._cv = threading.Condition()
        self._rid = 0
        self._closed = False
        # (latency_s, batch_size) per request over a bounded window
        self._lat = deque(maxlen=10_000)
        self._n_total = 0
        self._batches = 0
        # dispatched, unfetched batches: at most two batches' buffers live
        self._inflight = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="gvnmf-serving")
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True,
                                         name="gvnmf-serving-fetch")
        self._worker.start()
        self._fetcher.start()

    # ---- client API ------------------------------------------------------

    def submit(self, x):
        """Enqueue one waveform; returns a Future of {'s', 'n',
        'latency_s', 'batch_size'} (float32 arrays trimmed to len(x))."""
        x = np.asarray(x, np.float32)
        if x.ndim != 1 or len(x) == 0:
            raise ValueError("submit expects a non-empty 1-D waveform")
        if not np.all(np.isfinite(x)):
            raise ValueError("waveform contains non-finite samples")
        req = _Request(x=x, t_submit=time.perf_counter(),
                       n_frames=frame_count(len(x)))
        with self._cv:
            if self._closed:
                raise ServiceClosedError("service is closed")
            mq = self._serve.max_queue
            if mq and len(self._queue) >= mq:
                raise QueueFullError(
                    f"{len(self._queue)} requests waiting "
                    f"(ServeConfig.max_queue={mq})")
            self._rid += 1
            req.rid = self._rid
            self._queue.append(req)
            self._cv.notify()
        return req.future

    def enhance(self, x):
        return self.submit(x).result()

    def stats(self):
        """Serving counters: request count, mean batch size, latency
        percentiles (seconds)."""
        with self._cv:
            snap = list(self._lat)
            n_total, batches = self._n_total, self._batches
        if not snap:
            return {"requests": n_total, "batches": batches}
        lat = sorted(l for l, _ in snap)
        bs = [b for _, b in snap]

        def pct(p):
            return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

        return {
            "requests": n_total, "window": len(lat), "batches": batches,
            "mean_batch": float(np.mean(bs)),
            "p50_s": pct(50), "p95_s": pct(95), "max_s": lat[-1],
        }

    def warmup(self, buckets=(128, 256, 512), batch_sizes=None):
        """Run the (batch, bucket) lattice once, as the JAX package's warmup
        does: here it compiles nothing but allocates each shape's buffers in
        PyTorch's caching allocator. Returns elapsed seconds; call
        `reset_stats()` afterwards if the warmup should not count."""
        t0 = time.perf_counter()
        for n_pad in buckets:
            T = (n_pad - 4) * HOP
            for B in (batch_sizes or self._serve.batch_lattice):
                reqs = [_Request(x=np.full(T, 1e-3, np.float32),
                                 t_submit=time.perf_counter(),
                                 n_frames=frame_count(T))
                        for _ in range(B)]
                self._resolve_bucket(self._dispatch_bucket(n_pad, reqs),
                                     reqs)
                for r in reqs:
                    r.future.result()
        return time.perf_counter() - t0

    def reset_stats(self):
        with self._cv:
            self._lat.clear()
            self._n_total = 0
            self._batches = 0

    def close(self, timeout=60.0):
        """Drain the queue, stop the threads. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        self._fetcher.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- collector / fetcher ---------------------------------------------

    def _device_ctx(self):
        """The service's card as the thread's current device: every launch
        and the fetcher's copies go to that card's current stream, so a copy
        orders after its batch's kernels."""
        if self._dev.type == "cuda":
            return torch.cuda.device(self._dev)
        return contextlib.nullcontext()

    def _collect(self):
        """Block for the first request, then hold the group open for up to
        max_wait_ms (or until max_batch arrive). Returns [] on shutdown."""
        sv = self._serve
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(0.1)
            if not self._queue:
                return []
            deadline = time.perf_counter() + sv.max_wait_ms / 1e3
            while len(self._queue) < sv.max_batch and not self._closed:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(left)
            group = []
            while self._queue and len(group) < sv.max_batch:
                group.append(self._queue.popleft())
            return group

    def _loop(self):
        """Collector: groups requests and enqueues their batches on the
        device; the fetcher blocks on the results, so the collector moves on
        to the next group while the card computes."""
        with self._device_ctx():
            while True:
                group = self._collect()
                if not group:
                    with self._cv:
                        if self._closed and not self._queue:
                            self._inflight.put(None)    # fetcher sentinel
                            return
                    continue
                for n_pad, reqs in self._plan_groups(group):
                    try:
                        handles = self._dispatch_bucket(n_pad, reqs)
                        self._inflight.put((handles, reqs))
                    except Exception as e:      # resolve rather than wedge
                        _fail(reqs, e)

    def _fetch_loop(self):
        with self._device_ctx():
            while True:
                item = self._inflight.get()
                if item is None:
                    return
                handles, reqs = item
                try:
                    self._resolve_bucket(handles, reqs)
                except Exception as e:
                    _fail(reqs, e)

    def _plan_groups(self, group):
        """Partition a collected group into (n_pad, requests) dispatches:
        one per `bucket_multiple` length bucket, and under load smaller
        buckets coalesced upward into the longest pending one while the
        merged rows waste at most `max_pad_waste` and the batch has room."""
        bm = self._serve.bucket_multiple
        buckets = {}
        for r in group:
            b = -(-r.n_frames // bm) * bm
            buckets.setdefault(b, []).append(r)
        if self._serve.max_pad_waste <= 0 or len(buckets) == 1:
            return sorted(buckets.items())
        plans = []
        pending = sorted(buckets.items(), reverse=True)
        while pending:
            n_pad, reqs = pending.pop(0)
            reqs = list(reqs)
            while pending and len(reqs) < self._serve.max_batch:
                b_next, r_next = pending[0]
                if (n_pad - b_next) / n_pad > self._serve.max_pad_waste:
                    break
                room = self._serve.max_batch - len(reqs)
                reqs.extend(r_next[:room])
                if room >= len(r_next):
                    pending.pop(0)
                else:
                    pending[0] = (b_next, r_next[room:])
            plans.append((n_pad, reqs))
        return plans

    def _dispatch_bucket(self, n_pad, reqs):
        """Host assembly, then the batch on the device; returns the device
        tensors (s_i16, n_i16 or None, finite_ok) without waiting for
        them."""
        sv = self._serve
        B = len(reqs)
        Bp = next(b for b in sv.batch_lattice if b >= max(B, self._n_dev))
        Bp = pad_to_multiple(Bp, self._n_dev)
        Lw = (n_pad - 1) * HOP + NFFT
        x_b = np.zeros((Bp, Lw), np.int16)
        mask_b = np.zeros((Bp, n_pad), np.float32)
        for j, r in enumerate(reqs):
            xi = np.clip(np.round(r.x * 32768.0), -32768, 32767)
            xp, nf = pad_signal_for_stft(xi.astype(np.int16))
            x_b[j, : min(len(xp), Lw)] = xp[:Lw]
            mask_b[j, :nf] = 1.0
        x_b[B:] = x_b[B - 1]                     # benign duplicate tail rows
        mask_b[B:] = mask_b[B - 1]
        seeds = [sv.seed * 1_000_003 + r.rid
                 for r in reqs + [reqs[-1]] * (Bp - B)]
        # the eager engine's Vx floor can break WFs + WFn = 1 in near-silent
        # bins, so its rows return the device's n
        eager = _eager(sv.engine, self._model, n_pad, sv.noise_model)
        dnn = sv.label_mode == "dnn"
        kw = dict(mean=self._mean if dnn else None,
                  std=self._std if dnn else None, label_mode=sv.label_mode,
                  noise_model=sv.noise_model, fast=sv.fast, engine=sv.engine,
                  target=sv.target, return_noise=eager,
                  soft_guidance=sv.soft_guidance, features=sv.features,
                  dnn_threshold=sv.dnn_threshold)
        if self._mesh is None:
            s_i16, n_i16, _, _, finite_ok = enhance_waveform(
                self._model, x_b, mask_b, self._cfg,
                classifier=self._cls if dnn else None,
                generator=torch.Generator(device=self._dev).manual_seed(
                    seeds[0] % 2**63),
                seeds=seeds, device=self._dev, **kw)
        else:
            models, classifiers = self._replicas
            s_i16, n_i16, _, _, finite_ok = enhance_waveform_sharded(
                self._mesh, models, x_b, mask_b, self._cfg,
                classifier=classifiers if dnn else None, seeds=seeds, **kw)
        return s_i16, n_i16, finite_ok

    def _resolve_bucket(self, handles, reqs):
        s_i16, n_i16, finite_ok = handles
        B = len(reqs)
        s_np = s_i16.cpu().numpy().astype(np.float32) / 32768.0
        n_np = (None if n_i16 is None
                else n_i16.cpu().numpy().astype(np.float32) / 32768.0)
        ok = finite_ok.cpu().numpy()            # (Bp,) per-row flags
        now = time.perf_counter()
        for j, r in enumerate(reqs):
            T = len(r.x)
            if ok[j]:
                s = s_np[j, :T]
                # the fused engine's Wiener gains sum to 1
                n = r.x - s if n_np is None else n_np[j, :T]
            else:                                # degrade this row only
                s, n = r.x.copy(), np.zeros(T, np.float32)
            lat = now - r.t_submit
            with self._cv:
                self._lat.append((lat, B))
                self._n_total += 1
            if not r.future.done():              # client may have cancelled
                try:
                    r.future.set_result({"s": s, "n": n, "latency_s": lat,
                                         "batch_size": B})
                except InvalidStateError:        # cancel raced done()
                    pass
        with self._cv:
            self._batches += 1


def _fail(reqs, exc):
    for r in reqs:
        if not r.future.done():
            try:
                r.future.set_exception(exc)
            except InvalidStateError:            # cancel raced done()
                pass
