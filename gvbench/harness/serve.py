"""Online users as an open loop: Poisson arrivals at a fixed rate into
`serving.EnhancementService` under the mix's `ServeConfig`. A sender
thread submits each request at its due time (sleeping to the schedule, not
after each submit) and notes how late it ran; a request is timed from its
due time to the moment its future resolves. After the window every request
due inside it is awaited up to the drain limit. A request fails if it
raises, is unresolved at the limit, or comes back as its own mixture (the
service's degraded row: s equal to x, n all zeros)."""

import threading
import time

import numpy as np
import torch

from . import signals
from .tap import Tap
from .trace import warm_profiler


def _warm(family, env, sv, lens):
    """Every (batch, bucket) shape the traffic can form, once, at one EM
    iteration: the shapes' buffers, FFT plans and library handles."""
    from guided_vae_nmf_torch import pipeline

    cfg = family.warm_cfg(env.cfg)
    kw = family.entry_kwargs(env, sv.noise_model)
    buckets = sorted({signals.bucket(signals.frame_count(int(n)),
                                     sv.bucket_multiple) for n in lens})
    for n_pad in buckets:
        for B in sv.batch_lattice:
            x = np.zeros(((n_pad - 1) * signals.HOP + signals.NFFT,),
                         np.int16)
            x[::7] = 300
            mask = np.ones((B, n_pad), np.float32)
            gen = torch.Generator(device=env.dev).manual_seed(1)
            out = pipeline.enhance_waveform(
                env.model, np.repeat(x[None], B, 0), mask, cfg,
                generator=gen, seeds=list(range(B)), **kw)
            out[0].cpu()


def run(family, env, mix, seconds, trace, seed, rate=None):
    from guided_vae_nmf_torch import serving

    rate = rate or mix["rate_per_s"]
    n = max(1, int(round(rate * seconds)))
    lens, snrs, useeds, times = signals.draw(seed, n, mix["length_s"],
                                             mix["snr_db"], rate, seconds)
    xs = [p.astype(np.float32) / 32768.0
          for p in signals.mixtures(lens, snrs, useeds, env.dev)]
    t_traffic = time.perf_counter()
    sv = serving.ServeConfig(label_mode=env.label_mode, **mix["serve"])
    svc = serving.EnhancementService(env.model, env.classifier, env.mean,
                                     env.std, cfg=env.cfg, serve=sv,
                                     device=env.dev)
    pick = np.random.default_rng([seed, 1])
    k = int(pick.integers(max(1, int(rate * seconds / 2 / sv.max_batch))))
    i_sel = family.pick_judged(env.cfg, pick)
    tap = Tap(armed=k, i_sel=i_sel, trace=trace, profile_from=seconds / 3,
              profile_s=mix["profile_s"])
    try:
        _warm(family, env, sv, lens)
        svc.enhance(xs[0][: signals.FS])          # the service's threads
        if env.dev.type == "cuda":
            torch.cuda.synchronize()
        if trace and env.dev.type == "cuda":
            warm_profiler(env.dev)
        rid0 = 2                      # the warm-up request took rid 1
        tap.install(serving, family)
        t_setup = time.perf_counter()
        futs = [None] * n
        done = np.full(n, np.nan)
        late = np.zeros(n)
        lock = threading.Lock()
        count = {"sent": 0, "done": 0}
        backlog = []

        def finished(i):
            def cb(_):
                done[i] = time.perf_counter()
                with lock:
                    count["done"] += 1
            return cb

        def sender():
            nxt_sample = seconds / 3
            for i in range(n):
                due = tap.window_t0 + times[i]
                while True:
                    left = due - time.perf_counter()
                    if left <= 0:
                        break
                    time.sleep(min(left, 0.002))
                try:
                    futs[i] = svc.submit(xs[i])
                    futs[i].add_done_callback(finished(i))
                except serving.QueueFullError:
                    futs[i] = None
                late[i] = time.perf_counter() - due
                with lock:
                    count["sent"] += futs[i] is not None
                if times[i] >= nxt_sample:
                    with lock:
                        backlog.append((times[i],
                                        count["sent"] - count["done"]))
                    nxt_sample += seconds / 3

        tap.start_window()
        th = threading.Thread(target=sender, name="gvbench-sender")
        th.start()
        th.join()
        t_end = tap.window_t0 + seconds
        time.sleep(max(0.0, t_end - time.perf_counter()))
        with lock:
            backlog.append((seconds, count["sent"] - count["done"]))
        deadline = t_end + mix["drain_s"]
        lat = np.full(n, np.inf)
        sizes = []
        failed = 0
        for i in range(n):
            f = futs[i]
            try:
                if f is None:
                    raise RuntimeError("refused")
                r = f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:                      # noqa: BLE001
                failed += 1
                continue
            if np.array_equal(r["s"], xs[i]) and not np.any(r["n"]):
                failed += 1
                continue
            while np.isnan(done[i]):          # callbacks run after result()
                time.sleep(0.0005)
            lat[i] = done[i] - (tap.window_t0 + times[i])
            sizes.append(r["batch_size"])
        tap.stop_profile()
        rec = tap.record
        rows_s = None
        if rec is not None:
            rows_s = []
            for s in rec["seeds"][: rec["rows"]]:
                i = s - sv.seed * 1_000_003 - rid0
                r = futs[i].result(timeout=0)
                rows_s.append(np.round(r["s"] * 32768.0).astype(np.int64))
    finally:
        tap.uninstall()
        svc.close()
    ok = lat[np.isfinite(lat)]
    worst = seconds + mix["drain_s"]
    full = np.sort(np.where(np.isfinite(lat), lat, worst))

    def pct(q):
        return float(full[min(n - 1, int(np.ceil(q * n)) - 1)])

    return {"metrics": {"latency_p50_s": pct(0.50),
                        "latency_p95_s": pct(0.95)},
            "attempted": n, "failed": failed, "window_s": seconds,
            "t_setup": t_setup, "t_traffic": t_traffic, "tap": tap,
            "rows_s": rows_s,
            "requests": {"batch_sizes": sizes},
            "notes": {"rate_per_s": rate, "requests": n,
                      "backlog": backlog,
                      "sender_late_ms_p50": 1e3 * float(np.median(late)),
                      "sender_late_ms_max": 1e3 * float(late.max()),
                      "served_p50_s": float(np.median(ok)) if len(ok)
                      else None, "armed_batch": k, "i_sel": i_sel}}
