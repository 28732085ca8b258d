"""The offline protocol as a closed loop: a pool of utterances from the
seed, cut into batches by `pipeline.plan_batches`'s rule, and
`pipeline.enhance_waveform` over the host-padded int16 batches one after
another, wrapping round the pool; each batch ends with its PCM16 and
labels on the host, as `enhance_files` fetches them (its wav reading and
writing are left out: they measure the disk)."""

import time

import numpy as np
import torch

from . import signals
from .tap import Tap
from .trace import warm_profiler


def run(family, env, mix, seconds, trace, seed, only_armed=False):
    from guided_vae_nmf_torch import pipeline

    n = mix["pool"]
    lens, snrs, useeds, _ = signals.draw(seed, n, mix["length_s"],
                                         mix["snr_db"])
    pcm = signals.mixtures(lens, snrs, useeds, env.dev)
    t_traffic = time.perf_counter()
    frames = [signals.frame_count(len(x)) for x in pcm]
    plan = signals.plan_batches(frames, mix["batch_size"],
                                mix["bucket_frames"], seed)
    batches = [(signals.padded([pcm[i] for i in idxs], n_pad), idxs,
                [int(s) for s in bseeds]) for idxs, n_pad, bseeds in plan]
    pick = np.random.default_rng([seed, 1])
    k = int(pick.integers(len(batches)))
    i_sel = family.pick_judged(env.cfg, pick)
    kw = family.entry_kwargs(env, mix["noise_model"])

    def call(b, cfg):
        (x_b, mask), _, bseeds = batches[b]
        gen = torch.Generator(device=env.dev).manual_seed(bseeds[0])
        out = pipeline.enhance_waveform(env.model, x_b, mask, cfg,
                                        generator=gen, seeds=bseeds, **kw)
        return [None if o is None else o.cpu().numpy() for o in out]

    tap = Tap(armed=0 if only_armed else k, i_sel=i_sel, trace=trace,
              profile_from=seconds / 3,
              profile_s=mix["profile_s"]).install(pipeline, family)
    try:
        warm = family.warm_cfg(env.cfg)
        shapes = {}
        for b, ((x_b, _), _, _) in enumerate(batches):
            shapes.setdefault(x_b.shape, b)
        for b in shapes.values():
            call(b, warm)
        if env.dev.type == "cuda":
            torch.cuda.synchronize()
        if trace and env.dev.type == "cuda":
            warm_profiler(env.dev)
        t_setup = time.perf_counter()
        tap.start_window()
        audio = attempted = failed = calls = 0
        rows_s = None
        elapsed = 0.0
        while True:
            b = k if only_armed else calls % len(batches)
            host = call(b, env.cfg)
            calls += 1
            t = time.perf_counter() - tap.window_t0
            (_, mask), idxs, _ = batches[b]
            if tap.record is not None and rows_s is None:
                rows_s = [host[0][j, :len(pcm[i])]
                          for j, i in enumerate(idxs)]
            if elapsed == 0.0:
                attempted += len(idxs)
                failed += int((~host[4].astype(bool)).sum())
                audio += sum(len(pcm[i]) for i in idxs) / signals.FS
                if t >= seconds or only_armed:
                    elapsed = t
            if elapsed and rows_s is not None:
                break
        tap.stop_profile()
    finally:
        tap.uninstall()
    return {"metrics": {"x_realtime": audio / elapsed},
            "attempted": attempted, "failed": failed, "window_s": elapsed,
            "t_setup": t_setup, "t_traffic": t_traffic, "tap": tap,
            "rows_s": rows_s,
            "requests": None, "notes": {"batches": len(batches),
                                        "armed_batch": k, "i_sel": i_sel,
                                        "calls": calls}}
