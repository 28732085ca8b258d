"""Kernel times of one checkout on the card, for comparing two checkouts in
one run of the machine: K1a (the cluster chain, exact, NMF form) E and WF
by CUDA events, and K2a / K2b / K2c 'h' and 'g' as device time after a K1
E launch (`graph_ms`), at the main path's shapes (B=4, N=384, the shipped
M2's decoder, MCEMConfig()); also the chain on the (256, 128) M2's decoder
(K1g and K1e at the same shapes), K2's wide kernel at rank 32, and K1g
(a plan's `form="general"`) on the (512, 512) and (128, 256) decoders of
`chip_smoke.py`'s seeded M2s (h_dim (512, 512) and (256, 128)): E and WF,
NMF (`WH=`) and given-noise (`Vb=`) forms, exact and fast, with the
decoder planned once as `mcem_batch_fused` plans it
(`mh_chain.plan_chain`). It times with the checkout's own `chip_smoke.py`
helpers and kernels, and records the ptxas lines (registers and spills a
kernel) of the chain's three libraries, K2's, the RVAE's sweeps' and the
cost kernel's. With --e2e it also times the main batch
(`chip_smoke.phase_main`, three runs) of the shipped M2 and of the (512,
512) M2 and records their x realtime. K1a E and WF also run at a padded
sweep shape, B=16, N=512 with the frame counts of one of the offline
sweep's 512-frame batches (`SWEEP_512`), with every tile pair computed
(`_b16n512_all`) and with its dead pairs skipped (`_b16n512`); and at the
main path's shapes with every pair's flag set (`_flags`, no pair dead).
The RVAE's sweep kernels (`mcem.lstm_sweep`) run each alone at B=64,
N=256 (the published widths, every frame valid), with their least time
at the card's float32 peak and HBM bandwidth, their share of it, and the
plain loops' time; and the EM cost kernel (`mcem.em_cost`) beside K2's
'g' pass at the sweep and RVAE shapes (`chip_smoke.time_cost`). The
checkout must plan its chain's decoder (`mh_chain.plan_chain`); an older
checkout is timed by its own copy of this script.

With --replay <cell> it times no kernel and instead replays one pass of a
sweep cell of the checkout's benchmark (`gvbench/`: its traffic, batch
plan and program set-up at `--seed`), so that two checkouts run the very
same batches: one pass to warm, two timed passes, then one pass under
`torch.profiler` with the program's spans on. It records the pass's
audio, padded and valid frames, the untraced seconds of each pass, and of
the traced one its seconds, the card's busy seconds, each span's device
ms summed over the pass with its counts, and the device seconds by kernel
name.

Usage: python3 guided_vae_nmf_torch/scripts/bench_kernels.py
       [--tree <checkout root>] [--reps 3] [--e2e] [--out <file.json>]
       [--replay <cell> [--seed <n>]]

--tree puts that checkout first on the import path (its package, its
kernels, built into its own build directory), so that a parent and a
change can run one after the other in one call (parent, change, change,
parent). Prints one JSON line: the card, its power limit, the ptxas
lines and the ms of each kernel over `--reps` timings.
"""

import argparse
import json
import os
import re
import sys


# The valid frames of each row of one of the offline sweep's batches at
# N=512 (16 utterances of 4.2-5.1 s by plan_batches' 128-frame buckets):
# 227 of its 256 tile pairs hold a valid frame.
SWEEP_512 = (389, 392, 398, 401, 405, 416, 419, 432, 441, 446, 456, 468,
             474, 481, 488, 505)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--replay", default=None, metavar="CELL")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs an NVIDIA GPU")
    import chip_smoke as cs
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig, mh_chain
    from guided_vae_nmf_torch.mcem.mh_chain import live_pairs, widths
    from guided_vae_nmf_torch.train import load_model

    dev = torch.device("cuda", 0)
    build_s = _build.build_all()
    # ptxas lines, the anonymous namespace's hash (it follows the file's
    # path) taken out of the mangled names
    libs = ("mh_chain", "mh_chain_ext", "mh_chain_general", "nmf_sums",
            "lstm_sweep", "em_cost")
    ptxas = {lib: {re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}", r"\1", k): v
                   for k, v in cs.ptxas_report(_build.build_log(lib)).items()}
             for lib in libs}
    if args.replay:
        out = {"tree": tree, "gpu": cs.gpu_name_and_limit(),
               "build_s": build_s, "ptxas": ptxas,
               "replay": replay(torch, tree, args.replay, args.seed)}
        return write(out, args.out)
    model = load_model(os.path.join(tree, "artifacts", "pretrained",
                                    "M2_ibm"), kind="dgm", y_dim=513,
                       device=dev)
    cfg = MCEMConfig()
    B, N, R = 4, 384, cfg.nsamples_E_step
    # chip_smoke's run_chain plans each input set's decoder once, as
    # mcem_batch_fused does, so no timed launch plans or packs
    c = cs.chain_inputs(torch, model, B, N, cfg.nmf_rank, 7, dev)
    gpu = cs.gpu_name_and_limit()
    out = {"tree": tree, "gpu": gpu, "build_s": build_s, "ptxas": ptxas,
           "ms": {}}
    cp = cs.chain_inputs(torch, model, len(SWEEP_512), 512, cfg.nmf_rank, 7,
                         dev)
    cp["mask"] = (torch.arange(512, device=dev)[None] < torch.tensor(
        SWEEP_512, device=dev)[:, None]).float()
    padded = {"_b16n512_all": (cp, {}),
              "_b16n512": (cp, dict(live=live_pairs(cp["mask"]))),
              "_flags": (c, dict(live=torch.ones(
                  (B, N // 32), dtype=torch.bool, device=dev)))}

    def add(key, ms):
        out["ms"].setdefault(key, []).append(ms)

    # K1g's inputs on the (512, 512) and (128, 256) decoders, seeded as
    # chip_smoke's times_domain seeds them
    k1g = {}
    for h_dim, off in ((cs.GENERAL_H_DIM, 23), (cs.DOMAIN_H_DIMS[0], 20)):
        ck = cs.chain_inputs(torch, cs.domain_model(torch, h_dim, off, dev),
                             B, N, cfg.nmf_rank, 7, dev)
        k1g[str(widths(ck["dec_w"]))] = ck
    cg = cs.chain_inputs(torch, cs.domain_model(
        torch, cs.DOMAIN_H_DIMS[0], 20, dev), B, N, cfg.nmf_rank, 7, dev)
    cw = cs.chain_inputs(torch, model, B, N, cs.DOMAIN_RANK, 7, dev)
    for _ in range(args.reps):
        for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                             ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
            add(f"mh_chain_{mode}_wh", cs.time_cuda(lambda: cs.run_chain(
                c, mh_chain, mode, ns, bi, cfg.var_RW, seed=1)))
            for tag, (cc, kw) in padded.items():
                add(f"mh_chain_{mode}_wh{tag}", cs.time_cuda(
                    lambda: cs.run_chain(cc, mh_chain, mode, ns, bi,
                                         cfg.var_RW, seed=1, **kw)))
        for vb in (False, True):
            for level in ("", "_fast"):
                for key, row in cs.time_sums(torch, c, vb, level, cfg,
                                             gpu).items():
                    add(key, row["ms"])
        for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                             ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
            # K1g, and K1e at the same shapes
            for tag, form in (("_gen", "general"), ("_ext", "auto")):
                add(f"mh_chain_{mode}_wh{tag}", cs.time_cuda(
                    lambda: cs.run_chain(cg, mh_chain, mode, ns, bi,
                                         cfg.var_RW, seed=1, form=form)))
        for level in ("", "_fast"):
            for key, row in cs.time_sums(torch, cw, False, level, cfg,
                                         gpu).items():
                add(key, row["ms"])
        for ws, ck in k1g.items():
            for vb, nform in ((False, "wh"), (True, "vb")):
                for level in ("", "_fast"):
                    kw = cs.fast_kw(torch, level)
                    for mode, ns, bi in (
                            ("e", R, cfg.burnin_E_step),
                            ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
                        add(f"k1g {ws} {mode}_{nform}{level}",
                            cs.time_cuda(lambda: cs.run_chain(
                                ck, mh_chain, mode, ns, bi, cfg.var_RW,
                                vb=vb, seed=1, form="general", **kw)))
    out["rvae_sweeps"] = rvae_sweeps(torch, cs, dev, args.reps)
    out["em_cost"] = cs.time_cost(torch, dev, args.reps)
    if args.e2e:
        out["x_realtime"] = e2e(torch, cs, model, cfg, tree, dev, gpu)
    return write(out, args.out)


def rvae_sweeps(torch, cs, dev, reps, B=64, N=256, L=16, Hn=128):
    """The RVAE decoder's forward and backward sweep kernels, each alone,
    at B=64, N=256 on a seeded RVAE of the published widths: ms of each
    (median of `reps` timings), the plain loops' ms, and the bound: the
    benchmark's work counts of one sweep (`gvbench.families.rvae.
    sweep_work`) at the card's float32 peak and HBM bandwidth, the
    larger."""
    from gvbench.families.rvae import sweep_work
    from guided_vae_nmf_torch.mcem import lstm_sweep as ls
    from guided_vae_nmf_torch.mcem.rvae_engine import decoder_parts
    from guided_vae_nmf_torch.models.rvae import bilstm_scan, rvae_init

    model = rvae_init(torch.Generator().manual_seed(1910),
                      [513, L, Hn, [Hn]]).to(dev)
    dec = decoder_parts(model)
    g = torch.Generator(device=dev).manual_seed(5)
    Z = torch.randn((B, N, L), generator=g, device=dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    Hout, save = ls.forward_sweep(Z, lengths, *dec[:3])
    dH = torch.randn((B, N, 2 * Hn), generator=g, device=dev) * 0.1
    work = sweep_work(B * N, L, Hn, B)
    runs = {"fwd": lambda: ls.forward_sweep(Z, lengths, *dec[:3]),
            "bwd": lambda: ls.backward_sweep(dH, save, lengths, *dec[:2])}
    plain = {"fwd": lambda: bilstm_scan(Z, lengths, *dec[:3], keep=True),
             "bwd": lambda: ls.backward_sweep_ref(dH, save, lengths,
                                                  *dec[:2])}
    out = {"rows_per_cluster": ls.rows_per_cluster(B, dev)}
    for k in ("fwd", "bwd"):
        ms = sorted(cs.time_cuda(runs[k]) for _ in range(reps))
        flops, nbytes = work[k]
        bound = 1e3 * max(flops / cs.PEAK_F32_FLOPS, nbytes / cs.PEAK_BYTES)
        out[k] = {"ms": ms[len(ms) // 2], "bound_ms": bound,
                  "by": "ops" if flops / cs.PEAK_F32_FLOPS
                  >= nbytes / cs.PEAK_BYTES else "bytes",
                  "share": bound / ms[len(ms) // 2],
                  "plain_ms": cs.time_cuda(plain[k], launches=1, reps=1),
                  "us_a_timestep": 1e3 * ms[len(ms) // 2] / N}
    return out


def write(out, path):
    line = json.dumps(out)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


def replay(torch, tree, cell, seed):
    """One pass of the sweep cell `cell`'s batches at `seed`, in the
    plan's order, as the benchmark's sweep calls them (each batch's
    outputs fetched to the host): warmed by one pass, timed by two, then
    traced by one (see the module's docstring)."""
    import time
    from collections import defaultdict
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from gvbench.harness import program, signals
    from gvbench.harness.layout import Layout
    from gvbench.harness.trace import events, union_length, warm_profiler
    from guided_vae_nmf_torch import pipeline
    from guided_vae_nmf_torch.ops.profiling import reset_spans, span_records

    lay = Layout(root=Path(tree))
    w = lay.workload(cell)
    mix = lay.traffic(w["traffic"])
    env = program.setup(lay.root, lay.config(w["config"]), "cuda:0")
    lens, snrs, useeds, _ = signals.draw(seed, mix["pool"], mix["length_s"],
                                         mix["snr_db"])
    pcm = signals.mixtures(lens, snrs, useeds, env.dev)
    plan = signals.plan_batches([signals.frame_count(len(x)) for x in pcm],
                                mix["batch_size"], mix["bucket_frames"],
                                seed)
    batches = [(signals.padded([pcm[i] for i in idxs], n_pad),
                [int(s) for s in bseeds]) for idxs, n_pad, bseeds in plan]
    kw = program.entry_kwargs(env, mix["noise_model"])

    def one_pass():
        t0 = time.perf_counter()
        for (x_b, mask), bseeds in batches:
            gen = torch.Generator(device=env.dev).manual_seed(bseeds[0])
            for o in pipeline.enhance_waveform(
                    env.model, x_b, mask, env.cfg, generator=gen,
                    seeds=bseeds, **kw):
                if o is not None:
                    o.cpu()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    one_pass()
    untraced_s = [one_pass(), one_pass()]
    warm_profiler(env.dev)
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = one_pass()
    dev, _ = events(prof)
    kernels = defaultdict(float)
    for name, a, b in dev:
        kernels[name] += (b - a) / 1e6
    spans = {}
    for r in span_records():
        sp = spans.setdefault(r["name"], {"calls": 0, "device_ms": 0.0,
                                          "counts": defaultdict(int)})
        sp["calls"] += 1
        sp["device_ms"] += r["device_ms"] or 0.0
        for k, v in r["counts"].items():
            sp["counts"][k] += v
    return {"cell": cell, "seed": seed, "batches": len(batches),
            "audio_s": sum(len(x) for x in pcm) / signals.FS,
            "padded_frames": sum(int(m.shape[0] * m.shape[1])
                                 for (_, m), _ in batches),
            "valid_frames": sum(int((m > 0).sum()) for (_, m), _ in batches),
            "untraced_s": untraced_s, "traced_s": traced_s,
            "busy_s": union_length((a, b) for _, a, b in dev) / 1e6,
            "spans": spans,
            "kernels_s": dict(sorted(kernels.items(), key=lambda t: -t[1]))}


def e2e(torch, cs, model, cfg, tree, dev, gpu):
    """x realtime of the main batch (three runs, the median of the last
    two) with the shipped M2 and with the (512, 512) M2, dnn labels from
    the shipped classifier, engine="auto"."""
    from guided_vae_nmf_torch.train import (load_model, load_norm_stats)

    cdir = os.path.join(tree, "artifacts", "pretrained", "classifier_ibm")
    classifier = load_model(cdir, kind="classifier", device=dev)
    mean, std = load_norm_stats(cdir)
    batch = cs.main_batch(0)
    out = {}
    for name, m, launches in (
            ("shipped", model, cs.MAIN_LAUNCHES),
            (str(cs.GENERAL_H_DIM), cs.domain_model(torch, cs.GENERAL_H_DIM,
                                                    23, dev),
             cs.GEN_LAUNCHES)):
        r = cs.phase_main(torch, m, classifier, mean, std, cfg, batch, 0,
                          dev, gpu, launches=launches, label=name)
        out[name] = r["x_realtime"]
    return out


if __name__ == "__main__":
    main()
