"""Kernel times of one checkout on the card, for comparing two checkouts in
one run of the machine: K1a (the cluster chain, exact, NMF form) E and WF
by CUDA events, and K2a / K2b / K2c 'h' and 'g' as device time after a K1
E launch (`graph_ms`), at the main path's shapes (B=4, N=384, the shipped
M2's decoder, MCEMConfig()); where the checkout has them, also the chain
on the (256, 128) M2's decoder (K1g, and K1e where the checkout has it,
the two at the same shapes), K2's wide kernel at rank 32, and K1g
(`form="general"`) on the (512, 512) and (128, 256) decoders of
`chip_smoke.py`'s seeded M2s (h_dim (512, 512) and (256, 128)): E and WF,
NMF (`WH=`) and given-noise (`Vb=`) forms, exact and fast, with the
weights packed as `mcem_batch_fused` hands them over. It times with the
checkout's own `chip_smoke.py` helpers and kernels, and records the ptxas
lines (registers and spills a kernel) of the chain's three libraries and
K2's. With --e2e it also times the main batch (`chip_smoke.phase_main`,
three runs) of the shipped M2 and of the (512, 512) M2 and records their
x realtime.

Usage: python3 guided_vae_nmf_torch/scripts/bench_kernels.py
       [--tree <checkout root>] [--reps 3] [--e2e] [--out <file.json>]

--tree puts that checkout first on the import path (its package, its
kernels, built into its own build directory), so that a parent and a
change can run one after the other in one call (parent, change, change,
parent). Prints one JSON line: the card, its power limit, the ptxas
lines and the ms of each kernel over `--reps` timings.
"""

import argparse
import inspect
import json
import os
import re
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs an NVIDIA GPU")
    import chip_smoke as cs
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig, mh_chain
    from guided_vae_nmf_torch.mcem.mh_chain import pack_weights
    from guided_vae_nmf_torch.train import load_model

    dev = torch.device("cuda", 0)
    build_s = _build.build_all()
    # ptxas lines, the anonymous namespace's hash (it follows the file's
    # path) taken out of the mangled names
    ptxas = {lib: {re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}", r"\1", k): v
                   for k, v in cs.ptxas_report(_build.build_log(lib)).items()}
             for lib in ("mh_chain", "mh_chain_ext", "mh_chain_general",
                         "nmf_sums")}
    model = load_model(os.path.join(tree, "artifacts", "pretrained",
                                    "M2_ibm"), kind="dgm", y_dim=513,
                       device=dev)
    cfg = MCEMConfig()
    B, N, R = 4, 384, cfg.nsamples_E_step
    c = cs.chain_inputs(torch, model, B, N, cfg.nmf_rank, 7, dev)
    c["dec_w"] = pack_weights(c["dec_w"])
    gpu = cs.gpu_name_and_limit()
    out = {"tree": tree, "gpu": gpu, "build_s": build_s, "ptxas": ptxas,
           "ms": {}}
    forms = "form" in inspect.signature(mh_chain).parameters

    def add(key, ms):
        out["ms"].setdefault(key, []).append(ms)

    def k1g_inputs():
        """K1g's inputs on the (512, 512) and (128, 256) decoders, seeded
        as chip_smoke's times_domain seeds them, packed for K1g where the
        checkout packs it."""
        mc = sys.modules["guided_vae_nmf_torch.mcem.mh_chain"]
        cases = {}
        for h_dim, off in ((cs.GENERAL_H_DIM, 23), (cs.DOMAIN_H_DIMS[0], 20)):
            m = cs.domain_model(torch, h_dim, off, dev)
            c = cs.chain_inputs(torch, m, B, N, cfg.nmf_rank, 7, dev)
            if hasattr(mc, "pack_general"):
                c["dec_w"] = mc.pack_general(c["dec_w"])
            cases[str(mc.widths(c["dec_w"]))] = c
        return cases

    k1g = (k1g_inputs() if forms and hasattr(cs, "GENERAL_H_DIM") else {})
    for _ in range(args.reps):
        for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                             ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
            add(f"mh_chain_{mode}_wh", cs.time_cuda(lambda: cs.run_chain(
                c, mh_chain, mode, ns, bi, cfg.var_RW, seed=1)))
        for vb in (False, True):
            for level in ("", "_fast"):
                for key, row in cs.time_sums(torch, c, vb, level, cfg,
                                             gpu).items():
                    add(key, row["ms"])
        if hasattr(cs, "domain_model"):
            m = cs.domain_model(torch, cs.DOMAIN_H_DIMS[0], 20, dev)
            cg = cs.chain_inputs(torch, m, B, N, cfg.nmf_rank, 7, dev)
            if forms:
                from guided_vae_nmf_torch.mcem.mh_chain import \
                    pack_for_chain

                cg["dec_w"] = pack_for_chain(cg["dec_w"], 513, cg["L"],
                                             cfg.nmf_rank, N)
                mc = sys.modules["guided_vae_nmf_torch.mcem.mh_chain"]
                if hasattr(mc, "pack_general"):
                    cg["dec_w"] = mc.pack_general(cg["dec_w"])
            for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                                 ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
                # K1g, and K1e at the same shapes where the checkout has it
                for tag, kw in ((("_gen", dict(form="general")),
                                 ("_ext", {})) if forms
                                else (("_gen", {}),)):
                    add(f"mh_chain_{mode}_wh{tag}", cs.time_cuda(
                        lambda: cs.run_chain(cg, mh_chain, mode, ns, bi,
                                             cfg.var_RW, seed=1, **kw)))
            cw = cs.chain_inputs(torch, model, B, N, cs.DOMAIN_RANK, 7, dev)
            cw["dec_w"] = pack_weights(cw["dec_w"])
            for level in ("", "_fast"):
                for key, row in cs.time_sums(torch, cw, False, level, cfg,
                                             gpu).items():
                    add(key, row["ms"])
        for ws, c in k1g.items():
            for vb, nform in ((False, "wh"), (True, "vb")):
                for level in ("", "_fast"):
                    kw = cs.fast_kw(torch, level)
                    for mode, ns, bi in (
                            ("e", R, cfg.burnin_E_step),
                            ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
                        add(f"k1g {ws} {mode}_{nform}{level}",
                            cs.time_cuda(lambda: cs.run_chain(
                                c, mh_chain, mode, ns, bi, cfg.var_RW,
                                vb=vb, seed=1, form="general", **kw)))
    if args.e2e:
        out["x_realtime"] = e2e(torch, cs, model, cfg, tree, dev, gpu)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


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
