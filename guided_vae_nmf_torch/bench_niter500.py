"""Paper-config (500 EM iterations) harness: times the fused MCEM engine at
niter=500 on a (B, F, N) batch in four kernel variants, and optionally
PEEM alone and the PEEM -> MCEM hybrid at the same shape.

    python -m guided_vae_nmf_torch.bench_niter500 [--batch 32] [--n 512]
        [--niter 500] [--peem 0] [--hybrid 0] [--device cuda]

Counterpart of the JAX package's `scripts/bench_niter500.py` without its
`--quality` gate (which needs the reference's subset recordings). Variants:
`exact_f32`; `fast_r2` (bfloat16 sample dumps, approximate reciprocal, no
cost pass); `fast_bf16mm` (fast_r2 with the chains' decoder products on
bfloat16 operands, K1d); `fast_trans_r3` (fast_r2 with the bit-arithmetic
exp / log). `--peem 1` times PEEM at `--niter` iterations; `--hybrid R`
times PEEM at `--niter` iterations followed by R fast MCEM iterations.
Each is run once to warm up and check its Wiener filters, then timed
once. The model is the shipped `artifacts/pretrained/M2_ibm` (F=513,
y_dim=513, L=32, hidden [128, 128]); the spectra and labels are uniform
noise from a seed. Prints one JSON line (keys `<variant>_s`,
`<variant>_rtf`, `peem_*`, `hybrid_*`, `peem_vs_fast_mcem`, and the
device: on the GPU its name and `nvidia-smi`'s name and power limit).
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ._device import resolve_device
from .mcem import (
    MCEMConfig,
    PEEMConfig,
    mcem_batch_fused,
    peem_m2_batch,
    peem_mcem_m2_batch,
)
from .train import load_model

MODEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "pretrained", "M2_ibm")
FAST = dict(samples_dtype=torch.bfloat16, approx_recip=True,
            compute_cost=False)
VARIANTS = {
    "exact_f32": {},
    "fast_r2": FAST,
    "fast_bf16mm": dict(FAST, matmul_dtype=torch.bfloat16),
    "fast_trans_r3": dict(FAST, approx_trans=True),
}


def device_info(dev):
    """The device a record was measured on; on the GPU with nvidia-smi's
    name and power limit."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(dev),
            "gpu": smi.stdout.strip().splitlines()[0]}


def _timed(fn, dev):
    """Seconds of one fn() run, synchronised on the GPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def _warm_and_time(name, fn, dev):
    """One warm-up run whose Wiener filters must be finite with a mean in
    (0, 1), then one timed run. Returns its seconds."""
    wf = fn()["WFs"].float().cpu().numpy()
    mean = float(wf.mean())
    if not (np.all(np.isfinite(wf)) and 0.0 < mean < 1.0):
        raise AssertionError(f"{name}: implausible WFs (mean {mean})")
    dt, _ = _timed(fn, dev)
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=512, help="frames (padded)")
    ap.add_argument("--niter", type=int, default=500)
    ap.add_argument("--peem", type=int, default=0)
    ap.add_argument("--hybrid", type=int, default=0,
                    help="MCEM refinement iterations after PEEM (0: off)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, N = args.batch, args.n

    model = load_model(MODEL_DIR, kind="dgm", y_dim=513, device=dev)
    F, ydim = model.decoder.out.w.shape[1], model.y_dim
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.rand(B, F, N).astype(np.float32) + 0.05,
                     device=dev)
    y = torch.tensor((rng.rand(B, ydim, N) > 0.5).astype(np.float32),
                     device=dev)
    mask = torch.ones((B, N), device=dev)
    cfg = MCEMConfig(niter=args.niter)
    audio_s = B * N * 256 / 16000.0

    def gen():
        return torch.Generator(device=dev).manual_seed(1)

    out = {"batch": B, "n_frames": N, "niter": args.niter,
           "audio_s": audio_s}
    for name, kw in VARIANTS.items():
        dt = _warm_and_time(name, lambda: mcem_batch_fused(
            model, X, mask, y, gen(), cfg, **kw), dev)
        out[name + "_s"] = dt
        out[name + "_rtf"] = audio_s / dt
        print(f"{name}: {dt:.3f}s = {audio_s / dt:.1f}x realtime",
              flush=True)

    pcfg = PEEMConfig(niter=args.niter)
    if args.peem:
        dt = _warm_and_time("peem", lambda: peem_m2_batch(
            model, X, mask, y, gen(), pcfg), dev)
        out["peem_s"] = dt
        out["peem_rtf"] = audio_s / dt
        out["peem_vs_fast_mcem"] = out["fast_bf16mm_s"] / dt
        print(f"peem: {dt:.3f}s = {audio_s / dt:.1f}x realtime", flush=True)

    if args.hybrid:
        mcfg = MCEMConfig(niter=args.hybrid)
        dt = _warm_and_time("hybrid", lambda: peem_mcem_m2_batch(
            model, X, mask, y, gen(), pcfg, mcfg, **FAST), dev)
        out["hybrid_refine"] = args.hybrid
        out["hybrid_s"] = dt
        out["hybrid_rtf"] = audio_s / dt
        print(f"hybrid(peem {args.niter} + mcem {args.hybrid}): {dt:.3f}s = "
              f"{audio_s / dt:.1f}x realtime", flush=True)

    out.update(device_info(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
