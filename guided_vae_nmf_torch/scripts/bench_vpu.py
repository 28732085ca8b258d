"""Elementwise roofline probe of the card (counterpart of the JAX package's
scripts/bench_vpu.py, which probed the TPU's vector unit and HBM).

  1. streamed: each op (add, exp, log, tanh, reciprocal) as one PyTorch
     elementwise kernel from a device tensor of `--m` float32 into another,
     `--iters` times: 4 B read and 4 B written an element, so the rate is
     the memory's, reported in Gelem/s and as a share of the HBM peak
     (3.35 TB/s, NVIDIA's figure for the H100 SXM at 700 W);
  2. chained: the same ops, in the JAX package's stable forms (exp(-|c|) +
     0.1, log(c + 1.1), ...), applied `--inner` deep to a tensor of m / 16
     elements, `--iters` / 8 times. Eager PyTorch runs each op of the
     chain as its own kernel, so this measures the unfused chain.

Times end at a device synchronize. At the default `--m` (32 MiB of float32
a tensor) each streamed kernel is short enough that its launch gap shows,
and the pass's two tensors do not stay in the H100's 50 MB L2 cache
together; an `--m` of 2^28 (1 GiB a tensor) measures HBM.

Usage: python -m guided_vae_nmf_torch.scripts.bench_vpu [--m 8388608]
       [--iters 400] [--inner 64] [--device cuda|cpu]
"""

import json
import sys
import time

import numpy as np

from ._common import backend_info, device, flag

HBM_PEAK = 3.35e12   # bytes/s


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    M = flag(argv, "m", 8 * 1024 * 1024, int)
    iters = flag(argv, "iters", 400, int)
    inner = flag(argv, "inner", 64, int)
    dev = device(argv)

    import torch

    streamed = {
        "add": lambda x, y: torch.add(x, 1.000001e-6, out=y),
        "exp": lambda x, y: torch.exp(x, out=y),
        "log": lambda x, y: torch.log(x, out=y),
        "tanh": lambda x, y: torch.tanh(x, out=y),
        "recip": lambda x, y: torch.reciprocal(x, out=y),
    }
    chained = {
        "add": lambda c: c + 1.000001e-6,
        "exp": lambda c: torch.exp(-torch.abs(c)) + 0.1,
        "log": lambda c: torch.log(c + 1.1),
        "tanh": lambda c: torch.tanh(c) + 0.2,
        "recip": lambda c: 1.0 / (c + 1.0),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(run, ops):
        """Gelem/s of run() (one warm-up call, then one timed call)."""
        v = float(run())
        sync()
        t0 = time.perf_counter()
        v = float(run())
        sync()
        dt = time.perf_counter() - t0
        if not np.isfinite(v):
            raise AssertionError(f"non-finite result {v}")
        return ops / dt / 1e9

    out = {"m": M, "iters": iters, "inner": inner,
           "streamed_gelem_s": {}, "fused_gelem_s": {},
           "hbm_share": {}}

    x = torch.tensor(np.random.RandomState(0).rand(M).astype(np.float32)
                     + 0.1, device=dev)
    y = torch.empty_like(x)
    for name, fn in streamed.items():
        def run(fn=fn):
            for _ in range(iters):
                fn(x, y)
            return y.sum()

        g = timed(run, M * iters)
        out["streamed_gelem_s"][name] = round(g, 1)
        out["hbm_share"][name] = round(g * 1e9 * 8 / HBM_PEAK, 4)
        print(f"streamed {name:>6}: {g:7.1f} Gelem/s "
              f"({100 * out['hbm_share'][name]:.1f} % of HBM peak)",
              flush=True)
    del x, y

    xs = torch.tensor(
        np.random.RandomState(0).rand(M // 16).astype(np.float32) + 0.1,
        device=dev)
    passes = max(1, iters // 8)
    for name, fn in chained.items():
        def run(fn=fn):
            c = xs
            for _ in range(passes):
                for _i in range(inner):
                    c = fn(c)
            return c.sum()

        g = timed(run, (M // 16) * passes * inner)
        out["fused_gelem_s"][name] = round(g, 1)
        print(f"fused    {name:>6}: {g:7.1f} Gelem/s", flush=True)

    hbm = out["streamed_gelem_s"]["add"] * 8 / 1e3   # f32 in+out per elem
    out["implied_hbm_gb_s"] = round(hbm * 1e3, 0)
    out["hbm_peak_gb_s"] = HBM_PEAK / 1e9
    out.update(backend_info())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
