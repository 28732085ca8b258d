"""Online serving load test (counterpart of the JAX package's
scripts/bench_serving.py): Poisson arrivals into the dynamic-batching
`serving.EnhancementService` on one card.

Requests arrive at `--rate` req/s with durations drawn around `--seconds`,
the collector groups them within `--wait_ms`, and the flagship program (M2
+ DNN classifier + SPP, niter=100 fused MCEM) serves each group. Reports
per-load p50/p95 latency, achieved throughput and mean device batch size
as one JSON line.

Usage: python -m guided_vae_nmf_torch.scripts.bench_serving [--rates 2,8,24]
       [--n 40] [--wait_ms 30] [--niter 100] [--seconds 4.0]
       [--noise_model spp] [--soft_labels 0] [--noise_gain 0]
       [--device cuda|cpu]
"""

import json
import sys
import time

import numpy as np

from ._common import backend_info, device, flag, load_model, load_norm_stats


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rates = [float(r) for r in flag(argv, "rates", "2,8,24").split(",")]
    n_req = flag(argv, "n", 40, int)
    wait_ms = flag(argv, "wait_ms", 30.0, float)
    niter = flag(argv, "niter", 100, int)
    mean_s = flag(argv, "seconds", 4.0, float)
    noise_model = flag(argv, "noise_model", "spp")
    soft = flag(argv, "soft_labels", "0") in ("1", "true")
    noise_gain = flag(argv, "noise_gain", "0") in ("1", "true")
    dev = device(argv)

    from ..mcem import MCEMConfig
    from ..serving import EnhancementService, ServeConfig

    m2 = load_model("artifacts/pretrained/M2_ibm", kind="dgm", y_dim=513,
                    device=dev)
    cls = load_model("artifacts/pretrained/classifier_ibm",
                     kind="classifier", device=dev)
    mean, std = load_norm_stats("artifacts/pretrained/classifier_ibm")

    rng = np.random.RandomState(0)

    def make_request(i):
        dur = np.clip(rng.gamma(4.0, mean_s / 4.0), 1.0, 3 * mean_s)
        return (0.1 * rng.randn(int(16000 * dur))).astype(np.float32)

    out = {"niter": niter, "wait_ms": wait_ms, "n_per_rate": n_req,
           "loads": []}
    sv = ServeConfig(max_wait_ms=wait_ms, noise_model=noise_model,
                     label_mode="dnn", soft_guidance=soft)
    svc = EnhancementService(m2, classifier=cls, mean=mean, std=std,
                             cfg=MCEMConfig(niter=niter,
                                            noise_gain=noise_gain),
                             serve=sv, device=dev)
    try:
        # every (batch, bucket) shape the workload can hit (durations
        # clipped to 1..3*mean_s -> frame buckets) allocated once
        max_frames = int(16000 * 3 * mean_s) // 256 + 8
        buckets = tuple(range(128, -(-max_frames // 128) * 128 + 1, 128))
        t_warm = svc.warmup(buckets=buckets)
        svc.reset_stats()
        print(f"warmup ({len(buckets)} buckets x lattice): "
              f"{t_warm:.1f}s", flush=True)

        for rate in rates:
            reqs = [make_request(i) for i in range(n_req)]
            audio_s = sum(len(x) for x in reqs) / 16000.0
            futs = []
            t0 = time.perf_counter()
            for x in reqs:
                futs.append(svc.submit(x))
                time.sleep(rng.exponential(1.0 / rate))
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            lats = sorted(o["latency_s"] for o in outs)
            row = {
                "offered_req_s": rate,
                "achieved_req_s": round(n_req / wall, 2),
                "audio_s": round(audio_s, 1),
                "rtf": round(audio_s / wall, 1),
                "p50_ms": round(1e3 * lats[len(lats) // 2], 1),
                "p95_ms": round(1e3 * lats[int(0.95 * len(lats))], 1),
                "mean_batch": round(
                    float(np.mean([o["batch_size"] for o in outs])), 2),
            }
            out["loads"].append(row)
            print(row, flush=True)
    finally:
        svc.close()
    out.update(backend_info())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
