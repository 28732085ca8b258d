"""Minimal online-serving demo (counterpart of the JAX package's
examples/demo_serving.py): one client thread per test utterance against
the dynamic-batching EnhancementService with the shipped flagship models
(M2 + DNN classifier + SPP noise, MCEM at niter=100).

Usage: python -m guided_vae_nmf_torch.examples.demo_serving
       [--data_root data/subset] [--niter 100] [--device cuda|cpu]
       [--artifacts artifacts/pretrained]
"""

import os
import sys
import threading

from ..data import read_wav, speech_list
from ..mcem import MCEMConfig
from ..metrics import energy_ratios
from ..serving import EnhancementService, ServeConfig
from ..train import load_model, load_norm_stats
from ._args import device, parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--niter", type=int, default=100,
                    help="MCEM iterations a request")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device(args)
    art = args.artifacts
    m2 = load_model(os.path.join(art, "M2_ibm"), kind="dgm", device=dev)
    cls = load_model(os.path.join(art, "classifier_ibm"), kind="classifier",
                     device=dev)
    mean, std = load_norm_stats(os.path.join(art, "classifier_ibm"))

    files = speech_list(os.path.join(args.data_root, "raw") + "/", "test")
    proc = os.path.join(args.data_root, "processed")

    svc = EnhancementService(
        m2, classifier=cls, mean=mean, std=std,
        cfg=MCEMConfig(niter=args.niter),
        serve=ServeConfig(noise_model="spp", max_wait_ms=30.0), device=dev)
    try:
        results = {}

        def client(name):
            base = os.path.join(proc, os.path.splitext(name)[0])
            x, _ = read_wav(base + "_x.wav")
            out = svc.enhance(x)           # blocking convenience wrapper
            s_ref, _ = read_wav(base + "_s.wav")
            n_ref, _ = read_wav(base + "_n.wav")
            L = min(len(s_ref), len(out["s"]))
            results[name] = (
                energy_ratios(x[:L], s_ref[:L], n_ref[:L])[0],
                energy_ratios(out["s"][:L], s_ref[:L], n_ref[:L])[0],
                out["latency_s"], out["batch_size"],
            )

        threads = [threading.Thread(target=client, args=(f,))
                   for f in files]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        for name, (si_in, si_out, lat, bs) in sorted(results.items()):
            print(f"{os.path.basename(name):<16} SI-SDR {si_in:+.2f} -> "
                  f"{si_out:+.2f} dB   latency {lat:.2f}s  "
                  f"(batch of {bs})")
        stats = svc.stats()
        print("service stats:", stats)
    finally:
        svc.close()
    return {"results": results, "stats": stats}


if __name__ == "__main__":
    main()
