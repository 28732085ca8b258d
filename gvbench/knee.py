"""Find the highest rate the service sustains: the serve loop at each
rate in turn (one set-up), printing the backlog (requests sent and not yet
served) at a third, two thirds and the end of each window, the latency
tail and the mean batch. The knee is the highest rate whose backlog does
not grow over the window; a serve mix runs at about four fifths of it.

    python3 gvbench/knee.py --workload m2_ibm.serve --rates 6,8,10 \
        [--seconds 30] [--seed 1]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--drain", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    from gvbench.harness import serve
    from gvbench.harness.layout import Layout

    if not torch.cuda.is_available():
        print("knee: needs a CUDA device", file=sys.stderr)
        return 2
    lay = Layout()
    cell = lay.workload(args.workload)
    mix = dict(lay.traffic(cell["traffic"]), drain_s=args.drain)
    config = lay.config(cell["config"])
    family = lay.family(config)
    env = family.setup(lay.root, config, "cuda:0")
    for rate in (float(r) for r in args.rates.split(",")):
        res = serve.run(family, env, mix, args.seconds, False, args.seed,
                        rate=rate)
        sizes = res["requests"]["batch_sizes"]
        print(json.dumps({
            "rate_per_s": rate, "backlog": res["notes"]["backlog"],
            "failed": res["failed"], "requests": res["attempted"],
            **{k: v for k, v in res["metrics"].items()},
            "mean_batch": sum(sizes) / max(1, len(sizes)),
            "sender_late_ms_max": res["notes"]["sender_late_ms_max"]}),
            flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
