"""The readings the correctness limits are set from: for each seed, one
short run of a cell (the sweep's armed batch alone; the service for a
short window at the cell's rate), checked twice against the cell's
family's reference: the program's readings, and the control's, the
reference in TF32 put in the program's place. Set-up is paid once for all
seeds.

    python3 gvbench/control.py --workload m2_ibm.sweep16 \
        --seeds 11,12,13 --control 11,12,13 [--seconds 8]

Prints a line a seed and, last, the largest program reading and the
smallest control reading of each number. Needs an NVIDIA GPU unless
--cpu is given (tests)."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, root=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from gvbench.harness import serve, sweep
    from gvbench.harness.layout import Layout

    lay = Layout(root=root)
    cell = lay.workload(args.workload)
    config = lay.config(cell["config"])
    family = lay.family(config)
    mix = lay.traffic(cell["traffic"])
    if not args.cpu and not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    env = family.setup(lay.root, config, "cpu" if args.cpu else "cuda:0")
    ref = family.Reference(lay.root, config, env.dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    worst, least = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        if mix["loop"] == "sweep":
            res = sweep.run(family, env, mix, 0.0, False, seed,
                            only_armed=True)
        else:
            res = serve.run(family, env, mix, args.seconds,
                            bool(args.trace), seed)
        rec = res["tap"].record
        line = {"seed": seed, "failed": res["failed"]}
        nums, err = family.readings(rec, ref, res["rows_s"])
        line["program"], line["err"] = nums, err
        for k, v in nums.items():
            if k != "where":
                worst[k] = max(worst.get(k, v), v)
        if seed in control:
            cn, cerr = family.readings(rec, ref, res["rows_s"],
                                       subject="tf32")
            line["control"], line["control_err"] = cn, cerr
            for k, v in cn.items():
                if k != "where":
                    least[k] = min(least.get(k, v), v)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del res, rec
        if env.dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "program_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
