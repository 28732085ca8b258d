"""Run one cell of the benchmark once and print its result line.

    python3 gvbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<name>.json`, whose `family` names its model family
`families/<family>.py`, `mh_mcem` by default) and a traffic mix
(`traffic/<name>.json`, whose `loop` is "sweep" or "serve"); its
correctness limits are `limits/<cell>.json` and each per-layer metric is
read by `metrics/<metric>.py`. With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a profiled
sub-window. Every run checks the armed batch against the family's plain
reference and prints each number beside its limit (`harness/check.py`),
as the last lines on stderr and under "checks", last in the line.

Needs an NVIDIA GPU: without one (or with fewer cards than the cell asks
for) it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "guided_vae_nmf_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _context(res, family, env, tap):
    """What a per-layer metric reads: the profiled batches' work and
    device times, and the served requests."""
    from gvbench.harness import bounds
    from gvbench.harness.trace import Profile, events

    class Ctx:
        pass

    ctx = Ctx()
    ctx.requests = res["requests"]
    ctx.profile = None
    if tap.prof is None or tap.prof_span is None:
        return ctx
    first, end, window_s = tap.prof_span
    dev, host = events(tap.prof)
    if not dev:             # no device event: no device metric is read
        return ctx
    work = [family.batch_work(b["frames"], b["rows"], env, env.noise_model)
            for b in tap.batches[first:end]]
    ctx.profile = Profile(dev, host, window_s, work)
    ctx.n_batches = len(work)
    ctx.window_s = window_s
    ctx.busy_s = ctx.profile.busy_s
    ctx.flops = sum(w["flops"] for w in work)
    ctx.kernel_s = ctx.profile.seconds
    ctx.bound_s = lambda key: sum(bounds.seconds(*w[key]) for w in work)
    ctx.peak_flops = bounds.PEAK_F32_FLOPS
    return ctx


def main(argv=None, require_cuda=True, root=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gvbench.harness.layout import Layout

    lay = Layout(root=root)
    cell = lay.workload(args.workload)
    split = {}          # seconds from process start to each set-up step
    try:
        import torch
    except ImportError as exc:
        print(f"gvbench: {exc}", file=sys.stderr)
        return 2
    split["import_torch"] = time.perf_counter() - T_START
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_cuda and cards < cell["chips"]:
        print(f"gvbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    try:
        import guided_vae_nmf_torch  # noqa: F401
    except ImportError as exc:
        print(f"gvbench: the program is not importable ({exc})",
              file=sys.stderr)
        return 2
    from gvbench.harness import check, serve, sweep

    config = lay.config(cell["config"])
    family = lay.family(config)
    split["import_program"] = time.perf_counter() - T_START

    mix = lay.traffic(cell["traffic"])
    limits = lay.limits(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    env = family.setup(lay.root, config, device)
    split["models"] = time.perf_counter() - T_START
    env.noise_model = mix.get("noise_model", mix.get("serve", {}).get(
        "noise_model", "nmf"))
    loop = {"sweep": sweep, "serve": serve}[mix["loop"]]
    res = loop.run(family, env, mix, args.seconds, bool(args.trace),
                   args.seed)
    setup_s = res["t_setup"] - T_START
    cuda = env.dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(env.dev) if cuda else 0
    tap = res["tap"]
    out = {"correct": False, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {}}
    metrics = lay.metrics(args.workload, args.trace)
    ctx = _context(res, family, env, tap) if args.trace else None
    for m in metrics:
        if args.trace:
            v = lay.reader(m["name"])(ctx)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = res["metrics"].get(m["name"])
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(env.dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if args.trace and ctx.profile is not None:
        out["device"]["busy_s"] = ctx.busy_s
        out["device"]["window_s"] = ctx.window_s
        out["breakdown"] = {"device_ops": ctx.profile.top_ops(),
                            "idle_gaps": ctx.profile.idle_gaps()}
    split["traffic"] = res["t_traffic"] - T_START
    split["warm"] = setup_s
    notes = dict(res["notes"], setup_s=setup_s, setup_split=split,
                 build_s=env.build_s,
                 window_s=res["window_s"], seed=args.seed)
    if args.trace and ctx.profile is not None:
        notes["profiled_batches"] = ctx.n_batches
    if cuda:
        notes["card"] = _power_limit()
        from guided_vae_nmf_torch import launch_counts
        notes["launches"] = launch_counts()
    print("gvbench notes: " + json.dumps(notes, default=str))

    # the check: the program's state is freed but for the armed batch's
    rec, rows_s = tap.record, res["rows_s"]
    res = tap.batches = tap.prof = ctx = None
    err = "the armed batch was not recorded" if rec is None else None
    nums = {}
    if rec is not None:
        ref = family.Reference(lay.root, config, env.dev)
        del env
        if cuda:
            torch.cuda.empty_cache()
        try:
            nums, err = family.readings(rec, ref, rows_s)
        except Exception:                          # noqa: BLE001
            import traceback
            err = "the check raised: " + traceback.format_exc(limit=4)
    ok, rows = check.verdict(nums, limits, err)
    out["correct"] = bool(ok)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    bad = forbidden_modules()
    if bad:
        print(f"gvbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    print("gvbench readings: " + json.dumps(nums), file=sys.stderr)
    if err:
        print(f"gvbench check: {err}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
