"""Render the VALIDATION.md campaign tables from a campaign record
(counterpart of the JAX package's scripts/campaign_tables.py, whose output
it reproduces byte for byte).

Pure-JSON tooling: reads the record written by eval_campaign
(campaign_results.json / CAMPAIGN_r*.json)
and prints the markdown tables (per-metric per-SNR mean +/- 95% CI,
seed-spread table, objective-measure ordering) exactly as pasted into
VALIDATION.md, so the committed tables are regenerable from the
committed record.

Usage: python -m guided_vae_nmf_torch.scripts.campaign_tables
       [--json CAMPAIGN_r05.json] [--metrics SI-SDR,ESTOI,PESQ]
       [--systems a,b,...]
       [--by_family SI-SDR]   # per-noise-family means (self-contained
                              # records: config.corpus_entries)

Without the --json file, reads eval_campaign's default record,
`<temp dir>/gvnmf_campaign/campaign_results.json`.
"""

import json
import os
import sys
import tempfile

# display labels for the system tags (order = table row order)
LABELS = [
    ("mixture", "mixture floor"),
    ("m2dnn_reference", "M2 + DNN (reference parity)"),
    ("m2oracle_reference", "M2 + oracle IBM (reference parity)"),
    ("m2dnn_real-noise", "M2 + DNN, `real-noise` profile"),
    ("m2oracle_real-noise", "M2 + oracle IBM, `real-noise` profile"),
    ("m2dnn_impulse-noise", "M2 + DNN, `impulse-noise` profile"),
    ("m2oracle_impulse-noise", "M2 + oracle IBM, `impulse-noise` profile"),
    ("m2vaddnn_real-noise", "M2-VAD + DNN, `real-noise` profile"),
    ("m2vadoracle_real-noise", "M2-VAD + oracle, `real-noise` profile"),
    ("m2vaddnn_impulse-noise", "M2-VAD + DNN, `impulse-noise` profile"),
    ("m2vadoracle_impulse-noise", "M2-VAD + oracle, `impulse-noise` profile"),
    ("m1_spp", "M1 (unguided) + SPP noise model"),
    ("m1spp_real-noise", "M1 (unguided), `real-noise` profile"),
    ("m1spp_impulse-noise", "M1 (unguided), `impulse-noise` profile"),
    ("wiener", "DNN Wiener baseline"),
]


def flag(argv, name, default=None):
    key = f"--{name}"
    if key in argv:
        return argv[argv.index(key) + 1]
    return default


def cell(stats, metric, snr=None):
    d = stats["overall"] if snr is None else stats["per_snr"][snr]
    m = d[metric]
    if metric in ("ESTOI",):
        return f"{m['avg']:.3f}±{m['+/-']:.3f}"
    if metric in ("PESQ",):
        return f"{m['avg']:.3f}±{m['+/-']:.3f}"
    return f"{m['avg']:+.2f}±{m['+/-']:.2f}"


def seed_rows(rec, base):
    """All rows of one system across seeds: base, base@s1, ..."""
    out = [(base, rec[base])]
    k = 1
    while f"{base}@s{k}" in rec:
        out.append((f"{base}@s{k}", rec[f"{base}@s{k}"]))
        k += 1
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return 0
    path = flag(argv, "json", "CAMPAIGN_r05.json")
    if not os.path.exists(path):
        path = os.path.join(tempfile.gettempdir(), "gvnmf_campaign",
                            "campaign_results.json")
    rec = json.load(open(path))
    metrics = flag(argv, "metrics", "SI-SDR,ESTOI,PESQ").split(",")
    only = flag(argv, "systems")
    labels = [(k, v) for k, v in LABELS
              if k in rec and (only is None or k in only.split(","))]
    snrs = [str(float(s)) for s in rec["config"]["snrs"]]

    for metric in metrics:
        print(f"\n**{metric}** (mean ± 95% CI, overall / per input SNR):\n")
        print("| system | overall | " + " | ".join(
            f"{float(s):+.0f} dB" for s in snrs) + " |")
        print("|---|" + "---|" * (1 + len(snrs)))
        for key, label in labels:
            st = rec[key]["stats"]
            cells = [cell(st, metric)] + [cell(st, metric, s) for s in snrs]
            print(f"| {label} | " + " | ".join(cells) + " |")

    # seed-spread table (only systems with @s replicates present)
    spread = []
    for key, label in labels:
        rows = seed_rows(rec, key)
        if len(rows) < 2:
            continue
        vals = {m: [r["stats"]["overall"][m]["avg"] for _, r in rows]
                for m in metrics}
        spread.append((label, len(rows), vals))
    if spread:
        print("\n**Seed spread** (overall mean per seed; range = max−min):\n")
        print("| system | seeds | " + " | ".join(
            f"{m} range" for m in metrics) + " |")
        print("|---|---|" + "---|" * len(metrics))
        for label, n, vals in spread:
            cells = []
            for m in metrics:
                v = vals[m]
                rng = max(v) - min(v)
                fmt = ".4f" if m == "ESTOI" else ".3f"
                cells.append(f"{min(v):{fmt}}–{max(v):{fmt}} ({rng:{fmt}})")
            print(f"| {label} | {n} | " + " | ".join(cells) + " |")

    # per-noise-family means (record must be self-contained:
    # config.corpus_entries carries per-row identity)
    entries = rec["config"].get("corpus_entries")
    if entries and flag(argv, "by_family"):
        fams = sorted({e["family"] for e in entries})
        metric = flag(argv, "by_family")
        print(f"\n**{metric} by noise family** (overall mean):\n")
        print("| system | " + " | ".join(fams) + " |")
        print("|---|" + "---|" * len(fams))
        for key, label in labels:
            idx = rec[key]["keys"].index(metric)
            per = {f: [] for f in fams}
            for e, row in zip(entries, rec[key]["rows"]):
                if row[idx] is not None:
                    per[e["family"]].append(row[idx])
            print(f"| {label} | " + " | ".join(
                f"{sum(v)/len(v):+.2f}" for v in
                (per[f] for f in fams)) + " |")

    # objective-measure ordering cross-check
    obj = [m for m in ("FWSSNR", "WSS", "LLR", "SSNR")
           if m in rec[labels[0][0]]["keys"]]
    if obj:
        print("\n**Objective measures** (overall mean; WSS/LLR lower is "
              "better):\n")
        print("| system | " + " | ".join(obj) + " |")
        print("|---|" + "---|" * len(obj))
        for key, label in labels:
            ov = rec[key]["stats"]["overall"]
            print(f"| {label} | " + " | ".join(
                f"{ov[m]['avg']:.2f}" for m in obj) + " |")


if __name__ == "__main__":
    main()
