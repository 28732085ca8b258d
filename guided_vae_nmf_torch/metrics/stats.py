"""Metric aggregation: mean ± 95% confidence intervals, overall and per
input SNR, with optional JSON export.

Capability parity with reference python/metrics.py:5-10,70-130
(`mean_confidence_interval`, `compute_stats`, `compute_stats_noisnr`) and
the stats.json / stats_{snr}.json outputs of
scripts/run_metrics_wiener.py:194-214.

The port's own copy of `guided_vae_nmf_tpu/metrics/stats.py`;
`tests/test_torch_metrics.py` holds the two equal.
"""

import json
import os

import numpy as np
import scipy.stats


def mean_confidence_interval(data, confidence=0.95, round_to=3):
    """t-distribution CI half-width (reference metrics.py:5-10)."""
    a = 1.0 * np.array(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return np.round(m, round_to), np.round(h, round_to)


def compute_stats(metrics_keys, all_metrics, all_snr_db, model_data_dir=None,
                  confidence=0.95, save_json=False):
    """Aggregate per-utterance metric tuples: overall table + per-input-SNR
    breakdown (reference metrics.py:70-108). Returns
    {'overall': {...}, 'per_snr': {snr: {...}}} and optionally writes
    stats.json / stats_{snr}.json next to the model outputs."""
    metrics = {
        key: [row[i] for row in all_metrics]
        for i, key in enumerate(metrics_keys)
    }

    overall = {}
    print("{:<10} {:<10} {:<10}".format("METRIC", "AVERAGE", "CONF. INT."))
    for key, vals in metrics.items():
        m, h = mean_confidence_interval(vals, confidence=confidence)
        overall[key] = {"avg": float(m), "+/-": float(h)}
        print("{:<10} {:<10} {:<10}".format(key, m, h))
    print()

    per_snr = {}
    all_snr_db = np.asarray(all_snr_db)
    for snr_db in np.unique(all_snr_db):
        stats = {}
        print("Input SNR = {:.2f}".format(snr_db))
        print("{:<10} {:<10} {:<10}".format("METRIC", "AVERAGE", "CONF. INT."))
        sel = np.where(all_snr_db == snr_db)
        for key, vals in metrics.items():
            m, h = mean_confidence_interval(
                np.array(vals)[sel], confidence=confidence
            )
            stats[key] = {"avg": float(m), "+/-": float(h)}
            print("{:<10} {:<10} {:<10}".format(key, m, h))
        print()
        per_snr[float(snr_db)] = stats

    if save_json and model_data_dir is not None:
        os.makedirs(model_data_dir, exist_ok=True)
        with open(os.path.join(model_data_dir, "stats.json"), "w") as f:
            json.dump(overall, f, indent=2)
        for snr_db, stats in per_snr.items():
            path = os.path.join(
                model_data_dir, "stats_{:g}.json".format(snr_db)
            )
            with open(path, "w") as f:
                json.dump(stats, f, indent=2)

    return {"overall": overall, "per_snr": per_snr}


def compute_stats_noisnr(metrics_keys, all_metrics, model_data_dir=None,
                         confidence=0.95, save_json=False,
                         json_name="polqa_stats.json"):
    """Aggregate without SNR breakdown (reference metrics.py:110-130)."""
    metrics = {
        key: [row[i] for row in all_metrics]
        for i, key in enumerate(metrics_keys)
    }
    stats = {}
    print("{:<10} {:<10} {:<10}".format("METRIC", "AVERAGE", "CONF. INT."))
    for key, vals in metrics.items():
        m, h = mean_confidence_interval(vals, confidence=confidence)
        stats[key] = {"avg": float(m), "+/-": float(h)}
        print("{:<10} {:<10} {:<10}".format(key, m, h))
    print()
    if save_json and model_data_dir is not None:
        os.makedirs(model_data_dir, exist_ok=True)
        with open(os.path.join(model_data_dir, json_name), "w") as f:
            json.dump(stats, f, indent=2)
    return stats
