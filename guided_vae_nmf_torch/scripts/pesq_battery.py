"""Portable PESQ conformance battery (counterpart of the JAX package's
scripts/pesq_battery.py, scoring with the port's first-party P.862.2,
guided_vae_nmf_torch/metrics/pesq.py).

A self-contained degradation battery for cross-checking the first-party
PESQ against the ITU `pesq` wheel in any environment that has the wheel:
every test signal is generated here from fixed seeds with plain numpy, so
copying THIS FILE plus the committed expectations JSON
(artifacts/pesq_battery_expected.json) to a wheel-bearing machine and
running

    python pesq_battery.py --engine itu --expected pesq_battery_expected.json

emits a one-file conformance report: per-case wheel MOS vs the committed
first-party MOS, deltas, and a pass/fail against --threshold.

In-repo use:
    python -m guided_vae_nmf_torch.scripts.pesq_battery    # score + compare
    python -m guided_vae_nmf_torch.scripts.pesq_battery --write-expected 1
        (re-pins the scores into artifacts/pesq_battery_expected.json)

The battery spans the degradation axes the standard's modules exercise:
additive noise (white/pink, several SNRs), bandwidth loss, clipping,
level shift, constant delay, TIME-VARYING delay (exercises split_align),
multiplicative (MNRU-like) noise, and silence insertion.
"""

import json
import os
import sys

import numpy as np

FS = 16000
DUR = 4.0


# ---------------------------------------------------------------------------
# deterministic speech-like source + degradations (pure numpy, no scipy)
# ---------------------------------------------------------------------------


def speechlike(seed=0, dur=DUR, fs=FS):
    """Deterministic speech-like signal: pitch-swept harmonic source with
    formant-shaped spectrum, syllabic energy modulation and pauses."""
    rng = np.random.RandomState(seed)
    n = int(dur * fs)
    t = np.arange(n) / fs
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = np.zeros(n)
    # harmonics weighted by two moving "formants"
    for h in range(1, 30):
        fh = h * 140.0
        w = (np.exp(-0.5 * ((fh - 700) / 250.0) ** 2)
             + 0.7 * np.exp(-0.5 * ((fh - 1800) / 350.0) ** 2)
             + 0.3 * np.exp(-0.5 * ((fh - 3200) / 500.0) ** 2))
        x += w * np.sin(h * phase + rng.uniform(0, 6))
    # unvoiced bursts: shaped noise
    burst = rng.randn(n) * (np.sin(2 * np.pi * 3.1 * t) > 0.85)
    x += 0.15 * fir_bandpass(burst, 2000, 6000, fs)
    # syllabic modulation (4 Hz) with pauses
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.8 * t + 1.0))
    env *= (np.sin(2 * np.pi * 0.45 * t) > -0.6)
    x *= env ** 1.5
    return (x / (np.abs(x).max() + 1e-12)).astype(np.float64)


def fir_bandpass(x, lo, hi, fs, taps=255):
    m = np.arange(taps) - (taps - 1) / 2
    sinc = lambda f: np.sinc(2 * f / fs * m) * 2 * f / fs  # noqa: E731
    h = (sinc(hi) - sinc(lo)) * np.hamming(taps)
    return np.convolve(x, h, mode="same")


def fir_lowpass(x, cut, fs, taps=255):
    m = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(2 * cut / fs * m) * 2 * cut / fs * np.hamming(taps)
    h /= h.sum()
    return np.convolve(x, h, mode="same")


def add_noise(x, snr_db, seed, pink=False):
    rng = np.random.RandomState(seed)
    nz = rng.randn(len(x))
    if pink:
        # +1/f shaping via cumulative leaky integrator (pure numpy)
        spec = np.fft.rfft(nz)
        f = np.maximum(np.fft.rfftfreq(len(x), 1 / FS), 1.0)
        nz = np.fft.irfft(spec / np.sqrt(f), n=len(x))
    k = np.sqrt(np.sum(x ** 2) * 10 ** (-snr_db / 10) / np.sum(nz ** 2))
    return x + k * nz


def mnru(x, q_db, seed):
    """Modulated-noise reference-unit-like multiplicative noise."""
    rng = np.random.RandomState(seed)
    return x * (1 + 10 ** (-q_db / 20) * rng.randn(len(x)))


def delay(x, ms, fill=0.0):
    d = int(abs(ms) * FS / 1000)
    out = np.full_like(x, fill)
    if ms >= 0:
        out[d:] = x[: len(x) - d]
    else:
        out[: len(x) - d] = x[d:]
    return out


def tv_delay(x, ms_a, ms_b):
    """Delay jumps from ms_a to ms_b at the midpoint (split_align food)."""
    h = len(x) // 2
    return np.concatenate([delay(x[:h], ms_a), delay(x[h:], ms_b)])


def battery():
    """[(name, clean, degraded)] — all deterministic."""
    s = speechlike(0)
    s2 = speechlike(7)
    cases = [
        ("identical", s, s.copy()),
        ("white_snr20", s, add_noise(s, 20, 11)),
        ("white_snr10", s, add_noise(s, 10, 12)),
        ("white_snr0", s, add_noise(s, 0, 13)),
        ("pink_snr15", s, add_noise(s, 15, 14, pink=True)),
        ("pink_snr5", s2, add_noise(s2, 5, 15, pink=True)),
        ("lowpass_3k", s, fir_lowpass(s, 3000, FS)),
        ("lowpass_1k5", s2, fir_lowpass(s2, 1500, FS)),
        ("clip_50pc", s, np.clip(s, -0.5 * np.abs(s).max(),
                                 0.5 * np.abs(s).max())),
        ("clip_20pc", s2, np.clip(s2, -0.2 * np.abs(s2).max(),
                                  0.2 * np.abs(s2).max())),
        ("level_-12db", s, s * 10 ** (-12 / 20)),
        ("delay_60ms", s, delay(s, 60)),
        ("tv_delay_20_80ms", s, tv_delay(s, 20, 80)),
        ("mnru_q25", s, mnru(s, 25, 16)),
        ("mnru_q15", s2, mnru(s2, 15, 17)),
        ("dropout_200ms", s, np.concatenate(
            [s[: FS], np.zeros(FS // 5), s[FS + FS // 5:]])),
        ("noise+lowpass", s, fir_lowpass(add_noise(s, 12, 18), 2500, FS)),
        ("echo_120ms", s, s + 0.35 * delay(s, 120)),
    ]
    return cases


# ---------------------------------------------------------------------------
# scoring engines
# ---------------------------------------------------------------------------


def first_party_pesq():
    """Import the repo implementation when available (repo checkout or the
    single module copied next to this file), else None."""
    here = os.path.dirname(os.path.abspath(__file__))
    for p in (os.path.dirname(os.path.dirname(here)), here):
        if p not in sys.path:
            sys.path.insert(0, p)
    try:
        from guided_vae_nmf_torch.metrics.pesq import pesq
        return pesq
    except ImportError:
        pass
    try:
        from pesq_fp import pesq  # module copied alongside
        return pesq
    except ImportError:
        return None


def itu_pesq():
    try:
        from pesq import pesq
        return pesq
    except ImportError:
        return None


USAGE = """\
Portable PESQ conformance battery.

Runs 18 deterministic pure-numpy degradations through every importable
PESQ engine and compares against the committed expected scores.

  --expected PATH        expected-scores JSON (default: repo artifacts/)
  --engine NAME          auto | first-party | itu          (default auto)
  --threshold MOS        max |delta| allowed per case      (default 0.1)
  --write-expected 1     regenerate the expected JSON in place
  --report PATH          also write the JSON report to PATH
"""


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if "--help" in argv or "-h" in argv:
        print(USAGE)
        return 0

    def flag(name, default=None, cast=str):
        key = f"--{name}"
        if key in argv:
            return cast(argv[argv.index(key) + 1])
        return default

    here = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(os.path.dirname(os.path.dirname(here)), "artifacts")
    if os.path.isdir(art):               # repo checkout
        default_expected = os.path.join(art, "pesq_battery_expected.json")
    else:                                # file copied out standalone
        default_expected = os.path.join(here, "pesq_battery_expected.json")
    expected_path = flag("expected", default_expected)
    engine = flag("engine", "auto")
    threshold = flag("threshold", 0.1, float)
    write_expected = flag("write-expected", 0, int)
    report_path = flag("report", "")

    fp = first_party_pesq() if engine in ("auto", "first-party") else None
    itu = itu_pesq() if engine in ("auto", "itu") else None
    if fp is None and itu is None:
        print("no PESQ engine importable (need the repo for first-party "
              "or the `pesq` wheel for ITU)")
        return 2

    expected = {}
    if os.path.exists(expected_path) and not write_expected:
        with open(expected_path) as f:
            expected = json.load(f).get("cases", {})

    rows = {}
    for name, s, d in battery():
        row = {}
        if fp is not None:
            row["first_party"] = round(float(fp(FS, s, d, "wb")), 4)
        if itu is not None:
            row["itu"] = round(float(itu(FS, s, d, "wb")), 4)
        if name in expected:
            row["expected_first_party"] = expected[name]["first_party"]
        base = row.get("itu", row.get("first_party"))
        ref = row.get("expected_first_party",
                      row.get("first_party", base))
        row["delta_vs_expected"] = round(base - ref, 4)
        rows[name] = row
        print(f"{name:<18} " + "  ".join(
            f"{k}={v:+.4f}" if k.startswith("delta") else f"{k}={v:.4f}"
            for k, v in row.items()), flush=True)

    deltas = np.asarray([r["delta_vs_expected"] for r in rows.values()])
    summary = {
        "engines": {"first_party": fp is not None, "itu": itu is not None},
        "mean_abs_delta": round(float(np.mean(np.abs(deltas))), 4),
        "max_abs_delta": round(float(np.max(np.abs(deltas))), 4),
        "threshold": threshold,
        "pass": bool(np.mean(np.abs(deltas)) <= threshold),
        "n_cases": len(rows),
    }
    print(json.dumps(summary))

    if write_expected:
        os.makedirs(os.path.dirname(expected_path), exist_ok=True)
        with open(expected_path, "w") as f:
            json.dump({"fs": FS, "mode": "wb",
                       "cases": {k: {"first_party": v["first_party"]}
                                 for k, v in rows.items()}}, f, indent=1)
        print(f"expected scores written -> {expected_path}")
    if report_path:
        with open(report_path, "w") as f:
            json.dump({"summary": summary, "cases": rows}, f, indent=1)
        print(f"report -> {report_path}")
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
