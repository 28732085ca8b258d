"""Validated operating-point presets (`--profile`).

A copy of `guided_vae_nmf_tpu/profiles.py` (the port imports nothing of the
JAX package). The offline profiles drive `pipeline.enhance_files(profile=)`;
`streaming_settings` gives the `streaming` enhancers' knobs, and
`http_serving.build_server(profile=)` applies both.

The round-3 quality levers that win on real noise — `noise_model='spp'`/
`'spp2'`, per-frame/per-band `noise_gain`, `soft_guidance`, streaming
residual tracking — all default OFF for reference parity (the reference's
evaluate scripts run plain NMF-MCEM with hard labels, the reference's
scripts/evaluate_M2_ibm.py:55-69). A deployer previously
had to reassemble the measured combinations from VALIDATION.md tables;
each profile here bundles exactly one validated VALIDATION.md table row so
a single flag reproduces it (the selection-precedent is the reference's
own `classif_type` switch, evaluate_M2_ibm.py:55-69).

Semantics: a profile is AUTHORITATIVE for the knobs it manages
(noise_model, soft guidance, noise_gain, noise_gain_bands, and the
streaming block parameters); unmanaged knobs (niter, labels source,
batch sizes, ...) keep their flags. Hand-tune individual knobs by
omitting --profile. Defaults everywhere stay `reference`.

Numbers quoted below: SI-SDR dB on the bundled QUT mixtures
(440c020a café −5 dB / 440c020b car / 440c020c kitchen), 8-seed means
from VALIDATION.md's round-3 tables, subset-trained shipped models.
"""

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Profile:
    name: str
    description: str
    # offline engine knobs (enhance_files / serving / evaluate CLIs)
    noise_model: str = "nmf"
    soft_guidance: bool = False
    cfg_overrides: dict = field(default_factory=dict)
    # StreamingM2Enhancer knobs (gvnmf stream / eval_streaming_m2 /
    # serving stream lanes); None = profile has no streaming analogue
    streaming: dict = None
    # offline=False: streaming-only profile (rejected by offline paths)
    offline: bool = True


PROFILES = {
    "reference": Profile(
        "reference",
        "reference-parity defaults: NMF noise model, hard labels, no "
        "noise gain (the reference's own evaluate configuration)",
        # managed knobs at their reference defaults; streaming analogue =
        # the plain stream (chunk=4: café −4.56 / car +8.72 / kitchen "
        # +0.12 at 128 ms)
        streaming=dict(soft_guidance=False, residual_tracking=False,
                       noise_gain=False, noise_gain_bands=1),
    ),
    "real-noise": Profile(
        "real-noise",
        "best all-round real-noise point: two-pass SPP noise model + "
        "per-frame noise gain + soft guidance (VALIDATION 'spp2 + ng + "
        "soft': café −3.66 / car +10.09 / kitchen +2.60 — SI-SDR records "
        "on café and car)",
        noise_model="spp2",
        soft_guidance=True,
        cfg_overrides={"noise_gain": True, "noise_gain_bands": 1},
        # causal analogue (VALIDATION 'stream + ng + soft + residual':
        # −3.94 / +10.43 / +0.45 at 128 ms — beats the best offline car)
        streaming=dict(soft_guidance=True, residual_tracking=True,
                       noise_gain=True, noise_gain_bands=1),
    ),
    "impulse-noise": Profile(
        "impulse-noise",
        "impulsive-noise point: SPP noise model + 2-band noise gain + "
        "soft guidance (VALIDATION bands table: kitchen +5.72 — ~3x the "
        "Wiener-DNN record — with car +10.11 / café −4.24 held)",
        noise_model="spp",
        soft_guidance=True,
        cfg_overrides={"noise_gain": True, "noise_gain_bands": 2},
        # causal analogue (VALIDATION streaming bands: −3.93 / +10.23 /
        # +3.44 at 128 ms)
        streaming=dict(soft_guidance=True, residual_tracking=True,
                       noise_gain=True, noise_gain_bands=2),
    ),
    "streaming-low-latency": Profile(
        "streaming-low-latency",
        "128 ms online flagship: chunk=4 blockwise PEEM with causal "
        "2-band noise gain + soft guidance + residual tracking + "
        "adaptive in-block budget (VALIDATION streaming tables: café "
        "−3.81 / car +10.06 / kitchen +3.97 — the bands=2 causal gain "
        "plus the self-escalating impulse-block budget recovers ~70% of "
        "the offline impulse win at unchanged latency)",
        # streaming-only: offline paths reject it
        offline=False,
        streaming=dict(chunk_frames=4, block_iters=6, e_steps=4,
                       context_frames=24, soft_guidance=True,
                       residual_tracking=True, noise_gain=True,
                       noise_gain_bands=2, adaptive_iters=6),
    ),
    "streaming-192ms": Profile(
        "streaming-192ms",
        "192 ms balanced online point: the streaming-low-latency levers "
        "at chunk=8 — the extra in-block context beats the 128 ms point "
        "on every QUT mixture's ESTOI/PESQ and on car SI-SDR "
        "(VALIDATION round-5 streaming frontier: café −3.92 / car "
        "+10.16 / kitchen +4.19, ESTOI 0.781-0.812). The impulse-"
        "leaning alternative at the same latency is chunk=4 + "
        "--lookahead 1 (kitchen +4.24-4.37, car ~0.3 dB lower)",
        offline=False,
        streaming=dict(chunk_frames=8, block_iters=6, e_steps=4,
                       context_frames=24, soft_guidance=True,
                       residual_tracking=True, noise_gain=True,
                       noise_gain_bands=2, adaptive_iters=6),
    ),
}

PROFILE_NAMES = tuple(PROFILES)


def get_profile(name):
    """Look up a profile by name; raises with the valid list."""
    if name not in PROFILES:
        raise ValueError(
            f"unknown profile {name!r}; valid: {', '.join(PROFILE_NAMES)}")
    return PROFILES[name]


def apply_profile_cfg(cfg, name):
    """Overlay a profile's engine-config overrides (noise_gain /
    noise_gain_bands) onto an MCEMConfig / PEEMConfig dataclass. Fields
    the config class does not declare (e.g. HybridConfig has no
    noise_gain) raise — those algorithm/profile combinations are
    unvalidated rather than silently degraded."""
    prof = get_profile(name)
    if not prof.offline:
        raise ValueError(
            f"profile {name!r} is streaming-only; use it with "
            "gvnmf stream / eval_streaming_m2 / serving stream lanes")
    if not prof.cfg_overrides:
        return cfg
    names = {f.name for f in dataclasses.fields(cfg)}
    missing = set(prof.cfg_overrides) - names
    if missing:
        raise ValueError(
            f"profile {name!r} sets {sorted(missing)} which "
            f"{type(cfg).__name__} does not support")
    return dataclasses.replace(cfg, **prof.cfg_overrides)


def offline_settings(name):
    """(noise_model, soft_guidance) for the offline pipeline."""
    prof = get_profile(name)
    if not prof.offline:
        raise ValueError(
            f"profile {name!r} is streaming-only; use it with "
            "gvnmf stream / eval_streaming_m2 / serving stream lanes")
    return prof.noise_model, prof.soft_guidance


def streaming_settings(name):
    """StreamingM2Enhancer / MultiStreamM2Enhancer kwargs for a profile
    (chunk/block parameters only where the profile pins them)."""
    prof = get_profile(name)
    if prof.streaming is None:
        raise ValueError(f"profile {name!r} has no streaming analogue")
    return dict(prof.streaming)


__all__ = [
    "PROFILES",
    "PROFILE_NAMES",
    "Profile",
    "get_profile",
    "apply_profile_cfg",
    "offline_settings",
    "streaming_settings",
]
