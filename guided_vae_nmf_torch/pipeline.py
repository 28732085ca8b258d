"""End-to-end enhancement: int16 waveforms -> batched STFT -> guidance
labels -> batched MCEM (K1 / K2 kernels) -> Wiener filtering -> masked ISTFT
-> PCM16.

Counterpart of `guided_vae_nmf_tpu/pipeline.py`: :func:`enhance_waveform`
is `_enhance_waveform_jit`, :func:`enhance_to_audio`, :func:`enhance_batch`
and :func:`enhance_files` are their namesakes, :func:`make_labels` and
:func:`load_mixture` the host helpers, and :func:`_wiener_waveform` /
:func:`enhance_files_wiener` the Wiener-DNN baseline. The MCEM entry points
run in exact mode or in fast mode (`fast=True`: bfloat16 sample dumps,
approximate reciprocal, no cost pass; `fast="trans"`: also the
bit-arithmetic exp / log in the chains; see :func:`_fast_kwargs`). Noise
models: 'nmf' (the reference protocol), 'spp' (a fixed noise variance from
the SPP tracker, only the gains updated), 'hybrid' (the SPP floor plus a
learned NMF residual, Vb = W H + Vb_spp) and 'spp2' (two passes: the first
pass's residual power, EMA-smoothed and floored at the SPP PSD, is the
second pass's fixed noise variance), with the optional noise gain.
Algorithms, chosen by the config's type: `MCEMConfig` runs MCEM,
`PEEMConfig` PEEM (gradient E-step, no sampling) and `HybridConfig` the
PEEM -> MCEM hybrid (PEEM warm start, a short MCEM refinement and its
Wiener filter). MCEM runs on the fused engine (the K1 / K2 kernels) or on
the eager engine (`mcem.engine.mcem_run`), by `engine=` (see
:func:`_use_fused`); the 'hybrid' noise model always runs eager.
Label sources: 'dnn' (classifier on standardized power frames,
> threshold), 'oracle' (the Lorenz-quantile IBM / VAD of the clean
track), 'timo' (SPP soft mask, > 0.5), 'host' (caller's labels), 'ones',
'zeros' and 'none' (M1).

Entry points run on the GPU unless `device` names another device.
"""

import dataclasses
import os
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as Fn

from ._build import KernelError, build_all
from ._device import resolve_device
from .data import (native_loader, read_wav, read_wav_int16,
                   wav_num_samples, write_wav)
from .dsp import (
    clean_speech_IBM,
    clean_speech_IBM_torch,
    clean_speech_VAD,
    clean_speech_VAD_torch,
    frame_count,
    istft_masked,
    pad_signal_for_stft,
    stft,
    stft_batch_padded,
)
from .mcem.engine import (
    MCEMConfig,
    _fold_in,
    fold_seed,
    mcem_run,
    row_seeds,
)
from .mcem.fused_engine import mcem_batch_fused
from .mcem.mh_chain import FRAME_TILE, MAX_DEPTH
from .mcem.peem import (
    HybridConfig,
    PEEMConfig,
    peem_m1_batch,
    peem_m2_batch,
    peem_mcem_m2_batch,
)
from .mcem.rvae_engine import RVAEConfig, mcem_batch_rvae
from .mcem.spp import (
    spp_track,
    timo_mask,
    timo_mask_estimation,
    timo_vad,
    timo_vad_estimation,
)
from .models.nets import classifier_features
from .models.rvae import RVAE
from .ops.profiling import StageTimer, span
from .parallel.mesh import (
    ShardError,
    data_size,
    replicate,
    row_slices,
    run_shards,
)
from .profiles import apply_profile_cfg, offline_settings
from .utils import device_warmup

FS = 16000
NFFT = 1024
HOP = 256
BINS = 513

LABEL_MODES = ("none", "host", "dnn", "oracle", "timo", "ones", "zeros")
NOISE_MODELS = ("nmf", "spp", "hybrid", "spp2")
ENGINES = ("auto", "fused", "xla")


def bucket_frames(n_frames, bucket_multiple=128):
    """Padded frame count of an utterance."""
    return ((n_frames + bucket_multiple - 1) // bucket_multiple) * \
        bucket_multiple


def load_mixture(path_base):
    """Read `<base>_x.wav` -> (x_t, T_orig, X_tf (F, N) complex64): the
    native decode and STFT when the native loader builds (the same
    samples; the STFT equal within float32 rounding), else the numpy
    path."""
    native = native_loader.is_available()
    read = native_loader.read_wav_native if native else read_wav
    x_t, fs = read(path_base + "_x.wav")
    if fs != FS:
        raise ValueError(f"{path_base}_x.wav: sample rate {fs}, expected "
                         f"{FS}")
    if native:
        X_tf = native_loader.stft_complex_native(x_t)
    else:
        X_tf = stft(x_t, fs=FS, wlen_sec=NFFT / FS, hop_percent=HOP / NFFT)
    return x_t, len(x_t), X_tf


def make_labels(classif_type, X_power, s_path=None, classifier=None,
                mean=None, std=None, target="ibm", quantile_fraction=0.98,
                quantile_weight=0.999, eps=1e-8, features="power",
                dnn_threshold=0.5):
    """Per-utterance guidance labels on the host: X_power (F, N) mixture
    power -> (y_soft, y_hard) numpy arrays of shape (y_dim, N), y_dim = 513
    for IBM targets and 1 for VAD. 'dnn' runs `classifier` (a module) on
    its own device; 'oracle' reads the clean track `s_path`; 'timo',
    'ones' and 'zeros' need only X_power."""
    if classif_type == "dnn":
        x = classifier_features(torch.as_tensor(X_power.T), features)
        if mean is not None:
            x = (x - torch.as_tensor(mean).reshape(1, -1)) / (
                torch.as_tensor(std).reshape(1, -1) + eps)
        dev = classifier.out.w.device
        with torch.no_grad():
            y_soft = classifier(x.to(dev, torch.float32)).cpu().numpy().T
        y_hard = (y_soft > dnn_threshold).astype(np.float32)
    elif classif_type == "oracle":
        s_t, _ = read_wav(s_path)
        s_tf = stft(s_t, fs=FS, wlen_sec=NFFT / FS, hop_percent=HOP / NFFT)
        fn = clean_speech_VAD if target == "vad" else clean_speech_IBM
        y_soft = fn(s_tf, quantile_fraction=quantile_fraction,
                    quantile_weight=quantile_weight)
        if target == "vad":
            y_soft = y_soft.reshape(1, -1)
        y_hard = y_soft.astype(np.float32)
    elif classif_type == "timo":
        if target == "vad":
            y_soft = timo_vad_estimation(X_power)[None]
        else:
            y_soft = timo_mask_estimation(X_power)
        y_hard = (y_soft > 0.5).astype(np.float32)
    elif classif_type in ("ones", "zeros"):
        y_dim = 1 if target == "vad" else X_power.shape[0]
        fill = np.ones if classif_type == "ones" else np.zeros
        y_soft = fill((y_dim, X_power.shape[1]), np.float32)
        y_hard = y_soft
    else:
        raise ValueError(f"unknown classif_type: {classif_type}")
    return y_soft, y_hard


def _pad_batch(X_tfs, ys, n_pad):
    """Stack per-utterance (F, N_i) complex spectrograms (and optional
    labels) into padded (B, F, n_pad) arrays + masks. Pad power frames carry
    the benign value 1.0."""
    B = len(X_tfs)
    F = X_tfs[0].shape[0]
    X_c = np.zeros((B, F, n_pad), np.complex64)
    X_p = np.ones((B, F, n_pad), np.float32)
    mask = np.zeros((B, n_pad), np.float32)
    y_b = None
    if ys is not None:
        y_dim = ys[0].shape[0]
        y_b = np.zeros((B, y_dim, n_pad), np.float32)
    for i, X in enumerate(X_tfs):
        n = X.shape[1]
        X_c[i, :, :n] = X
        X_p[i, :, :n] = np.abs(X) ** 2
        mask[i, :n] = 1.0
        if ys is not None:
            y_b[i, :, : ys[i].shape[1]] = ys[i]
    return X_c, X_p, mask, y_b


def _packbits_bands(y):
    """(B, y_dim, N) 0/1 floats -> (B, ceil(y_dim/8), N) uint8, MSB-first
    per byte (np.unpackbits(..., axis=1) inverts it)."""
    B, d, N = y.shape
    yp = Fn.pad(y, (0, 0, 0, (-d) % 8)).reshape(B, -1, 8, N)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                           dtype=torch.float32, device=y.device)
    return torch.einsum("bkwn,w->bkn", yp, weights).to(torch.uint8)


def validate_noise_model(noise_model, cfg=None):
    """The one whitelist of noise models: a misspelt name raises instead of
    running 'nmf'; the PEEM -> MCEM hybrid takes 'nmf', 'spp' or 'spp2';
    the noise gain needs a fixed noise model."""
    if noise_model not in NOISE_MODELS:
        raise ValueError(f"noise_model must be one of {NOISE_MODELS}, "
                         f"got {noise_model!r}")
    if isinstance(cfg, HybridConfig) and noise_model == "hybrid":
        raise ValueError("algorithm 'hybrid' supports noise_model "
                         "'nmf', 'spp' or 'spp2' only")
    if getattr(cfg, "noise_gain", False) and noise_model not in (
            "spp", "spp2"):
        raise ValueError("MCEMConfig.noise_gain requires a fixed noise "
                         "model (noise_model 'spp' or 'spp2'), got "
                         f"{noise_model!r}")


def _fast_kwargs(fast):
    """Fused-engine kwargs for the `fast` level, as the JAX package maps
    them: False = exact; True = bfloat16 sample dumps + approximate
    reciprocal, no cost trace; "trans" additionally the bit-arithmetic exp
    / log in the chains. Any other truthy value raises."""
    if not fast:
        return {}
    if fast not in (True, "trans"):
        raise ValueError(f"fast must be False, True or 'trans', got {fast!r}")
    kw = dict(samples_dtype=torch.bfloat16, approx_recip=True,
              compute_cost=False)
    if fast == "trans":
        kw["approx_trans"] = True
    return kw


def _check_engine(engine):
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def _check_supported(noise_model, fast, cfg, engine="auto"):
    validate_noise_model(noise_model, cfg)
    _fast_kwargs(fast)
    _check_engine(engine)


def _use_fused(engine, model, n_pad):
    """Engine choice: 'fused' runs the fused engine (K1 / K2 on CUDA, their
    plain versions on the CPU), 'xla' the eager engine; 'auto' the fused
    engine for every decoder of 1 to 4 hidden layers (the decoders the JAX
    package sends to its Pallas engine: K1 takes any widths, F and NMF
    rank, in its cluster forms or its general form) at a padding of whole
    16-frame tiles, and the eager engine otherwise. The plain versions take
    any decoder, so on the CPU 'auto' stays on the fused engine, where the
    JAX package picks its XLA engine."""
    _check_engine(engine)
    if engine != "auto":
        return engine == "fused"
    if model.decoder.out.w.device.type != "cuda":
        return True
    return (1 <= len(model.decoder.hidden) <= MAX_DEPTH
            and n_pad % FRAME_TILE == 0)


def _ema_time(P, alpha):
    """First-order IIR smoothing along the frame axis of (B, F, N)."""
    v = P[..., 0]
    out = []
    for n in range(P.shape[-1]):
        v = alpha * v + (1.0 - alpha) * P[..., n]
        out.append(v)
    return torch.stack(out, dim=-1)


def _spp2_pass1_cfg(cfg):
    """Reduced-iteration copy of an MCEMConfig for spp2's first pass; a
    config without `spp2_pass1_niter` (PEEM, hybrid) runs unchanged."""
    p1 = getattr(cfg, "spp2_pass1_niter", None)
    if not p1 or p1 >= cfg.niter:
        return cfg
    return dataclasses.replace(cfg, niter=p1)


def _eager(engine, model, n_pad, noise_model):
    """Whether MCEM runs on the eager engine: the 'hybrid' noise model, or
    where :func:`_use_fused` does not pick the fused engine; never for an
    RVAE, which runs its own engine."""
    if isinstance(model, RVAE):
        return False
    return noise_model == "hybrid" or not _use_fused(engine, model, n_pad)


def _check_rvae(y, noise_model, fast, cfg, engine, init):
    """An RVAE runs :func:`mcem.rvae_engine.mcem_batch_rvae` alone: MCEM
    with a Langevin E-step, no labels, the NMF noise model, exact mode, no
    warm start."""
    supported = ("an RVAE runs MCEM with a Langevin E-step only: "
                 "label_mode='none', noise_model='nmf', fast=False, engine "
                 "'auto' or 'fused', no init, and an MCEMConfig or "
                 "RVAEConfig")
    _check_engine(engine)
    bad = [what for what, no in (
        ("labels", y is not None),
        (f"noise_model={noise_model!r}", noise_model != "nmf"),
        (f"fast={fast!r}", bool(fast)),
        (f"engine={engine!r}", engine == "xla"),
        ("a warm start (init)", bool(init)),
        (type(cfg).__name__, not isinstance(cfg, (MCEMConfig, RVAEConfig))),
    ) if no]
    if bad:
        raise NotImplementedError(f"{supported}; got {', '.join(bad)}")


def _spp2_two_pass(run_engine, Vb_spp, X_p, cfg):
    """Two-pass noise model ('spp2'): pass 1 runs the engine at the SPP
    noise variance with cfg.spp2_pass1_niter EM iterations; pass 2 re-runs
    it, with its randomness folded with 2, at Vb = max(Vb_spp,
    ema((1 - WFs1)^2 |X|^2)), the energy the first Wiener filter removed,
    floored at the SPP PSD."""
    out = run_engine(Vb_spp, cfg=_spp2_pass1_cfg(cfg))
    res = torch.square(1.0 - out["WFs"]) * X_p
    Vb2 = torch.maximum(Vb_spp, _ema_time(res, 0.5))
    return run_engine(Vb2, fold=2)


def _run_mcem(model, X_p, mask, y, generator, cfg, noise_model="nmf",
              fast=False, init=None, engine="auto", seeds=None):
    """Noise model -> engine: the algorithm by the config's type (MCEM, PEEM
    or the PEEM -> MCEM hybrid), MCEM on the engine :func:`_use_fused`
    picks (the 'hybrid' noise model on the eager engine). Returns the
    engine's result dict. The SPP tracker runs over the whole padded X_p,
    as in the JAX package (its recurrence is causal, so pad frames cannot
    perturb the valid prefix). The fused engine and PEEM draw from
    `generator`; the eager engine from the row `seeds` (default: derived
    from the generator's seed and each row's index) and ignores `fast`, as
    the JAX package's XLA engine does. `init` is the warm start: "W" /
    "H" for PEEM and the hybrid, also "g" / "Z" for MCEM on either
    engine. An RVAE goes to :func:`mcem.rvae_engine.mcem_batch_rvae` (see
    :func:`_check_rvae`)."""
    if isinstance(model, RVAE):
        _check_rvae(y, noise_model, fast, cfg, engine, init)
        return mcem_batch_rvae(model, X_p, mask, generator, cfg)
    _check_supported(noise_model, fast, cfg, engine)
    update_nmf = noise_model not in ("spp", "spp2")
    Vb_spp = None
    if noise_model != "nmf":
        psd, _ = spp_track(X_p)
        Vb_spp = torch.clamp_min(psd, 1e-6)
    use_fused = not _eager(engine, model, X_p.shape[-1], noise_model)
    if seeds is None:
        seeds = row_seeds(generator.initial_seed(), X_p.shape[0])

    def run_engine(Vb_fixed, cfg=cfg, fold=None):
        gen, sds = generator, seeds
        if fold is not None:
            gen = _fold_in(generator, fold)
            sds = [fold_seed(s, fold) for s in seeds]
        if isinstance(cfg, HybridConfig):
            pcfg, mcfg = cfg.split()
            return peem_mcem_m2_batch(model, X_p, mask, y, gen, pcfg, mcfg,
                                      update_nmf=update_nmf,
                                      Vb_fixed=Vb_fixed, init=init,
                                      use_fused=use_fused, seeds=sds,
                                      **_fast_kwargs(fast))
        if isinstance(cfg, PEEMConfig):
            peem = peem_m1_batch if y is None else peem_m2_batch
            args = (model, X_p, mask) + (() if y is None else (y,))
            return peem(*args, gen, cfg, update_nmf=update_nmf,
                        Vb_fixed=Vb_fixed, init=init)
        if use_fused:
            return mcem_batch_fused(model, X_p, mask, y, gen, cfg,
                                    update_nmf=update_nmf, Vb_fixed=Vb_fixed,
                                    init=init, **_fast_kwargs(fast))
        warm = init or {}
        init_nmf = None
        if "W" in warm:
            init_nmf = (warm["W"], warm["H"],
                        warm.get("g", torch.ones_like(mask)))
        return mcem_run(model, X_p, mask, y, sds, cfg, update_nmf=update_nmf,
                        Vb_fixed=Vb_fixed, init_nmf=init_nmf,
                        init_Z=warm.get("Z"))

    if noise_model == "spp2":
        return _spp2_two_pass(run_engine, Vb_spp, X_p, cfg)
    return run_engine(Vb_spp)


def _mcem_wf_istft(model, X_re, X_im, X_p, mask, y, generator, cfg,
                   noise_model="nmf", fast=False, init=None, engine="auto",
                   seeds=None):
    """:func:`_run_mcem` -> Wiener filtering -> masked batched ISTFT.
    Returns (s_est, n_est) padded float32 waveforms and the (B, F, N)
    Wiener gains."""
    out = _run_mcem(model, X_p, mask, y, generator, cfg, noise_model, fast,
                    init, engine, seeds)
    s_est, n_est = _wiener_istft(out, X_re, X_im, mask)
    return s_est, n_est, out["WFs"], out["WFn"]


def _wiener_istft(out, X_re, X_im, mask):
    """The engine's Wiener gains on the mixture -> masked batched ISTFT:
    the (s_est, n_est) padded float32 waveforms."""
    X = torch.complex(X_re, X_im)
    return (istft_masked(out["WFs"] * X, mask),
            istft_masked(out["WFn"] * X, mask))


def _to_pcm16(w):
    return torch.clamp(torch.round(w * 32768.0), -32768, 32767).to(
        torch.int16)


def _as_device(a, device, dtype=None):
    return None if a is None else torch.as_tensor(a, device=device,
                                                  dtype=dtype)


def _waveforms(a, dev):
    """Host-padded waveforms on `dev` as float32 (int16 PCM scaled by
    1/32768)."""
    x = _as_device(a, dev)
    if x.dtype != torch.float32:
        x = x.to(torch.float32) / 32768.0
    return x


@torch.no_grad()
def enhance_waveform(model, x_pad, mask, cfg: MCEMConfig = MCEMConfig(), *,
                     classifier=None, mean=None, std=None, y_in=None,
                     s_pad=None, generator=None, seeds=None,
                     label_mode="none", noise_model="nmf", fast=False,
                     engine="auto", target="ibm", quantile_fraction=0.98,
                     quantile_weight=0.999, return_noise=True,
                     soft_guidance=False, features="power",
                     dnn_threshold=0.5, init=None, device=None):
    """Whole pipeline on RAW WAVEFORMS: batched STFT -> labels -> MCEM ->
    Wiener filtering -> masked ISTFT -> PCM16. noise_model: 'nmf', 'spp',
    'hybrid' or 'spp2'; cfg: an MCEMConfig, a PEEMConfig or a HybridConfig;
    engine: 'auto', 'fused' or 'xla' (see the module docstring).

    x_pad: (B, L) host-pre-padded waveforms (:func:`pad_signal_for_stft`),
    int16 (scaled by 1/32768 on the device) or float32; mask (B, N) frame
    validity with N = 1 + (L - 1024) // 256. s_pad: the clean waveforms,
    padded alike, for label_mode='oracle': the labels are the
    Lorenz-quantile IBM (or, with target='vad', VAD) of their masked power,
    at `quantile_fraction` / `quantile_weight`. `generator` (a
    torch.Generator on `device`, default seeded with 0) drives the fused
    engine and PEEM; `seeds` (B ints) the eager engine's rows (see
    `_run_mcem`). init: optional warm start passed to the engine.

    Returns (s_i16, n_i16 | None, y_soft f16 | None, y_hard packed u8 |
    None, finite_ok (B,) bool), all on `device`; soft labels come back for
    'dnn' and 'timo' only (elsewhere soft equals hard)."""
    if label_mode not in LABEL_MODES:
        raise ValueError(f"unknown label_mode {label_mode!r}")
    dev = resolve_device(device)
    with span("gvnmf.batch", dev, rows=len(mask), n_pad=np.shape(mask)[-1],
              valid_frames=lambda m=mask: _valid_frames(m)):
        with span("gvnmf.front"):
            x = _waveforms(x_pad, dev)
            mask = _as_device(mask, dev, torch.float32)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            X = stft_batch_padded(x)
            X_re, X_im = X.real.contiguous(), X.imag.contiguous()
            X_p = torch.where(mask[:, None, :] > 0, X_re**2 + X_im**2, 1.0)

        y = y_soft = y_hard = None
        with span("gvnmf.labels"):
            if label_mode == "host":
                y = _as_device(y_in, dev, torch.float32)
            elif label_mode == "oracle":
                S = stft_batch_padded(_waveforms(s_pad, dev))
                Sp = (S.real**2 + S.imag**2) * mask[:, None, :]
                fn = (clean_speech_VAD_torch if target == "vad"
                      else clean_speech_IBM_torch)
                y = y_hard = fn(Sp, quantile_fraction, quantile_weight)
            elif label_mode == "dnn":
                # pad frames carry benign X_p = 1; the masked engine ignores
                # their labels
                xn = classifier_features(X_p.transpose(1, 2), features)
                if mean is not None:
                    mean_d = _as_device(mean, dev, torch.float32)
                    std_d = _as_device(std, dev, torch.float32)
                    xn = (xn - mean_d.reshape(1, 1, -1)) / (
                        std_d.reshape(1, 1, -1) + 1e-8)
                flat = classifier(xn.reshape(-1, xn.shape[-1]))
                y_soft = flat.reshape(xn.shape[0], xn.shape[1],
                                      -1).transpose(1, 2)
                y_hard = (y_soft > dnn_threshold).to(torch.float32)
                y = y_soft if soft_guidance else y_hard
            elif label_mode == "timo":
                # SPP recurrence is causal over frames, so trailing pad frames
                # (benign X_p = 1) cannot perturb the valid prefix
                if target == "vad":
                    y_soft = timo_vad(X_p)[:, None, :]
                else:
                    y_soft = timo_mask(X_p)
                y_hard = (y_soft > 0.5).to(torch.float32)
                y = y_soft if soft_guidance else y_hard
            elif label_mode in ("ones", "zeros"):
                y_dim = 1 if target == "vad" else X_p.shape[1]
                fill = torch.ones if label_mode == "ones" else torch.zeros
                y = fill((X_p.shape[0], y_dim, X_p.shape[2]), device=dev)
                y_soft = y_hard = y

        out = _run_mcem(model, X_p, mask, y, generator, cfg, noise_model,
                        fast, init, engine, seeds)
        with span("gvnmf.back"):
            s_est, n_est = _wiener_istft(out, X_re, X_im, mask)
            # per-row flags: one row's numeric failure must not fail its
            # batch-mates
            finite_ok = torch.all(torch.isfinite(s_est), dim=-1)
            if return_noise:
                finite_ok = finite_ok & torch.all(torch.isfinite(n_est),
                                                  dim=-1)
            out_soft = (y_soft.to(torch.float16)
                        if label_mode in ("dnn", "timo") else None)
            out_hard = None if y_hard is None else _packbits_bands(y_hard)
            out_n = _to_pcm16(n_est) if return_noise else None
            return _to_pcm16(s_est), out_n, out_soft, out_hard, finite_ok


def _valid_frames(mask):
    """Valid frames of a batch's mask: an int for a host mask, a device
    tensor (read when the spans are resolved) for a device one."""
    if isinstance(mask, torch.Tensor):
        n = torch.count_nonzero(mask)
        return n if n.device.type != "cpu" else int(n)
    return int(np.count_nonzero(mask))


def _row_slice(a, s):
    return None if a is None else a[s]


def enhance_waveform_sharded(mesh, model, x_pad, mask, cfg=MCEMConfig(), *,
                             seeds, classifier=None, y_in=None, s_pad=None,
                             axis="data", **kw):
    """:func:`enhance_waveform` with the batch split over the mesh's
    `axis` (the JAX package's `_enhance_waveform_sharded`): every stage
    (STFT, labels, MCEM, the Wiener filter, ISTFT) is per utterance, so
    each shard runs its rows on its device in a thread of its own with no
    communication. The batch must divide the axis (:func:`enhance_files`
    pads it with copies of its last row). `seeds` (B ints) are the rows'
    seeds: a shard's generator is seeded from its first row's (mod 2^63),
    the eager engine takes every row's. `model` and `classifier` are
    modules or `parallel.replicate` dicts; `kw` are enhance_waveform's
    other arguments (not `generator` or `device`). Returns its tuple,
    gathered on the axis's first device."""
    devs = mesh.axis_devices(axis)
    B = len(x_pad)
    if B % len(devs):
        raise ValueError(f"batch {B} must divide the mesh axis "
                         f"({len(devs)})")
    models = model if isinstance(model, dict) else replicate(mesh, model)
    classifiers = (classifier if isinstance(classifier, dict)
                   else replicate(mesh, classifier))
    seeds = [int(v) for v in seeds]
    slices = row_slices(B, len(devs))

    def shard(i, d):
        sl = slices[i]
        return enhance_waveform(
            models[d], x_pad[sl], mask[sl], cfg, classifier=classifiers[d],
            y_in=_row_slice(y_in, sl), s_pad=_row_slice(s_pad, sl),
            generator=torch.Generator(device=d).manual_seed(
                seeds[sl.start] % 2**63),
            seeds=seeds[sl], device=d, **kw)

    parts = run_shards(mesh, shard, mesh.cells(axis))
    return tuple(None if parts[0][j] is None
                 else torch.cat([p[j].to(devs[0]) for p in parts])
                 for j in range(len(parts[0])))


@torch.no_grad()
def enhance_to_audio(model, X_tfs, t_origs, ys=None, generator=None,
                     cfg: MCEMConfig = MCEMConfig(), bucket_multiple=128,
                     noise_model="nmf", fast=False, engine="auto",
                     device=None):
    """Complex spectrograms (F, N_i) in, trimmed float32 (s_est, n_est)
    waveform lists out."""
    dev = resolve_device(device)
    n_pad = bucket_frames(max(X.shape[1] for X in X_tfs), bucket_multiple)
    X_c, X_p, mask, y_b = _pad_batch(X_tfs, ys, n_pad)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    s_est, n_est, _, _ = _mcem_wf_istft(
        model,
        torch.as_tensor(np.ascontiguousarray(np.real(X_c)), device=dev),
        torch.as_tensor(np.ascontiguousarray(np.imag(X_c)), device=dev),
        torch.as_tensor(X_p, device=dev), torch.as_tensor(mask, device=dev),
        None if ys is None else torch.as_tensor(y_b, device=dev),
        generator, cfg, noise_model, fast, engine=engine)
    s_est = s_est.cpu().numpy()
    n_est = n_est.cpu().numpy()
    return ([s_est[i][:t] for i, t in enumerate(t_origs)],
            [n_est[i][:t] for i, t in enumerate(t_origs)])


@torch.no_grad()
def enhance_batch(model, X_tfs, ys=None, generator=None, seeds=None,
                  cfg: MCEMConfig = MCEMConfig(), bucket_multiple=128,
                  return_masks=False, engine="auto", noise_model="nmf",
                  device=None):
    """Enhance per-utterance (F, N_i) complex spectrograms in one padded
    batch: returns lists of (F, N_i) S_hat / N_hat complex numpy arrays,
    and with return_masks the engine's result dict (on `device`) as a
    third item. noise_model, engine, generator / seeds as in
    :func:`enhance_waveform`."""
    dev = resolve_device(device)
    n_pad = bucket_frames(max(X.shape[1] for X in X_tfs), bucket_multiple)
    _, X_p, mask, y_b = _pad_batch(X_tfs, ys, n_pad)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = _run_mcem(model, torch.as_tensor(X_p, device=dev),
                    torch.as_tensor(mask, device=dev),
                    None if ys is None else torch.as_tensor(y_b, device=dev),
                    generator, cfg, noise_model, engine=engine, seeds=seeds)
    WFs = out["WFs"].cpu().numpy()
    WFn = out["WFn"].cpu().numpy()
    S_hat = [WFs[i, :, : X.shape[1]] * X for i, X in enumerate(X_tfs)]
    N_hat = [WFn[i, :, : X.shape[1]] * X for i, X in enumerate(X_tfs)]
    if return_masks:
        return S_hat, N_hat, out
    return S_hat, N_hat


def plan_batches(file_paths, n_frames_all, batch_size=16,
                 bucket_multiple=128, n_dev=1, seed=0):
    """Bucket utterances by padded frame count and cut batches; returns
    [(paths, n_pad, seeds)]. Batch sizes scale inversely with bucket length
    (the (B, R, N, F) sample buffer must fit device memory). Per-utterance
    seeds derive from the utterance's list index; a batch's generator is
    seeded from its first member's seed, so the fused engine's output
    depends on the plan, and the eager engine's (per-row seeds) does not.

    With n_dev > 1 (a mesh's data axis) the plan is the JAX package's
    mesh-aware one: every batch size is a multiple of n_dev, and bucket
    tails smaller than the mesh are pooled across buckets, in descending
    n_pad, into batches at the largest n_pad of their members, so only
    the last pooled chunk is padded with duplicate rows when it is
    sharded (`scripts.bench_shard_balance` measures the waste)."""
    groups = defaultdict(list)
    for i, nf in enumerate(n_frames_all):
        groups[bucket_frames(nf, bucket_multiple)].append(i)
    seeds_all = np.random.default_rng(seed).integers(
        0, 2**62, size=max(len(file_paths), 1))
    batches = []
    leftovers = []      # (index, n_pad) of bucket tails smaller than n_dev
    for n_pad, idxs in sorted(groups.items()):
        eff_batch = max(1, batch_size * 512 // max(n_pad, 512))
        if n_dev > 1:
            eff_batch = max(n_dev, (eff_batch // n_dev) * n_dev)
            tail = len(idxs) % n_dev
            if tail:
                leftovers.extend((i, n_pad) for i in idxs[-tail:])
                idxs = idxs[:-tail]
        for lo in range(0, len(idxs), eff_batch):
            sel = idxs[lo: lo + eff_batch]
            batches.append(([file_paths[i] for i in sel], n_pad,
                            seeds_all[np.asarray(sel)]))
    leftovers.sort(key=lambda t: -t[1])
    for lo in range(0, len(leftovers), n_dev):
        chunk = leftovers[lo: lo + n_dev]
        sel = np.asarray([i for i, _ in chunk])
        batches.append(([file_paths[i] for i, _ in chunk],
                        max(p for _, p in chunk), seeds_all[sel]))
    return batches


def _fill_row(path, row):
    """Decode one int16 wav, end-pad and reflect-pad it into `row` (samples
    past the row's frames belong to no frame); returns (valid frames,
    samples). The native assembler does it when it builds: the same int16
    row."""
    if native_loader.is_available():
        return native_loader.assemble_utt_native(path, row, FS, NFFT, HOP)
    x_t, fs = read_wav_int16(path)
    if fs != FS:
        raise ValueError(f"{path}: sample rate {fs}, expected {FS}")
    xp, nf = pad_signal_for_stft(x_t)
    row[: min(len(xp), len(row))] = xp[:len(row)]
    return nf, len(x_t)


class SweepResult(float):
    """Wall-clock seconds of a sweep (a plain float), annotated with the
    numbers of processed and skipped utterances."""

    __slots__ = ("n_processed", "n_skipped")

    def __new__(cls, seconds, n_processed, n_skipped=0):
        r = super().__new__(cls, seconds)
        r.n_processed = n_processed
        r.n_skipped = n_skipped
        return r


def enhance_files(file_paths, processed_dir, output_dir, model,
                  model_type="m2", classif_type="dnn", target="ibm",
                  classifier=None, mean=None, std=None,
                  cfg: MCEMConfig = MCEMConfig(), batch_size=16,
                  bucket_multiple=128, quantile_fraction=0.98,
                  quantile_weight=0.999, seed=0, verbose=False,
                  engine="auto", noise_model="nmf", fast=False, mesh=None,
                  soft_guidance=False, skip_existing=False, profile=None,
                  features="power", dnn_threshold=0.5, device=None):
    """Sweep over a file list: reads `<utt>_x.wav` (and `<utt>_s.wav` for
    oracle labels), writes `<utt>_s_est.wav`, `<utt>_n_est.wav` and, for
    M2, the soft/hard label arrays `_ibm_soft_est.npy` /
    `_ibm_hard_est.npy`.

    Wav decode and padding run in a prefetch pool ahead of the device;
    each batch runs :func:`enhance_waveform`. On the fused engine it runs
    with `return_noise=False` (the fused chain's Wiener gains sum to one,
    so n = x - s is formed on the host); on the eager engine, whose floor
    on Vx can break that sum in near-silent bins, the device's n is
    written. A writer pool writes the outputs. Each utterance's seed comes
    from its list index (:func:`plan_batches`): a batch's generator is
    seeded from its first member's, and the eager engine takes every
    member's. A failed batch is retried one utterance at a time, and an
    utterance that still fails is written as mixture passthrough; a
    :class:`KernelError` (a kernel that does not build or launch) is not
    retried but raised. On a CUDA device the kernels are built before the
    sweep starts. Returns a :class:`SweepResult`. A row is assembled by
    the native loader when it builds (:func:`_fill_row`).

    A :class:`ops.profiling.StageTimer` times the sweep's stages under the
    JAX package's names, and `verbose` prints its report: `assemble_wait`
    (waiting for the prefetch pool), `dispatch` (enqueuing a batch on the
    device), `d2h_fetch` (waiting for the device and copying its output),
    `finish_wait` (the host's finish of a batch: labels, n = x - s, the
    hand-off to the writers) and `writer_drain` (waiting for the last
    writes).

    profile: name of a validated operating point (:mod:`.profiles`),
    authoritative for noise_model, soft_guidance and the cfg's noise_gain /
    noise_gain_bands; every other argument keeps its value.

    mesh: a `parallel.Mesh`; each batch is split over its "data" axis
    (:func:`enhance_waveform_sharded`, on the mesh's devices; `device` is
    then unused), the plan is mesh-aware (:func:`plan_batches` with
    n_dev), and a batch that does not divide the axis is padded with
    copies of its last row, whose outputs are not written. A shard that
    fails raises `parallel.ShardError` out of the sweep (no retry, no
    passthrough); non-finite rows are retried one utterance at a time on
    the mesh. With a mesh of one device the sweep is the unsharded one,
    bit for bit."""
    if profile is not None:
        noise_model, soft_guidance = offline_settings(profile)
        cfg = apply_profile_cfg(cfg, profile)
    label_mode = classif_type if model_type == "m2" else "none"
    if label_mode not in ("none", "dnn", "oracle", "timo", "ones", "zeros"):
        raise ValueError(f"unknown classif_type: {classif_type!r}")
    _check_supported(noise_model, fast, cfg, engine)
    if mesh is None:
        dev, n_dev = resolve_device(device), 1
    else:
        n_dev = data_size(mesh)
        dev = mesh.axis_devices("data")[0]
        models = (replicate(mesh, model), replicate(mesh, classifier))
    n_listed = len(file_paths)
    if skip_existing:
        file_paths = [
            p for p in file_paths
            if not os.path.exists(os.path.join(
                output_dir, os.path.splitext(p)[0] + "_s_est.wav"))
        ]
        if not file_paths:
            return SweepResult(0.0, 0, n_listed)
    n_skipped = n_listed - len(file_paths)
    t_start = time.perf_counter()
    for d in ({dev} if mesh is None else set(mesh.devices.ravel())):
        device_warmup(d)
    if dev.type == "cuda":
        build_all()     # a toolchain fault fails here, not once per batch
    PREFETCH = 3
    timer = StageTimer()

    def base_in(path):
        return os.path.join(processed_dir, os.path.splitext(path)[0])

    with ThreadPoolExecutor(max_workers=8) as pool:
        n_frames_all = list(pool.map(
            lambda p: frame_count(wav_num_samples(base_in(p) + "_x.wav")),
            file_paths))
    batches = plan_batches(file_paths, n_frames_all, batch_size,
                           bucket_multiple, n_dev, seed)

    oracle = label_mode == "oracle"

    def assemble(paths, n_pad):
        L = (n_pad - 1) * HOP + NFFT
        x_b = np.zeros((len(paths), L), np.int16)
        s_b = np.zeros((len(paths), L), np.int16) if oracle else None
        mask_b = np.zeros((len(paths), n_pad), np.float32)
        t_origs = []
        for j, path in enumerate(paths):
            nf, T = _fill_row(base_in(path) + "_x.wav", x_b[j])
            mask_b[j, :nf] = 1.0
            t_origs.append(T)
            if oracle:
                _fill_row(base_in(path) + "_s.wav", s_b[j])
        return {"paths": paths, "t_origs": t_origs, "x": x_b, "s": s_b,
                "mask": mask_b, "n_frames": [frame_count(t) for t in t_origs]}

    def run(a, rows, seeds):
        """enhance_waveform over a["..."][rows]; returns (s, n | None,
        y_soft, y_hard) on the host."""
        eager = _eager(engine, model, a["mask"].shape[1], noise_model)
        x, m = a["x"][rows], a["mask"][rows]
        sp = None if a["s"] is None else a["s"][rows]
        seeds = [int(v) for v in seeds]
        kw = dict(mean=mean, std=std, label_mode=label_mode,
                  noise_model=noise_model, fast=fast, engine=engine,
                  target=target, quantile_fraction=quantile_fraction,
                  quantile_weight=quantile_weight, return_noise=eager,
                  soft_guidance=soft_guidance, features=features,
                  dnn_threshold=dnn_threshold)
        B = len(x)
        with timer.stage("dispatch"):
            if mesh is None:
                out = enhance_waveform(
                    model, x, m, cfg, classifier=classifier, s_pad=sp,
                    generator=torch.Generator(device=dev).manual_seed(
                        seeds[0]),
                    seeds=seeds, device=dev, **kw)
            else:
                # duplicate the last row up to the mesh; never written
                pad = (-B) % n_dev

                def padb(v):
                    return None if v is None else np.concatenate(
                        [v, np.repeat(v[-1:], pad, axis=0)])

                out = enhance_waveform_sharded(
                    mesh, models[0], padb(x), padb(m), cfg,
                    classifier=models[1], s_pad=padb(sp),
                    seeds=seeds + seeds[-1:] * pad, **kw)
        with timer.stage("d2h_fetch"):
            s, n, y_soft, y_hard, ok = (None if o is None
                                        else o[:B].cpu().numpy()
                                        for o in out)
        if not np.all(ok):
            raise FloatingPointError("non-finite enhancement output")
        return s, n, y_soft, y_hard

    y_dim = 1 if target == "vad" else BINS

    def labels_host(y_soft, y_hard, j, nf):
        if y_hard is None:
            return None, None
        yh = np.unpackbits(y_hard[j:j + 1], axis=1)[0, :y_dim, :nf]
        ys = y_soft[j][:, :nf] if y_soft is not None else yh.astype(
            np.float16)
        return ys, yh

    def write_utt(path, s, n, y_soft, y_hard):
        # _s_est.wav marks completion for skip_existing: staged under a
        # temporary name and renamed after every side-car is written
        base_out = os.path.join(output_dir, os.path.splitext(path)[0])
        os.makedirs(os.path.dirname(base_out), exist_ok=True)
        tmp = base_out + "_s_est.wav.tmp"
        write_wav(tmp, s, FS)
        write_wav(base_out + "_n_est.wav", n, FS)
        if y_soft is not None:
            np.save(base_out + "_ibm_soft_est.npy", y_soft)
            np.save(base_out + "_ibm_hard_est.npy", y_hard)
        os.replace(tmp, base_out + "_s_est.wav")

    write_futs = []
    off = NFFT // 2     # the mixture starts after the reflect lead-in
    with ThreadPoolExecutor(max_workers=PREFETCH) as loader, \
            ThreadPoolExecutor(max_workers=4) as writer:
        pending = deque(loader.submit(assemble, p, n)
                        for p, n, _ in batches[:PREFETCH])
        for i, (paths, n_pad, seeds) in enumerate(batches):
            with timer.stage("assemble_wait"):
                a = pending.popleft().result()
            if i + PREFETCH < len(batches):
                nxt = batches[i + PREFETCH]
                pending.append(loader.submit(assemble, nxt[0], nxt[1]))
            rows = []      # (s, n | None, y_soft, y_hard) per utterance
            try:
                s_b, n_b, ys_b, yh_b = run(a, slice(None), seeds)
                for j, t in enumerate(a["t_origs"]):
                    rows.append((s_b[j][:t],
                                 None if n_b is None else n_b[j][:t])
                                + labels_host(ys_b, yh_b, j,
                                              a["n_frames"][j]))
            except (KernelError, ShardError):
                raise
            except (RuntimeError, FloatingPointError) as exc:
                print(f"batch of {len(paths)} failed ({exc!r}); retrying "
                      "per-utterance")
                for j, t in enumerate(a["t_origs"]):
                    try:
                        s1, n1, ys1, yh1 = run(a, slice(j, j + 1),
                                               seeds[j:j + 1])
                        rows.append((s1[0][:t],
                                     None if n1 is None else n1[0][:t])
                                    + labels_host(ys1, yh1, 0,
                                                  a["n_frames"][j]))
                    except (KernelError, ShardError):
                        raise
                    except (RuntimeError, FloatingPointError) as exc2:
                        print(f"utterance {paths[j]} failed ({exc2!r}); "
                              "writing passthrough")
                        nf = a["n_frames"][j]
                        zeros = (None, None) if label_mode == "none" else (
                            np.zeros((y_dim, nf), np.float16),
                            np.zeros((y_dim, nf), np.uint8))
                        rows.append((a["x"][j][off:off + t].copy(), None)
                                    + zeros)
            with timer.stage("finish_wait"):
                for j, (s, n, ys, yh) in enumerate(rows):
                    t = a["t_origs"][j]
                    if n is None:
                        n = np.clip(a["x"][j][off:off + t].astype(np.int32)
                                    - s.astype(np.int32), -32768,
                                    32767).astype(np.int16)
                    write_futs.append(writer.submit(write_utt, paths[j], s,
                                                    n, ys, yh))
            if verbose:
                print(f"batch {i}: enhanced {len(paths)} utterances")
        with timer.stage("writer_drain"):
            for f in write_futs:
                f.result()
    if verbose:
        print(timer.report())
    return SweepResult(time.perf_counter() - t_start, len(file_paths),
                       n_skipped)


@torch.no_grad()
def _wiener_waveform(model, x_pad, mean, std, mask, eps=1e-8):
    """The Wiener-DNN baseline on a batch, on the model's device: STFT ->
    power frames standardised by mean / std -> the mask m = model(frames)
    (a sigmoid MLP) -> S = m X -> masked ISTFT -> PCM16. x_pad (B, L)
    host-padded int16 or float32 waveforms, mask (B, N). Returns (s_i16
    (B, L - 1024), m float16 (B, F, N))."""
    dev = model.out.w.device
    x = _waveforms(x_pad, dev)
    mask = _as_device(mask, dev, torch.float32)
    X = stft_batch_padded(x)
    X_re, X_im = X.real, X.imag
    xn = (X_re**2 + X_im**2).transpose(1, 2)              # (B, N, F)
    if mean is not None:
        mean = _as_device(mean, dev, torch.float32)
        std = _as_device(std, dev, torch.float32)
        xn = (xn - mean.reshape(1, 1, -1)) / (std.reshape(1, 1, -1) + eps)
    m = model(xn.reshape(-1, xn.shape[-1]))
    m = m.reshape(xn.shape[0], xn.shape[1], -1).transpose(1, 2)
    s_est = istft_masked(torch.complex(m * X_re, m * X_im), mask)
    return _to_pcm16(s_est), m.to(torch.float16)


def enhance_files_wiener(file_paths, processed_dir, output_dir, model,
                         mean=None, std=None, eps=1e-8, verbose=False,
                         batch_size=32, bucket_multiple=128, device=None):
    """The Wiener-DNN baseline sweep: reads `<utt>_x.wav`, writes
    `<utt>_s_est.wav` and the soft mask `<utt>_wiener_mask.npy` (float32,
    (F, frames)). Utterances are bucketed by padded frame count and each
    batch of up to `batch_size` runs :func:`_wiener_waveform` on `device`
    (the GPU unless named; the model must live there), with int16
    transport. Returns wall-clock seconds."""
    dev = resolve_device(device)
    t_start = time.perf_counter()

    def base(root, path):
        return os.path.join(root, os.path.splitext(path)[0])

    groups = defaultdict(list)
    for path in file_paths:
        nf = frame_count(wav_num_samples(base(processed_dir, path)
                                         + "_x.wav"))
        groups[bucket_frames(nf, bucket_multiple)].append(path)
    for n_pad, paths in sorted(groups.items()):
        L = (n_pad - 1) * HOP + NFFT
        for lo in range(0, len(paths), batch_size):
            sel = paths[lo: lo + batch_size]
            x_b = np.zeros((len(sel), L), np.int16)
            mask_b = np.zeros((len(sel), n_pad), np.float32)
            rows = []
            for j, path in enumerate(sel):
                nf, T = _fill_row(base(processed_dir, path) + "_x.wav",
                                  x_b[j])
                mask_b[j, :nf] = 1.0
                rows.append((nf, T))
            s_i16, m = _wiener_waveform(
                model, torch.as_tensor(x_b, device=dev), mean, std,
                torch.as_tensor(mask_b, device=dev), eps=eps)
            s_i16, m = s_i16.cpu().numpy(), m.cpu().numpy()
            for j, (path, (nf, T)) in enumerate(zip(sel, rows)):
                base_out = base(output_dir, path)
                os.makedirs(os.path.dirname(base_out), exist_ok=True)
                write_wav(base_out + "_s_est.wav", s_i16[j][:T], FS)
                np.save(base_out + "_wiener_mask.npy",
                        m[j][:, :nf].astype(np.float32))
                if verbose:
                    print(f"wiener: {path}")
    return time.perf_counter() - t_start
