"""Supervision targets: ideal binary masks, VAD, ideal Wiener masks.

Counterpart of `guided_vae_nmf_tpu/dsp/targets.py`. The numpy targets
(`lorenz_threshold`, `clean_speech_IBM` / `VAD`, the noise-robust forms,
`ideal_wiener_mask`, `noise_aware_IRM` / `IBM`) are the port's own copies.
The tensor forms :func:`clean_speech_IBM_torch` and
:func:`clean_speech_VAD_torch` are the counterparts of
`clean_speech_IBM_jax` / `clean_speech_VAD_jax`: they take a power
spectrogram, batched over every leading axis with no Python loop, and find
the Lorenz threshold of each row by the JAX package's rule: a descending
sort and a cumulative sum, or, for float32 rows of at least 2^20 elements,
a 31-step bisection over the float32 bit order (one masked sum of every
row a step). The rule looks at one row's size, so a padded batch takes the
path JAX takes on the same padded utterance.
"""

import numpy as np
import torch


def lorenz_threshold(power, quantile_fraction):
    """Threshold of the Lorenz-function quantile criterion: sort all values
    descending and take the last one whose cumulative share of the total is
    below `quantile_fraction`."""
    sorted_power = np.sort(power, axis=None)[::-1]
    lorenz_function = np.cumsum(sorted_power) / np.sum(sorted_power)
    return sorted_power[lorenz_function < quantile_fraction][-1]


def _harden(mask, quantile_weight):
    """Soften toward 0.5 by quantile_weight, then round to exact {0, 1}
    float32."""
    mask = 0.5 + quantile_weight * (mask - 0.5)
    mask = np.round(mask)
    return np.float32(mask)


def clean_speech_IBM(observations, quantile_fraction=0.98,
                     quantile_weight=0.999):
    """Oracle ideal binary mask of a complex spectrogram by the Lorenz
    criterion on its TF power; float32 {0, 1} of the spectrogram's shape."""
    power = abs(observations * observations.conj())
    threshold = lorenz_threshold(power, quantile_fraction)
    return _harden(power > threshold, quantile_weight)


def clean_speech_VAD(observations, quantile_fraction=0.98,
                     quantile_weight=0.999):
    """Frame voice activity: the Lorenz criterion on the per-frame summed
    power; float32 {0, 1} of shape (1, frames)."""
    power = abs(observations * observations.conj()).sum(axis=0)
    threshold = lorenz_threshold(power, quantile_fraction)
    return _harden(power > threshold, quantile_weight)[None]


def noise_robust_clean_speech_VAD(
    observations,
    quantile_fraction_begin=0.93,
    quantile_fraction_end=0.99,
    quantile_weight=0.999,
):
    """VAD robust to leading and trailing noise: two Lorenz passes, then
    every frame between the first onset (loose quantile) and the last
    offset (tight quantile) is speech."""
    vad = clean_speech_VAD(
        observations, quantile_fraction=quantile_fraction_begin,
        quantile_weight=quantile_weight,
    )[0]
    vad_end = clean_speech_VAD(
        observations, quantile_fraction=quantile_fraction_end,
        quantile_weight=quantile_weight,
    )[0]
    begin = np.nonzero(vad)[0]
    end = np.nonzero(vad_end)[0]
    vad[begin[0]: end[-1]] = 1.0
    return vad[None]


def noise_robust_clean_speech_IBM(
    observations,
    vad_quantile_fraction_begin=0.93,
    vad_quantile_fraction_end=0.99,
    ibm_quantile_fraction=0.999,
    quantile_weight=0.999,
):
    """Noise-robust IBM: the noise-robust VAD AND the per-bin IBM."""
    vad = noise_robust_clean_speech_VAD(
        observations,
        quantile_fraction_begin=vad_quantile_fraction_begin,
        quantile_fraction_end=vad_quantile_fraction_end,
        quantile_weight=quantile_weight,
    )
    ibm = clean_speech_IBM(
        observations, quantile_fraction=ibm_quantile_fraction,
        quantile_weight=quantile_weight,
    )
    return ibm * vad


def ideal_wiener_mask(speech_tf, noise_tf, eps=1e-8):
    """Oracle Wiener mask |S|^2 / (|S|^2 + |N|^2 + eps)."""
    speech_power = np.abs(speech_tf) ** 2
    noise_power = np.abs(noise_tf) ** 2
    return speech_power / (speech_power + noise_power + eps)


# --------------------------------------------------------------------------
# Tensor forms (on the tensors' device)
# --------------------------------------------------------------------------


def _lorenz_threshold_sort(flat, quantile_fraction):
    """Per-row Lorenz threshold of (R, M) by a descending sort and a
    cumulative sum: the count-th largest element, or the largest where the
    first element already covers the quantile. The sums run in float64:
    where the quantile's energy spreads over most of a row's elements,
    float32 sums taken in different orders (JAX's, numpy's, a GPU scan)
    move the count by a few elements, and float64 keeps the port's count
    the exact one on every device."""
    flat = torch.sort(flat, dim=-1, descending=True).values
    wide = flat.to(torch.float64)
    lorenz = torch.cumsum(wide, dim=-1) / torch.sum(wide, dim=-1,
                                                     keepdim=True)
    count = torch.sum(lorenz < quantile_fraction, dim=-1)
    idx = torch.clamp_min(count - 1, 0)[:, None]
    return torch.gather(flat, -1, idx)[:, 0]


def _lorenz_threshold_bisect(flat, quantile_fraction):
    """Per-row Lorenz threshold of float32 (R, M) without a sort: a 31-step
    bisection over the bit patterns (non-negative floats order like their
    int32 views), each step one masked sum of every row. The same
    threshold as the sort form, ties included (a tie run at the threshold
    is excluded whole by the strict `>` of the mask); a boundary element
    whose side depends on the rounding of the sums may differ, at most the
    single crossing element of a row."""
    total = torch.sum(flat, dim=-1)
    target = quantile_fraction * total
    bits = flat.view(torch.int32).to(torch.int64)
    lo = torch.zeros_like(total, dtype=torch.int64)
    hi = torch.full_like(lo, 0x7F7FFFFF)
    zero = flat.new_zeros(())
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        s_ge = torch.sum(torch.where(bits >= mid[:, None], flat, zero),
                         dim=-1)
        below = s_ge < target
        lo = torch.where(below, lo, mid + 1)
        hi = torch.where(below, mid, hi)
    ge = bits >= hi[:, None]          # hi: the least bits whose sum is below
    c0 = torch.sum(ge, dim=-1)
    s0 = torch.sum(torch.where(ge, flat, zero), dim=-1)
    inf = flat.new_full((), float("inf"))
    t_hi = torch.amin(torch.where(ge, flat, inf), dim=-1)    # least kept
    w = torch.amax(torch.where(ge, -inf, flat), dim=-1)       # next down
    extra = torch.where(w > 0, torch.ceil((target - s0) / w) - 1, zero)
    extra = torch.clamp_min(extra, 0.0)
    threshold = torch.where(extra >= 1, w, t_hi)
    # no element below the quantile: the largest, as the sort form gives
    return torch.where(c0 + extra < 1, torch.amax(flat, dim=-1), threshold)


_LORENZ_BISECT_MIN_SIZE = 1 << 20


def _lorenz_threshold(flat, quantile_fraction):
    """The JAX package's selection: the bisection walks the float32 bit
    order, so it takes float32 rows of at least 2^20 elements; any other
    row takes the sort."""
    if (flat.shape[-1] >= _LORENZ_BISECT_MIN_SIZE
            and flat.dtype == torch.float32):
        return _lorenz_threshold_bisect(flat, quantile_fraction)
    return _lorenz_threshold_sort(flat, quantile_fraction)


def _harden_t(mask, quantile_weight):
    return torch.round(0.5 + quantile_weight * (mask - 0.5))


def clean_speech_IBM_torch(power, quantile_fraction=0.98,
                           quantile_weight=0.999):
    """Lorenz-quantile IBM of (..., F, N) power spectrograms, one threshold
    per (F, N) slice: {0, 1} of power's shape and dtype."""
    lead = power.shape[:-2]
    flat = power.reshape(-1, power.shape[-2] * power.shape[-1])
    threshold = _lorenz_threshold(flat, quantile_fraction)
    mask = (power > threshold.reshape(lead + (1, 1))).to(power.dtype)
    return _harden_t(mask, quantile_weight)


def clean_speech_VAD_torch(power, quantile_fraction=0.98,
                           quantile_weight=0.999):
    """Frame VAD labels of (..., F, N) power spectrograms, (..., 1, N): the
    Lorenz criterion on each slice's per-frame summed power."""
    frame_power = power.sum(dim=-2)
    lead = frame_power.shape[:-1]
    threshold = _lorenz_threshold(
        frame_power.reshape(-1, frame_power.shape[-1]), quantile_fraction)
    vad = (frame_power > threshold.reshape(lead + (1,))).to(power.dtype)
    return _harden_t(vad, quantile_weight)[..., None, :]


# --------------------------------------------------------------------------
# Heymann-style noise-aware masks
# --------------------------------------------------------------------------


def noise_aware_IRM(*inputs, feature_dim=-2, source_dim=-1,
                    tuple_output=False):
    """Ideal ratio mask over stacked sources: one stacked array, or several
    source arrays stacked along `source_dim`."""
    assert feature_dim != source_dim

    if len(inputs) != 1:
        ndims = [i.ndim for i in inputs]
        if max(ndims) != min(ndims):
            assert max(ndims) == min(ndims) + 1
            inputs = [
                np.expand_dims(i, source_dim) if i.ndim == min(ndims) else i
                for i in inputs
            ]
        else:
            # a trailing source axis
            inputs = [np.expand_dims(i, min(ndims)) for i in inputs]
        X = np.concatenate(inputs, axis=source_dim)
    else:
        X = inputs[0]

    power = np.sum(X.conjugate() * X, axis=feature_dim, keepdims=True)
    mask = (power / np.sum(power, axis=source_dim, keepdims=True)).real

    if not tuple_output:
        return np.squeeze(mask, axis=feature_dim)
    sizes = np.cumsum([o.shape[source_dim] for o in inputs])
    output = np.split(mask, sizes[:-1], axis=source_dim)
    return [
        np.squeeze(o) if o.shape[source_dim] == 1
        else np.squeeze(o, axis=feature_dim)
        for o in output
    ]


def _voiced_unvoiced_split(number_of_frequency_bins):
    """Frequency-dependent voiced / unvoiced weighting curves."""
    split_bin = 200
    transition_width = 99
    fast_transition_width = 5
    low_bin = 4
    high_bin = 500

    a = np.pi / (transition_width - 1) * np.arange(transition_width)
    transition = 0.5 * (1 + np.cos(a))
    b = np.pi / (fast_transition_width - 1) * np.arange(fast_transition_width)
    fast_transition = (np.cos(b) + 1) / 2

    start = int(split_bin - transition_width / 2)
    voiced = np.ones(number_of_frequency_bins)
    voiced[start - 1: start + transition_width - 1] = transition
    voiced[start - 1 + transition_width:] = 0
    voiced[:low_bin] = 0
    voiced[low_bin - 1: low_bin + fast_transition_width - 1] = \
        1 - fast_transition

    unvoiced = np.ones(number_of_frequency_bins)
    unvoiced[start - 1: start + transition_width - 1] = 1 - transition
    unvoiced[:start] = 0
    unvoiced[high_bin - 1:] = 0
    unvoiced[high_bin - 1: high_bin + fast_transition_width - 1] = \
        fast_transition

    return voiced, unvoiced


def noise_aware_IBM(
    X,
    N,
    threshold_unvoiced_speech=5,
    threshold_voiced_speech=0,
    threshold_unvoiced_noise=-10,
    threshold_voiced_noise=-10,
    low_cut=5,
    high_cut=500,
):
    """Heymann voiced / unvoiced-threshold IBM from speech and noise STFTs
    in (frames, bins) orientation; returns boolean (speech_mask,
    noise_mask)."""
    voiced, unvoiced = _voiced_unvoiced_split(X.shape[-1])

    threshold = (threshold_voiced_speech * voiced
                 + threshold_unvoiced_speech * unvoiced)
    threshold_new = (
        threshold_unvoiced_noise * voiced + threshold_voiced_noise * unvoiced
    )

    xPSD = X * X.conjugate()
    xPSD_threshold = xPSD / np.power(10, threshold / 10)
    xPSD_threshold_new = xPSD / np.power(10, threshold_new / 10)
    nPSD = N * N.conjugate()

    speech_mask = np.logical_and(xPSD_threshold > nPSD,
                                 xPSD_threshold > 0.005)
    speech_mask[..., : low_cut - 1] = 0
    speech_mask[..., high_cut:] = 0

    noise_mask = np.logical_or(xPSD_threshold_new < nPSD,
                               xPSD_threshold_new < 0.005)
    noise_mask[..., : low_cut - 1] = 1
    noise_mask[..., high_cut:] = 1

    return speech_mask, noise_mask
