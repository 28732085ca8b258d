"""Streaming (online) enhancement on the card.

Counterpart of `guided_vae_nmf_tpu/streaming.py`. The Wiener-DNN
baseline and the SPP mask are frame-causal (the classifier is frame-wise,
the SPP recurrence is causal), so they run on a live stream:
`StreamingWienerEnhancer` takes sample chunks of any size and emits
enhanced samples with one STFT window (64 ms) of algorithmic latency, and
its output equals the offline `pipeline._wiener_waveform` track before
PCM16 (same framing, the reflect and end padding applied causally, the
same overlap-add normalisation). The M2 stream (`StreamingM2Enhancer`)
runs blockwise warm-started PEEM: every chunk of new frames is enhanced in
a window [context | chunk] whose context carries the previous blocks' warm
(Z, g, b) state, with the causal SPP tracker's noise variance.

The reflect lead-in of the centred STFT needs only the first nfft//2 + 1
samples; the reflect tail and the end-pad rule need the stream's end and
are applied by `flush()`, appended to the padded buffer built so far. A
sample leaves once every frame that overlaps it has been processed.

How the port runs it:

- host side (`_StreamingOLA`): the numpy framing, overlap-add, lazy
  emission and bounded-memory trimming, as in the JAX package;
- one tick a chunk: frames go to the device in one copy, the chunk path
  runs there in PyTorch operations, and the enhanced frames (and masks)
  come back in one copy. JAX compiles each tick into one program; here a
  tick is a few thousand small launches (no CUDA graph yet). No TPU
  kernel lies on this path, so nothing here launches K1 or K2;
- every recurrent state (SPP and VAD tracker carries, the residual EMA,
  the warm context) lives on the stream's device between ticks;
- the M2 tick (`_m2_tick`) is written over a leading lane axis: a
  dedicated stream is one lane, the pool's tick runs its live lanes
  together. A lane's Z enters only its own terms of the summed objective,
  so the gradient each lane gets is its own;
- the adaptive in-block budget (`adaptive_iters`) runs while any lane is
  still active and keeps each finished lane's values, as JAX's
  `while_loop` under `vmap` does: one host read (`active.any()`) before
  the loop and one after each extra iteration, so at most
  `adaptive_iters + 1` synchronisations a tick, besides the copy back;
- the M2 tick computes in float64 (its state, and float64 copies of the
  models made at the first tick) and hands float32 frames back. In
  float32 the block EM amplified rounding by about 10^4 at an impulse
  frame: on the H100 the real-noise settings' stream came out 10 PCM16
  LSB from the same stream on the CPU, with no label or escalation
  flipped (the CPU's own float32 run was 2 LSB from float64). In float64
  the card and the CPU agree, and a pool lane its dedicated stream. The
  Wiener and SPP streams stay float32.

Every entry point runs on the GPU unless the caller passes
`device="cpu"` (`_device.resolve_device`); the models must live on that
device.
"""

import contextlib
import copy
import threading
import time

import numpy as np
import torch

from ._device import resolve_device
from .dsp.stft import _end_pad_len, _maybe_end_pad, periodic_hann, stft_params
from .mcem.engine import (
    VX_FLOOR,
    _decode_cond,
    _noise_gain_band_map,
    _precompute_label_proj,
    nmf_m_step,
)
from .mcem.spp import spp_state_init, spp_track_chunk
from .models.nets import classifier_features
from .models.rvae import refuse_rvae
from .parallel.mesh import data_size, replicate, run_shards

FS = 16000
NFFT, HOP = stft_params()
F_BINS = NFFT // 2 + 1


def _device_ctx(dev):
    """The stream's card as the calling thread's current device (the pool
    ticker and HTTP handler threads start on device 0)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _check_on(module, dev, name):
    got = next(module.parameters()).device
    if got.type != dev.type:
        raise ValueError(f"{name} lives on {got}, the stream on {dev}")


def _window(dev, dtype=torch.float32):
    return torch.as_tensor(periodic_hann(NFFT), dtype=dtype, device=dev)


def _to_host(*tensors):
    """One device -> host copy of float tensors that share their leading
    shape: concatenated along the last axis, split again on the host."""
    widths = [t.shape[-1] for t in tensors]
    flat = torch.cat([t.to(torch.float32) for t in tensors], dim=-1)
    host = flat.cpu().numpy()
    return np.split(host, np.cumsum(widths)[:-1], axis=-1)


def _tree_map(fn, *trees):
    """fn over the tensors of nested dicts / tuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


@torch.no_grad()
def _wiener_frames(model, frames, mean, std, window, eps=1e-8):
    """(k, nfft) raw frames -> (k, nfft) enhanced windowed frames and (k, F)
    masks: window -> rfft -> normalised power -> classifier mask -> masked
    spectrum -> irfft -> window; per frame, the offline
    `pipeline._wiener_waveform` program."""
    X = torch.fft.rfft(frames * window, dim=-1)
    re, im = X.real, X.imag
    p = re**2 + im**2
    if mean is not None:
        p = (p - mean) / (std + eps)
    m = model(p)
    S = torch.complex(m * re, m * im)
    y = torch.fft.irfft(S, n=NFFT, dim=-1) * window
    return y, m.to(torch.float16)


class _StreamingOLA:
    """Shared host machinery for chunked causal STFT-mask-ISTFT
    enhancement: the causal reflect lead-in, frame batches of a fixed
    shape, the masked overlap-add with the offline normalisation, lazy
    emission (a sample leaves once every frame overlapping it is
    processed), and the end-pad rule at flush. Subclasses implement
    `_enhance_frame_batch(frames, k) -> (enhanced windowed frames, masks)`
    as host arrays; `k` is the count of valid rows (the rest are zero
    padding and must not advance any recurrent state)."""

    # finalized prefixes are trimmed once they exceed this many samples
    # (amortizes the copy; ~4 s of audio)
    TRIM_CHUNK = 64 * 1024

    def __init__(self, chunk_frames=64, keep_masks=True):
        self.chunk_frames = chunk_frames
        # False = bounded-memory mode for indefinite live streams (the
        # `masks` history would otherwise grow ~8 GB/day at 16 kHz)
        self.keep_masks = keep_masks
        self._win_sq = periodic_hann(NFFT).astype(np.float32) ** 2
        self.reset()

    def reset(self):
        self._raw = np.zeros(0, np.float32)   # UN-trimmed original tail
        self._pad = None                      # padded signal (lead known)
        self._t_done = 0                      # frames processed
        self._emitted = 0                     # original samples emitted
        self._y = np.zeros(NFFT, np.float32)  # OLA accumulators (grown)
        self._w = np.zeros(NFFT, np.float32)
        self._masks = []
        self._flushed = False
        # samples discarded from the buffer fronts (finalized prefixes
        # are trimmed and all absolute coordinates offset by these)
        self._drop = 0       # padded coords: _pad/_y/_w fronts
        self._raw_drop = 0   # original coords: _raw front

    # -- internals --------------------------------------------------------

    # _raw and _pad live in geometrically grown backing buffers, so a
    # push()/feed() appends O(chunk) instead of copying the whole stream.

    @property
    def _raw(self):
        return self._raw_buf[:self._n_raw]

    @_raw.setter
    def _raw(self, value):
        self._raw_buf = np.asarray(value, np.float32)
        self._n_raw = len(self._raw_buf)

    @property
    def _pad(self):
        if self._pad_buf is None:
            return None
        return self._pad_buf[:self._n_pad]

    @_pad.setter
    def _pad(self, value):
        if value is None:
            self._pad_buf = None
            self._n_pad = 0
        else:
            self._pad_buf = np.asarray(value, np.float32)
            self._n_pad = len(self._pad_buf)

    @staticmethod
    def _append(buf, n, x):
        need = n + len(x)
        if need > len(buf):
            grown = np.zeros(max(need, 2 * len(buf), 4096), np.float32)
            grown[:n] = buf[:n]
            buf = grown
        buf[n:need] = x
        return buf, need

    def _append_raw(self, x):
        self._raw_buf, self._n_raw = self._append(
            self._raw_buf, self._n_raw, x)

    def _append_pad(self, x):
        self._pad_buf, self._n_pad = self._append(
            self._pad_buf, self._n_pad, x)

    def _ensure_acc(self, n):
        if self._y.size < n:
            grow = max(n, 2 * self._y.size)
            self._y = np.concatenate(
                [self._y, np.zeros(grow - self._y.size, np.float32)])
            self._w = np.concatenate(
                [self._w, np.zeros(grow - self._w.size, np.float32)])

    def _take_frames(self, padded, t0, k):
        """Frames [t0, t0+k) of the padded signal, zero-padded to the fixed
        shape (chunk_frames, nfft): one strided-view copy."""
        lo = t0 * HOP - self._drop
        windows = np.lib.stride_tricks.sliding_window_view(
            padded[lo:lo + (k - 1) * HOP + NFFT], NFFT)
        frames = np.ascontiguousarray(windows[::HOP][:k])
        if k < self.chunk_frames:
            frames = np.pad(frames, ((0, self.chunk_frames - k), (0, 0)))
        return frames

    # NFFT == 4*HOP: frames 4 apart don't overlap, so the overlap-add
    # vectorizes as (at most) 4 phase-grouped contiguous adds
    _OLA_PHASES = NFFT // HOP if NFFT % HOP == 0 else None

    def _ola_accumulate(self, t0, y, m, k, advance=True):
        """Overlap-add k enhanced windowed frames starting at frame t0
        into the accumulators and advance the processed-frame cursor
        (advance=False: the lookahead path accumulates behind the cursor
        and manages it itself)."""
        y = np.asarray(y)[:k]
        if self.keep_masks:
            self._masks.append(np.asarray(m)[:k])
        self._ensure_acc((t0 + k - 1) * HOP + NFFT - self._drop)
        base = t0 * HOP - self._drop
        P = self._OLA_PHASES
        if P:
            for p in range(min(P, k)):
                rows = y[p::P]                 # non-overlapping frames
                n = rows.shape[0]
                lo = base + p * HOP
                dst = self._y[lo:lo + n * NFFT].reshape(n, NFFT)
                dst += rows
                dstw = self._w[lo:lo + n * NFFT].reshape(n, NFFT)
                dstw += self._win_sq[None, :]
        else:  # non-divisor hop (not used by this framework's params)
            for i in range(k):
                lo = base + i * HOP
                self._y[lo:lo + NFFT] += y[i]
                self._w[lo:lo + NFFT] += self._win_sq
        if advance:
            self._t_done = t0 + k

    def _process_frames(self, padded, t_end):
        """Run frames [self._t_done, t_end) through the device tick and
        overlap-add them into the accumulators."""
        while self._t_done < t_end:
            k = min(self.chunk_frames, t_end - self._t_done)
            t0 = self._t_done
            frames = self._take_frames(padded, t0, k)
            y, m = self._enhance_frame_batch(frames, k)
            self._ola_accumulate(t0, y, m, k)

    def _emit_upto(self, orig_end):
        """Return finalized original samples [self._emitted, orig_end)."""
        orig_end = min(orig_end, self._raw_drop + self._n_raw)
        if orig_end <= self._emitted:
            return np.zeros(0, np.float32)
        lo = self._emitted + NFFT // 2 - self._drop    # padded coords
        hi = orig_end + NFFT // 2 - self._drop
        w = self._w[lo:hi]
        y = self._y[lo:hi]
        out = np.where(w > np.finfo(np.float32).tiny, y / w, y)
        self._emitted = orig_end
        return out.astype(np.float32)

    def _maybe_trim(self):
        """Discard finalized buffer prefixes (bounded-memory streaming).
        Keeps an NFFT margin behind the emit point: flush's reflect tail
        reads the padded buffer's last NFFT//2+2 samples and the OLA
        normalizer only ever reads forward of the emit point."""
        cut = self._emitted + NFFT // 2 - self._drop - NFFT
        if cut >= self.TRIM_CHUNK:
            keep = self._n_pad - cut
            self._pad_buf[:keep] = self._pad_buf[cut:self._n_pad]
            self._n_pad = keep
            self._y[:self._y.size - cut] = self._y[cut:]
            self._y = self._y[:self._y.size - cut]
            self._w[:self._w.size - cut] = self._w[cut:]
            self._w = self._w[:self._w.size - cut]
            self._drop += cut
        cut_r = self._emitted - self._raw_drop - NFFT
        if cut_r >= self.TRIM_CHUNK:
            keep = self._n_raw - cut_r
            self._raw_buf[:keep] = self._raw_buf[cut_r:self._n_raw]
            self._n_raw = keep
            self._raw_drop += cut_r

    # -- public API -------------------------------------------------------

    def _ingest(self, samples):
        """Buffer new samples and extend the causally known padded signal;
        returns the count of frames now available. Raises if the stream
        was already flushed, and on non-finite samples (they would poison
        the device-resident recurrent state for the rest of the stream)."""
        if self._flushed:
            raise RuntimeError(
                "push() after flush(): the stream was finalized with the "
                "end-pad rule; call reset() to start a new stream")
        samples = np.asarray(samples, np.float32)
        if samples.size and not np.all(np.isfinite(samples)):
            raise ValueError("non-finite samples in stream input")
        self._append_raw(samples)
        if self._pad is None:
            if self._n_raw < NFFT // 2 + 1:
                return 0
            # reflect lead-in, available causally (one-time copy)
            raw = self._raw
            self._pad = np.concatenate([raw[NFFT // 2:0:-1], raw])
        else:
            new = (self._raw_drop + self._n_raw + NFFT // 2
                   - self._drop - self._n_pad)
            if new > 0:
                self._append_pad(self._raw[-new:])
        return self._t_avail()

    def _t_avail(self):
        """Frames fully inside the causally known padded prefix."""
        if self._pad is None:
            return 0
        total = self._drop + self._n_pad
        return max(0, (total - NFFT) // HOP + 1)

    def _flush_pad(self):
        """End-of-stream framing: the end-pad rule and the reflect tail,
        appended to the causally built padded buffer. Returns the total
        frame count."""
        if self._pad is None:
            # stream shorter than the reflect lead: build the padded
            # signal outright (the append-only path needs the lead)
            x = _maybe_end_pad(self._raw, FS, 64e-3, 0.25, HOP)
            n_frames = 1 + len(x) // HOP
            padded = np.pad(x, NFFT // 2, mode="reflect").astype(
                np.float32)
            need = (n_frames - 1) * HOP + NFFT
            if len(padded) < need:
                padded = np.pad(padded, (0, need - len(padded)))
            self._pad = padded
            return n_frames

        L = self._raw_drop + self._n_raw
        z = _end_pad_len(L, FS, 64e-3, 0.25, HOP)
        if z:
            self._append_pad(np.zeros(z, np.float32))
        x_ep_len = L + z
        n_frames = 1 + x_ep_len // HOP
        # reflect tail: np.pad(x_ep, nfft//2, 'reflect')'s right side is
        # x_ep[-2], x_ep[-3], ...; the padded buffer ends with x_ep (the
        # trim margin keeps those samples)
        tail = self._pad[-2:-2 - NFFT // 2:-1].copy()
        self._append_pad(tail)
        need = (n_frames - 1) * HOP + NFFT
        total = self._drop + self._n_pad
        if total < need:  # hop remainder: frames may overrun; pad
            self._append_pad(np.zeros(need - total, np.float32))
        return n_frames

    def _t_emit_bound(self):
        """First frame NOT yet overlap-added (the lookahead path lags this
        behind the processed cursor)."""
        return self._t_done

    def push(self, samples):
        """Feed a chunk; returns the newly finalized enhanced samples."""
        t_avail = self._ingest(samples)
        if t_avail:
            self._process_frames(self._pad, t_avail)
        out = self._emit_upto(self._t_emit_bound() * HOP - NFFT // 2)
        self._maybe_trim()
        return out

    def flush(self):
        """Apply the end-pad rule and the reflect tail, process the
        remaining frames and return the rest of the enhanced signal. The
        stream is finalized afterwards: push() raises until reset()."""
        self._flushed = True
        if self._raw.size == 0:   # nothing ever pushed: nothing to finalize
            return np.zeros(0, np.float32)
        n_frames = self._flush_pad()
        self._process_frames(self._pad, n_frames)
        return self._emit_upto(self._raw_drop + self._n_raw)

    @property
    def masks(self):
        """(F, frames) float16 soft masks of everything processed so far.
        Raises when the stream runs with keep_masks=False."""
        if not self.keep_masks:
            raise RuntimeError("mask history disabled (keep_masks=False)")
        if not self._masks:
            return np.zeros((F_BINS, 0), np.float16)
        return np.concatenate(self._masks, axis=0).T


class StreamingWienerEnhancer(_StreamingOLA):
    """Chunked real-time Wiener-DNN enhancement whose output equals the
    offline program's::

        enh = StreamingWienerEnhancer(model, mean, std)
        for chunk in stream:           # float32 samples, any size
            out.append(enh.push(chunk))
        out.append(enh.flush())        # drains the tail

    `np.concatenate(out)` equals `pipeline._wiener_waveform`'s enhanced
    track for the same input to float tolerance (the offline path also
    rounds to PCM16). `model` is the Wiener classifier module, on
    `device` (the GPU unless named)."""

    def __init__(self, model, mean=None, std=None, chunk_frames=64,
                 eps=1e-8, keep_masks=True, device=None):
        self._dev = resolve_device(device)
        _check_on(model, self._dev, "the Wiener model")
        self.model = model
        self.mean = None if mean is None else torch.as_tensor(
            np.asarray(mean, np.float32), device=self._dev)
        self.std = None if std is None else torch.as_tensor(
            np.asarray(std, np.float32), device=self._dev)
        self.eps = eps
        self._window = _window(self._dev)
        super().__init__(chunk_frames, keep_masks)

    def _enhance_frame_batch(self, frames, k):
        with _device_ctx(self._dev):
            y, m = _wiener_frames(
                self.model, torch.as_tensor(frames, device=self._dev),
                self.mean, self.std, self._window, eps=self.eps)
            y, m = _to_host(y, m)
        return y, m.astype(np.float16)


@torch.no_grad()
def _spp_tick(frames, k, state, window):
    """The model-free chunk path: analysis -> causal SPP scan (state carried
    on the device, pad rows gated) -> masked synthesis."""
    X = torch.fft.rfft(frames * window, dim=-1)
    re, im = X.real, X.imag
    power = re**2 + im**2
    _, spp, state = spp_track_chunk(power.T, state, n_valid=k)
    valid = (torch.arange(frames.shape[0], device=frames.device) < k)[:, None]
    m = torch.where(valid, spp.T, 0.0)     # pad rows stay masked out
    S = torch.complex(m * re, m * im)
    y = torch.fft.irfft(S, n=NFFT, dim=-1) * window
    return y, m, state


class StreamingSPPEnhancer(_StreamingOLA):
    """Model-free streaming enhancement: the soft mask is the per-frame
    speech presence probability of the causal Gerkmann SPP tracker (the
    "timo" source, `mcem.spp`). The tracker's state persists across chunks
    on the device, so the mask track equals `spp.timo_mask` of the whole
    spectrogram."""

    def __init__(self, chunk_frames=64, keep_masks=True, device=None):
        self._dev = resolve_device(device)
        self._window = _window(self._dev)
        super().__init__(chunk_frames, keep_masks)

    def reset(self):
        super().reset()
        self._spp_state = spp_state_init(F_BINS, device=self._dev)

    def _enhance_frame_batch(self, frames, k):
        with _device_ctx(self._dev):
            y, m, self._spp_state = _spp_tick(
                torch.as_tensor(frames, device=self._dev), k,
                self._spp_state, self._window)
            y, m = _to_host(y, m)
        return y, m.astype(np.float16)


# ---------------------------------------------------------------------------
# Streaming flagship: online M2 enhancement (blockwise warm-started PEEM)
# ---------------------------------------------------------------------------


def _eff_vb(b, Vb, band_map):
    """Effective noise variance scale(b) * Vb over a window (P, F, W): b
    (P, W) per frame, or (P, n_bands, W) per band with band_map (n_bands,
    F); `engine.noise_gain_state`'s reference-orientation form with the
    band map built once a stream instead of once a tick."""
    if band_map is None:
        return b[:, None, :] * Vb
    return torch.einsum("pkw,kf->pfw", b, band_map) * Vb


def _m2_block_em(decoder, Xw, y_pre, Vb, Z0, g0, b0, mask, iters=6,
                 e_steps=4, lr=5e-3, noise_gain=False, band_map=None,
                 adaptive_iters=0, adaptive_thresh=0.05,
                 escalate_reinit=False):
    """Blockwise point-estimate EM over P lanes' (F, W) analysis windows
    with a fixed (SPP-tracked) noise variance: `e_steps` gradient steps on
    the latent MAP objective an EM iteration (`mcem.peem`), then the
    per-frame gain update (`nmf_m_step(update_nmf=False)`). Xw, Vb (P, F,
    W); y_pre (P, W, h1); Z0 (P, L, W); g0, mask (P, W); b0 (P, W), or
    (P, n_bands, W) with band_map. Warm-started from the previous block's
    (Z, g, b) on the context frames. Returns (Z, g, b, WFs (P, F, W),
    extra (P,) adaptive iterations each lane ran).

    noise_gain: also learn the noise gain b (the causal analogue of
    MCEMConfig.noise_gain). adaptive_iters (needs noise_gain): after the
    fixed budget, up to this many extra EM iterations while a lane's gain
    still moves (max |d log b| an iteration > adaptive_thresh); finished
    lanes keep their values. escalate_reinit (needs adaptive_iters): an
    escalating lane restarts its gain at the window's measured power ratio
    max(1, sum_band X / sum_band Vb) before the extra iterations."""
    mk = mask[:, None, :]

    def obj(Z, g, vb):
        Vs = _decode_cond(decoder, y_pre, Z)
        Vx = torch.clamp_min(g[:, None, :] * Vs + vb, VX_FLOOR)
        return (torch.sum((torch.log(Vx) + Xw / Vx) * mk)
                + 0.5 * torch.sum(Z * Z * mk))

    def logb(v):
        return torch.log(torch.clamp_min(v, 1e-12))

    def em(Z, g, b):
        vb = _eff_vb(b, Vb, band_map)
        for _ in range(e_steps):
            with torch.enable_grad():
                Zl = Z.detach().requires_grad_()
                (grad,) = torch.autograd.grad(obj(Zl, g, vb), Zl)
            Z = (Z - lr * grad).detach()
        Vs = _decode_cond(decoder, y_pre, Z)[:, None]
        if noise_gain:
            _, _, g, b2 = nmf_m_step(Xw, mask, None, None, g, Vs,
                                     update_nmf=False, Vb_fixed=Vb, b=b,
                                     band_map=band_map)
            d = torch.abs(logb(b2) - logb(b)).flatten(1).amax(dim=1)
            b = b2
        else:
            _, _, g = nmf_m_step(Xw, mask, None, None, g, Vs,
                                 update_nmf=False, Vb_fixed=Vb)
            d = torch.zeros(Z.shape[0], dtype=Xw.dtype, device=Xw.device)
        return Z, g, b, d

    Z, g, b = Z0, g0, b0
    d = None
    for _ in range(iters):
        Z, g, b, d = em(Z, g, b)

    extra = torch.zeros(Z.shape[0], dtype=torch.int64, device=Z.device)
    if adaptive_iters and noise_gain:
        # the base budget's last d log b decides whether a lane escalates:
        # quiet blocks pay no extra iteration
        active = d > adaptive_thresh
        if escalate_reinit:
            if band_map is None:
                ratio = Xw.sum(1) / torch.clamp_min(Vb.sum(1), 1e-12)
            else:
                ratio = (torch.einsum("kf,pfw->pkw", band_map, Xw)
                         / torch.clamp_min(torch.einsum(
                             "kf,pfw->pkw", band_map, Vb), 1e-12))
            lane = active.reshape((-1,) + (1,) * (b.dim() - 1))
            b = torch.where(lane, torch.clamp_min(ratio, 1.0), b)
        for _ in range(adaptive_iters):
            if not bool(active.any()):      # one host read a pass
                break
            Zn, gn, bn, dn = em(Z, g, b)

            def keep(new, old):
                return torch.where(
                    active.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                    old)

            Z, g, b, d = keep(Zn, Z), keep(gn, g), keep(bn, b), keep(dn, d)
            extra = extra + active.to(torch.int64)
            active = active & (d > adaptive_thresh)

    Vs = _decode_cond(decoder, y_pre, Z)
    Vx = torch.clamp_min(g[:, None, :] * Vs + _eff_vb(b, Vb, band_map),
                         VX_FLOOR)
    return Z, g, b, (g[:, None, :] * Vs) / Vx, extra


def _m2_state_init(P, F, y_dim, L, C, n_bands, dev, dtype=torch.float32):
    """Fresh recurrent state of P lanes: SPP and VAD tracker carries, the
    residual EMA (res, res_valid), the warm context windows ctx_X (P, F, C),
    ctx_y, ctx_Vb, ctx_Z, ctx_g (P, C), ctx_b (P, C) or (P, n_bands, C), and
    n_ctx (P,), the count of valid context frames (right-aligned)."""
    def z(*s):
        return torch.zeros((P,) + s, dtype=dtype, device=dev)

    def o(*s):
        return torch.ones((P,) + s, dtype=dtype, device=dev)

    return dict(
        spp=spp_state_init(F, batch=P, device=dev, dtype=dtype),
        vad=spp_state_init(1, batch=P, device=dev, dtype=dtype),
        res=(z(F), z()),
        ctx_X=z(F, C), ctx_y=z(y_dim, C), ctx_Vb=o(F, C), ctx_Z=z(L, C),
        ctx_g=o(C), ctx_b=(o(C) if n_bands == 1 else o(n_bands, C)),
        n_ctx=torch.zeros(P, dtype=torch.int64, device=dev),
    )


@torch.no_grad()
def _m2_tick(model, classifier, mean, std, band_map, window, frames, ks,
             state, label_mode="dnn", soft_guidance=False,
             residual_tracking=False, residual_alpha=0.5, noise_gain=False,
             noise_gain_init="ones", n_bands=1, block_iters=6, e_steps=4,
             lr=5e-3, eps=1e-8, adaptive_iters=0, escalate_reinit=False,
             lookahead=False, features="power", dnn_threshold=0.5):
    """The M2 chunk path of P lanes: analysis, the causal SPP noise track,
    guidance labels, the encoder's warm init, window assembly, the block
    EM, residual tracking, the context rebuild and masked synthesis, with
    every recurrent state in `state` (leading axis P, see
    `_m2_state_init`). frames (P, K, nfft); ks (P,) valid rows of each
    lane's chunk (pad rows emit benign outputs and advance no carry).

    Returns (y (P, K, nfft) enhanced windowed frames, m, new_state, info):
    m is the (P, K, F) gain of the new frames, or with `lookahead` the
    whole window's (P, C + K, F); info holds the lanes' guidance labels
    `labels` (P, K, y_dim) and `extra` (P,) adaptive iterations."""
    dev = frames.device
    P, K, _ = frames.shape
    C = state["ctx_X"].shape[2]
    L = state["ctx_Z"].shape[1]
    X = torch.fft.rfft(frames * window, dim=-1)
    re, im = X.real, X.imag
    power = re**2 + im**2                       # (P, K, F)
    rows = torch.arange(K, device=dev)
    valid = rows[None, :] < ks[:, None]         # (P, K)
    valid_row = valid[:, :, None]

    # causal SPP noise track; benign pad rows (Vb=1, spp=0)
    psd_T, spp_T, spp_state = spp_track_chunk(
        power.transpose(1, 2), state["spp"], n_valid=ks)
    Vb_new = torch.where(valid_row, psd_T.transpose(1, 2), 1.0)
    spp = torch.where(valid_row, spp_T.transpose(1, 2), 0.0)
    res, res_valid = state["res"]
    if residual_tracking:
        # noise floor from the enhanced residual of PAST blocks
        Vb_new = torch.where(valid_row & (res_valid > 0)[:, None, None],
                             torch.maximum(Vb_new, res[:, None, :]), Vb_new)

    # guidance labels (hard IBM by default, probabilities when soft)
    vad_state = state["vad"]
    y_dim = state["ctx_y"].shape[1]
    if label_mode == "timo":
        if y_dim == 1:
            # frame VAD = SPP of summed power (spp.timo_vad)
            _, vspp, vad_state = spp_track_chunk(
                power.sum(dim=2)[:, None, :], vad_state, n_valid=ks)
            y_soft = torch.where(valid_row, vspp.transpose(1, 2), 0.0)
        else:
            y_soft = spp
    else:
        p = classifier_features(power, features)
        if mean is not None:
            p = (p - mean) / (std + eps)
        y_soft = classifier(p)
    thr = dnn_threshold if label_mode == "dnn" else 0.5
    y_new = (y_soft if soft_guidance else (y_soft > thr)).to(power.dtype)

    # encoder posterior mean for the new frames
    Z_new = model.encoder(torch.cat([power, y_new], dim=2))[1]
    Z_new = Z_new.transpose(1, 2)               # (P, L, K)

    # window [C | chunk]
    Xw = torch.cat([state["ctx_X"], power.transpose(1, 2)], dim=2)
    yw = torch.cat([state["ctx_y"], y_new.transpose(1, 2)], dim=2)
    Vbw = torch.cat([state["ctx_Vb"], Vb_new.transpose(1, 2)], dim=2)
    Zw = torch.cat([state["ctx_Z"], Z_new], dim=2)
    gw = torch.cat([state["ctx_g"], power.new_ones(P, K)], dim=1)
    if n_bands == 1:
        b_new = power.new_ones(P, K)
        if noise_gain and noise_gain_init == "ratio":
            ratio = power.sum(dim=2) / torch.clamp_min(Vb_new.sum(dim=2),
                                                       1e-12)
            b_new = torch.clamp_min(ratio, 1.0)
        bw = torch.cat([state["ctx_b"], b_new], dim=1)
    else:
        b_new = power.new_ones(P, n_bands, K)
        if noise_gain and noise_gain_init == "ratio":
            num = torch.einsum("kf,pnf->pkn", band_map, power)
            den = torch.clamp_min(
                torch.einsum("kf,pnf->pkn", band_map, Vb_new), 1e-12)
            b_new = torch.clamp_min(num / den, 1.0)
        bw = torch.cat([state["ctx_b"], b_new], dim=2)
    n_ctx = state["n_ctx"]
    cols = torch.arange(C, device=dev)
    maskw = torch.cat([(cols[None, :] >= (C - n_ctx)[:, None]),
                       valid], dim=1).to(power.dtype)
    Xw = torch.clamp_min(Xw, 1e-12)             # benign pad values
    Vbw = torch.clamp_min(Vbw, 1e-10)

    y_pre = _precompute_label_proj(model.decoder, yw, L)
    Z, g, bfr, WFs, extra = _m2_block_em(
        model.decoder, Xw, y_pre, Vbw, Zw, gw, bw, maskw, iters=block_iters,
        e_steps=e_steps, lr=lr, noise_gain=noise_gain, band_map=band_map,
        adaptive_iters=adaptive_iters, escalate_reinit=escalate_reinit)
    m = WFs[:, :, C:].transpose(1, 2)           # (P, K, F) new frames

    if residual_tracking:
        # the IIR recurrence of pipeline._ema_time, causal over valid rows
        a = residual_alpha
        for i in range(K):
            r = (1.0 - m[:, i]) ** 2 * power[:, i]
            blended = torch.where((res_valid > 0)[:, None],
                                  a * res + (1.0 - a) * r, r)
            v_i = valid[:, i]
            res = torch.where(v_i[:, None], blended, res)
            res_valid = torch.where(v_i, 1.0, res_valid)

    # context rebuild: right-align the last (up to C) valid frames. The
    # valid region of the window is contiguous [C - n_ctx, C + k), so the
    # last C valid frames are window columns [k, C + k) with the first
    # C - v columns (v = new valid count) overwritten by the benign fill.
    v = torch.clamp_max(n_ctx + ks, C)
    lead = cols[None, :] < (C - v)[:, None]     # (P, C)
    idx = ks[:, None] + cols[None, :]           # (P, C) per-lane offset

    def rebuild(buf, fill):
        if buf.dim() == 2:
            return torch.where(lead, fill, torch.gather(buf, 1, idx))
        sl = torch.gather(buf, 2, idx[:, None, :].expand(
            buf.shape[0], buf.shape[1], C))
        return torch.where(lead[:, None, :], fill, sl)

    new_state = dict(
        spp=spp_state, vad=vad_state, res=(res, res_valid),
        ctx_X=rebuild(Xw, 0.0), ctx_y=rebuild(yw, 0.0),
        ctx_Vb=rebuild(Vbw, 1.0), ctx_Z=rebuild(Z, 0.0),
        ctx_g=rebuild(g, 1.0), ctx_b=rebuild(bfr, 1.0),
        n_ctx=v,
    )
    S = torch.complex(m * re, m * im)
    y = torch.fft.irfft(S, n=NFFT, dim=-1) * window
    info = {"labels": y_new, "extra": extra}
    if lookahead:
        # the host emits each chunk one tick late, synthesized from the
        # whole window's refined mask
        return y, WFs.transpose(1, 2), new_state, info
    return y, m, new_state, info


class StreamingM2Enhancer(_StreamingOLA):
    """Online M2 guided-VAE enhancement on a live stream.

    Every `chunk_frames` new frames are enhanced in a window [context |
    chunk] where the context carries the warm (Z, g) state of the previous
    blocks; the noise variance is the causal Gerkmann SPP tracker's PSD,
    the labels come from the frame-wise classifier (`label_mode='dnn'`) or
    the SPP mask (`'timo'`), and the E-step is PEEM's gradient descent on
    the MAP objective (deterministic, so the stream draws nothing at
    random). Latency = chunk_frames x 16 ms + the 64 ms STFT window.

    `model` is the M2 `DGM` (its `y_dim` picks the guidance: 513 for the
    IBM family, 1 for the VAD family), `classifier` the label classifier
    (label_mode 'dnn'), both on `device` (the GPU unless named).
    `features` / `dnn_threshold` follow the classifier's
    classifier_meta.json protocol."""

    def __init__(self, model, classifier=None, mean=None, std=None,
                 chunk_frames=8, context_frames=24, block_iters=6,
                 e_steps=4, lr=5e-3, label_mode="dnn", soft_guidance=False,
                 residual_tracking=False, residual_alpha=0.5,
                 noise_gain=False, noise_gain_init="ones",
                 noise_gain_bands=1, eps=1e-8, keep_masks=True,
                 adaptive_iters=0, escalate_reinit=False, lookahead=False,
                 features="power", dnn_threshold=0.5, device=None):
        refuse_rvae(model, "the M2 stream")
        if label_mode == "dnn" and classifier is None:
            raise ValueError("label_mode='dnn' needs a classifier")
        self.features = features
        self.dnn_threshold = dnn_threshold
        # guidance dimension from the model, not from label_mode
        self.y_dim = int(getattr(model, "y_dim", 0) or 0)
        if not self.y_dim:
            raise ValueError("the M2 stream needs a DGM (a model with y_dim)")
        self.model = model
        self.cls = classifier
        self.label_mode = label_mode
        self.soft_guidance = soft_guidance
        # causal analogue of the offline 'spp2' noise model: the enhanced
        # residual (1-WFs)^2 |X|^2 of PAST blocks, EMA-smoothed as in
        # pipeline._ema_time, floors the next block's noise variance
        self.residual_tracking = residual_tracking
        self.residual_alpha = residual_alpha
        # per-frame noise gain learnt inside each block
        self.noise_gain = noise_gain
        # 'ones' starts new frames at b=1; 'ratio' at the frame's
        # broadband power ratio max(1, sum_f X / sum_f Vb)
        if noise_gain_init not in ("ones", "ratio"):
            raise ValueError("noise_gain_init must be 'ones' or 'ratio'")
        if not noise_gain:
            # the gain's knobs are dead without it: refuse them rather
            # than let a user believe they ran that operating point
            if noise_gain_init != "ones":
                raise ValueError(
                    "noise_gain_init='ratio' requires noise_gain=True")
            if noise_gain_bands != 1:
                raise ValueError(
                    "noise_gain_bands > 1 requires noise_gain=True")
            if adaptive_iters:
                raise ValueError(
                    "adaptive_iters requires noise_gain=True (the "
                    "escalation trigger is the gain's movement)")
        if escalate_reinit and not adaptive_iters:
            raise ValueError(
                "escalate_reinit requires adaptive_iters > 0 (it re-inits "
                "the gain of blocks the adaptive budget escalates)")
        self.adaptive_iters = adaptive_iters
        self.escalate_reinit = escalate_reinit
        # one-block lookahead: emit each chunk one tick late, after the
        # block EM has refined it with the next chunk in the window
        # (latency + chunk_frames x 16 ms)
        if lookahead and chunk_frames > context_frames:
            raise ValueError(
                "lookahead needs chunk_frames <= context_frames (the "
                "emitted chunk must still sit inside the EM window)")
        self.lookahead = lookahead
        self.noise_gain_init = noise_gain_init
        self.noise_gain_bands = noise_gain_bands
        self._dev = resolve_device(device)
        _check_on(model, self._dev, "the M2 model")
        if classifier is not None:
            _check_on(classifier, self._dev, "the classifier")
        # the tick computes in float64 (module docstring); its copies of
        # the models are made at the first tick, so pool slots, which
        # never tick themselves, hold none
        self._models64 = None
        f64 = dict(dtype=torch.float64, device=self._dev)
        self.mean = None if mean is None else torch.as_tensor(
            np.asarray(mean, np.float64), **f64)
        self.std = None if std is None else torch.as_tensor(
            np.asarray(std, np.float64), **f64)
        self._band_map = None
        if noise_gain_bands > 1:
            # on the device once: every tick reads it
            self._band_map = _noise_gain_band_map(
                F_BINS, noise_gain_bands, **f64)
        self._window = _window(self._dev, torch.float64)
        self.C = context_frames
        self.block_iters = block_iters
        self.e_steps = e_steps
        self.lr = lr
        self.eps = eps
        self._L = int(model.encoder.mu.w.shape[1])
        super().__init__(chunk_frames, keep_masks)

    def reset(self):
        super().reset()
        # lookahead emission lag: (t0, k) of the processed-but-unemitted
        # chunk (None until the first tick)
        self._la_pending = None
        self._dstate = _m2_state_init(1, F_BINS, self.y_dim, self._L,
                                      self.C, self.noise_gain_bands,
                                      self._dev, torch.float64)

    def _current_state(self):
        """The stream's live recurrent state, one lane without its lane
        axis: its own `_dstate`, or, when the stream is a pool slot, its
        row of the pool's resident state (ticks update only that row)."""
        pool = getattr(self, "_pool", None)
        if pool is not None and pool._pool_state is not None:
            return pool._row_state(self._pool_row)
        return _tree_map(lambda a: a[0], self._dstate)

    # state views for tests and introspection
    @property
    def _ctx_valid(self):
        C, v = self.C, int(self._current_state()["n_ctx"])
        out = np.zeros((C,), np.float32)
        if v:
            out[C - v:] = 1.0
        return out

    @property
    def _ctx_b(self):
        return self._current_state()["ctx_b"].cpu().numpy()

    @property
    def _res(self):
        """Residual-tracking EMA: None until warmed."""
        res, ok = self._current_state()["res"]
        return res.cpu().numpy() if float(ok) > 0 else None

    def _tick_cfg(self):
        return dict(label_mode=self.label_mode,
                    soft_guidance=self.soft_guidance,
                    residual_tracking=self.residual_tracking,
                    residual_alpha=self.residual_alpha,
                    noise_gain=self.noise_gain,
                    noise_gain_init=self.noise_gain_init,
                    n_bands=self.noise_gain_bands,
                    block_iters=self.block_iters, e_steps=self.e_steps,
                    lr=self.lr, eps=self.eps,
                    adaptive_iters=self.adaptive_iters,
                    escalate_reinit=self.escalate_reinit,
                    lookahead=self.lookahead,
                    features=self.features,
                    dnn_threshold=self.dnn_threshold)

    def _wide_models(self):
        """The float64 copies of the model and the classifier the tick
        runs on, made at the first call."""
        if self._models64 is None:
            self._models64 = tuple(
                None if m is None else copy.deepcopy(m).double()
                for m in (self.model, self.cls))
        return self._models64

    def _run_tick(self, frames, ks, state):
        """`_m2_tick` in float64 on this stream's models and settings;
        frames (P, K, nfft) host float32."""
        return _m2_tick(*self._wide_models(), self.mean, self.std,
                        self._band_map, self._window,
                        torch.as_tensor(frames, dtype=torch.float64,
                                        device=self._dev),
                        ks, state, **self._tick_cfg())

    def _tick_one(self, frames, k):
        """One lane's tick on the stream's own state; returns (y, m) on
        the device without the lane axis."""
        y, m, self._dstate, _ = self._run_tick(
            frames[None], torch.tensor([k], device=self._dev), self._dstate)
        return y[0], m[0]

    def _enhance_frame_batch(self, frames, k):
        with _device_ctx(self._dev):
            y, m = _to_host(*self._tick_one(frames, k))
        return y, m.astype(np.float16)

    # -- one-block lookahead: delayed emission ----------------------------

    def _t_emit_bound(self):
        if self.lookahead and self._la_pending is not None:
            return self._la_pending[0]
        return super()._t_emit_bound()

    def _tick_full(self, frames, k):
        """Run the tick and return the whole window's refined mask at
        float32 (the float16 cast is only for the mask history)."""
        with _device_ctx(self._dev):
            _, m = self._tick_one(frames, k)
            return m.float().cpu().numpy()

    def _synth_rows(self, padded, t0, k, m):
        """Host synthesis of k frames [t0, t0+k) under mask m (k, F): the
        lookahead emission runs one tick behind the device, so the (chunk
        x nfft) synthesis happens from the padded buffer the host holds."""
        window = periodic_hann(NFFT).astype(np.float32)
        fr = self._take_frames(padded, t0, k)[:k]
        X = np.fft.rfft(fr * window[None, :], axis=-1)
        y = np.fft.irfft(np.asarray(m, np.float64) * X, n=NFFT, axis=-1)
        return (y * window[None, :]).astype(np.float32)

    def _accumulate_pending(self, padded, m_full):
        tp, kp = self._la_pending
        # the pending chunk sits right-aligned at the context end:
        # window columns [C - kp, C)
        m_prev = np.asarray(m_full, np.float32)[self.C - kp:self.C]
        y_prev = self._synth_rows(padded, tp, kp, m_prev)
        self._ola_accumulate(tp, y_prev, m_prev.astype(np.float16), kp,
                             advance=False)

    def _process_frames(self, padded, t_end):
        if not self.lookahead:
            return super()._process_frames(padded, t_end)
        while self._t_done < t_end:
            k = min(self.chunk_frames, t_end - self._t_done)
            t0 = self._t_done
            frames = self._take_frames(padded, t0, k)
            m_full = self._tick_full(frames, k)
            if self._la_pending is not None:
                self._accumulate_pending(padded, m_full)
            self._la_pending = (t0, k)
            self._t_done = t0 + k

    def flush(self):
        if not self.lookahead:
            return super().flush()
        self._flushed = True
        if self._raw.size == 0:
            return np.zeros(0, np.float32)
        n_frames = self._flush_pad()
        self._process_frames(self._pad, n_frames)
        if self._la_pending is not None:
            # drain tick: zero new frames (k=0) advance no carry, but the
            # block EM runs once more over the window and refines the
            # final pending chunk before it is emitted
            m_full = self._tick_full(
                np.zeros((self.chunk_frames, NFFT), np.float32), 0)
            self._accumulate_pending(self._pad, m_full)
            self._la_pending = None
        return self._emit_upto(self._raw_drop + self._n_raw)


# ---------------------------------------------------------------------------
# Multi-stream pool: batched concurrent streaming
# ---------------------------------------------------------------------------


class MultiStreamM2Enhancer:
    """Up to `max_streams` concurrent live M2 streams, one batched tick for
    all of them instead of one a stream::

        pool = MultiStreamM2Enhancer(m2, classifier=cls, max_streams=8)
        a, b = pool.open(), pool.open()
        pool.feed(a, chunk_a)           # buffer only, no device work
        pool.feed(b, chunk_b)
        outs = pool.step()              # one tick a chunk for all streams:
                                        # {sid: new enhanced samples}
        tail_a = pool.flush(a)          # end-pad rule + batched drain
        pool.close(a)                   # the slot is recycled by open()

    The stacked recurrent state (one row a slot) stays on the device; each
    tick gathers its lanes' rows, runs `_m2_tick` over them and scatters
    the new state back. A tick runs the live lanes only: eager PyTorch has
    no compile cache to bound, so the JAX package's power-of-two lane
    buckets padded with copies of lane 0 are not needed. Lanes are
    independent, so a stream's output matches a dedicated
    `StreamingM2Enhancer` fed the same samples to float tolerance (the
    batched products may round differently at other lane counts). With
    hard guidance (`soft_guidance=False`) a classifier probability or SPP
    value within an ulp of the threshold can flip a label between the two,
    and with `adaptive_iters` a gain movement at `adaptive_thresh` can
    flip an escalation; soft guidance has the first edge nowhere.

    The pool runs causal lanes: `lookahead=True` raises (its delayed
    emission is a dedicated stream's). `device` as for the stream.

    mesh: a `parallel.Mesh` whose "data" axis the slot rows are split over
    (max_streams must divide by it): each device holds its rows' stacked
    state, and a tick runs EVERY slot row, as the JAX package's sharded
    tick does (idle rows at k=0 on zero frames, their state kept), one
    shard a device in a thread of its own. The slots' enhancers live on
    the axis's first device; `device` is then unused."""

    def __init__(self, model, classifier=None, mean=None, std=None,
                 max_streams=8, mesh=None, device=None, **enhancer_kwargs):
        refuse_rvae(model, "the stream pool")
        if max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        if enhancer_kwargs.get("lookahead"):
            raise ValueError("the pool runs causal lanes; lookahead is a "
                             "dedicated StreamingM2Enhancer's")
        self.mesh = mesh
        if mesh is not None:
            n_dev = data_size(mesh)
            if max_streams % n_dev:
                raise ValueError(
                    f"max_streams ({max_streams}) must be a multiple of "
                    f"the mesh data axis ({n_dev})")
            device = mesh.axis_devices("data")[0]
        self.max_streams = max_streams
        self.chunk_frames = enhancer_kwargs.get("chunk_frames", 8)
        self._dev = resolve_device(device)
        self._kw = dict(model=model, classifier=classifier, mean=mean,
                        std=std, device=self._dev, **enhancer_kwargs)
        # runs every tick (and the constructor's checks, now); the slots'
        # enhancers only frame, overlap-add and emit
        self._proto = StreamingM2Enhancer(**self._kw)
        if mesh is not None:
            # one tick runner a distinct device, with its models' float64
            # copies made here (shard threads share a device's runner)
            models, classifiers = (replicate(mesh, model),
                                   replicate(mesh, classifier))
            self._protos = {d: StreamingM2Enhancer(**{
                **self._kw, "model": models[d], "classifier": classifiers[d],
                "device": d}) for d in models}
            for p in self._protos.values():
                p._wide_models()
        self._slots = {}        # sid -> StreamingM2Enhancer
        self._free = []         # closed enhancers, recycled by open()
        self._next_sid = 0
        self._buffered = {}     # sid -> [arrays] emitted by ticks that
        #                         ran inside another stream's flush()
        self._t_target = {}     # sid -> total frame count after flush()
        self._pool_state = None  # stacked (max_streams, ...) on the device
        self._n_created = 0     # rows handed out (<= max_streams)

    # -- slot management --------------------------------------------------

    def _slot(self, sid):
        try:
            return self._slots[sid]
        except KeyError:
            raise KeyError(f"unknown or closed stream id {sid}") from None

    def open(self):
        """Admit a new stream; returns its id. Raises RuntimeError when the
        pool holds `max_streams` live streams (callers back-pressure, e.g.
        HTTP 429)."""
        if len(self._slots) >= self.max_streams:
            raise RuntimeError(
                f"stream pool full ({self.max_streams} live streams)")
        if self._free:
            enh = self._free.pop()
            enh.reset()
        else:
            enh = StreamingM2Enhancer(**self._kw)
            enh._pool_row = self._n_created
            enh._pool = self    # state views read the resident row
            self._n_created += 1
        if self._pool_state is None:
            # every row starts fresh (enh's just-reset state)
            if self.mesh is None:
                self._pool_state = _tree_map(
                    lambda a: a.repeat((self.max_streams,)
                                       + (1,) * (a.dim() - 1)), enh._dstate)
            else:
                devs = self.mesh.axis_devices("data")
                per = self.max_streams // len(devs)
                self._pool_state = [
                    _tree_map(lambda a, d=d: a.repeat(
                        (per,) + (1,) * (a.dim() - 1)).to(d), enh._dstate)
                    for d in devs]
        else:
            state, row = self._locate(enh._pool_row)

            def put(a, f):
                a[row] = f[0].to(a.device)
            _tree_map(put, state, enh._dstate)
        sid = self._next_sid
        self._next_sid += 1
        self._slots[sid] = enh
        self._buffered[sid] = []
        return sid

    def _locate(self, row):
        """(stacked state holding slot `row`, its index there)."""
        if self.mesh is None:
            return self._pool_state, row
        per = self.max_streams // len(self._pool_state)
        return self._pool_state[row // per], row % per

    def _row_state(self, row):
        """Slot `row`'s recurrent state, without the lane axis."""
        state, r = self._locate(row)
        return _tree_map(lambda a: a[r], state)

    def close(self, sid):
        """Release a stream's slot (its enhancer is recycled). Un-flushed
        streams are dropped."""
        enh = self._slot(sid)
        del self._slots[sid]
        self._buffered.pop(sid, None)
        self._t_target.pop(sid, None)
        self._free.append(enh)

    def masks(self, sid):
        """(F, frames) float16 soft masks of the stream so far."""
        return self._slot(sid).masks

    # -- streaming --------------------------------------------------------

    def feed(self, sid, samples):
        """Buffer samples for a stream; no device work happens here (call
        `step()` to process every stream's ready chunks together)."""
        self._slot(sid)._ingest(samples)

    def _ready(self):
        """Slots with at least one unprocessed frame available."""
        ready = []
        for sid, s in self._slots.items():
            t_end = self._t_target.get(sid)
            if t_end is None:
                t_end = s._t_avail()
            if t_end > s._t_done:
                ready.append((sid, s, t_end))
        return ready

    def _tick(self, ready):
        """One batched tick: each ready slot contributes one chunk; the
        frames go up in one copy, `_m2_tick` runs over the live lanes on
        their gathered state rows, the new rows are scattered back into
        the resident state, and the enhanced frames come back in one copy.
        The host work a tick is frame extraction and overlap-add."""
        lanes = [(s, s._t_done, min(s.chunk_frames, t_end - s._t_done))
                 for _, s, t_end in ready]
        if self.mesh is not None:
            return self._tick_sharded(lanes)
        dev = self._dev
        frames = np.stack([s._take_frames(s._pad, t0, k)
                           for s, t0, k in lanes])
        with _device_ctx(dev):
            rows = torch.tensor([s._pool_row for s, _, _ in lanes],
                                device=dev)
            ks = torch.tensor([k for _, _, k in lanes], device=dev)
            state = _tree_map(lambda a: a.index_select(0, rows),
                              self._pool_state)
            y, m, new, _ = self._proto._run_tick(frames, ks, state)
            _tree_map(lambda a, u: a.index_copy_(0, rows, u),
                      self._pool_state, new)
            y_np, m_np = _to_host(y, m)
        for i, (s, t0, k) in enumerate(lanes):
            s._ola_accumulate(t0, y_np[i], m_np[i].astype(np.float16), k)

    def _tick_sharded(self, lanes):
        """One full-lane tick over the mesh: every slot row runs (rows with
        no ready chunk at k=0 on zero frames), each shard on its device's
        rows and stacked state; a row's new state is kept only where it
        had frames (k > 0)."""
        devs = self.mesh.axis_devices("data")
        per = self.max_streams // len(devs)
        frames = np.zeros((self.max_streams, self.chunk_frames, NFFT),
                          np.float32)
        ks = np.zeros((self.max_streams,), np.int64)
        for s, t0, k in lanes:
            frames[s._pool_row] = s._take_frames(s._pad, t0, k)
            ks[s._pool_row] = k

        def shard(i, d):
            rows = slice(i * per, (i + 1) * per)
            k_d = torch.as_tensor(ks[rows], device=d)
            state = self._pool_state[i]
            y, m, new, _ = self._protos[d]._run_tick(frames[rows], k_d,
                                                     state)
            keep = k_d > 0
            self._pool_state[i] = _tree_map(
                lambda n, o: torch.where(
                    keep.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
                new, state)
            return _to_host(y, m)

        parts = run_shards(self.mesh, shard, self.mesh.cells("data"))
        y_np = np.concatenate([p[0] for p in parts])
        m_np = np.concatenate([p[1] for p in parts])
        for s, t0, k in lanes:
            r = s._pool_row
            s._ola_accumulate(t0, y_np[r], m_np[r].astype(np.float16), k)

    def step(self):
        """Process every ready chunk of every live stream in batched ticks
        and return the newly finalized samples per stream id (streams with
        no new output are omitted)."""
        ready = self._ready()
        while ready:
            self._tick(ready)
            ready = self._ready()
        outs = {}
        for sid, s in self._slots.items():
            parts = self._buffered[sid]
            self._buffered[sid] = []
            if sid in self._t_target:
                if s._t_done >= self._t_target[sid]:
                    parts.append(s._emit_upto(s._raw_drop + s._n_raw))
            else:
                parts.append(s._emit_upto(s._t_done * HOP - NFFT // 2))
                s._maybe_trim()      # bounded memory for long streams
            parts = [p for p in parts if p.size]
            if parts:
                outs[sid] = np.concatenate(parts)
        return outs

    def flush(self, sid):
        """Finalize a stream (end-pad rule), drain it through batched ticks
        (co-draining whatever else is ready; their output is buffered for
        their next `step()`), and return its remaining enhanced samples.
        The slot stays open for `masks()` until `close()`."""
        s = self._slot(sid)
        if s._flushed:
            raise RuntimeError("flush() called twice on one stream")
        s._flushed = True
        if s._raw.size == 0:
            self._t_target[sid] = 0
            return np.zeros(0, np.float32)
        self._t_target[sid] = s._flush_pad()   # extends s._pad in place
        outs = self.step()
        for osid, arr in outs.items():
            if osid != sid:
                self._buffered[osid].append(arr)
        return outs.get(sid, np.zeros(0, np.float32))


# ---------------------------------------------------------------------------
# Thread-safe pool front end for concurrent connection handlers
# ---------------------------------------------------------------------------


class StreamPoolDriver:
    """Thread-safe front end over a `MultiStreamM2Enhancer` for concurrent
    connection handlers (the HTTP `/v1/enhance_stream` route).

    `push()` feeds the caller's stream and blocks until the next batched
    tick: a ticker thread waits `tick_ms` for co-arriving feeds, then runs
    one `pool.step()` for every live stream. A stream's latency grows by at
    most `tick_ms` plus one tick over a dedicated enhancer.

    Lifecycle: `open()` -> `push()` x N -> `flush()` (finalizes and
    releases the slot) or `abort()` (releases without finalizing). A
    ticker that dies makes every later `push()` raise; none hangs."""

    def __init__(self, pool, tick_ms=5.0):
        self._pool = pool
        self._tick_s = tick_ms / 1000.0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._out = {}            # sid -> [np arrays] routed by the ticker
        self._gen = 0             # completed-tick counter
        self._pending = False
        self._stop = False
        self._failed = None       # the ticker's exception: fail fast
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="gvnmf-streampool")
        self._thread.start()

    @property
    def chunk_frames(self):
        return self._pool.chunk_frames

    def _run(self):
        while True:
            with self._wake:
                while not self._pending and not self._stop:
                    self._wake.wait(timeout=0.5)
                if self._stop:
                    return
                self._pending = False
            time.sleep(self._tick_s)       # co-batching window, lock-free
            with self._wake:
                try:
                    outs = self._pool.step()
                except Exception as e:
                    # a dead ticker must not wedge every push()
                    self._failed = e
                    self._stop = True
                    self._wake.notify_all()
                    raise
                for sid, arr in outs.items():
                    if sid in self._out:
                        self._out[sid].append(arr)
                self._gen += 1
                self._wake.notify_all()

    def _check_alive(self):
        if self._failed is not None:
            raise RuntimeError("stream pool ticker died") from self._failed
        if self._stop:
            raise RuntimeError("stream pool driver is shut down")

    def open(self):
        """Admit a stream (raises RuntimeError when the pool is full)."""
        with self._lock:
            sid = self._pool.open()
            self._out[sid] = []
            return sid

    def push(self, sid, samples):
        """Feed samples and return this stream's output of the next batched
        tick (possibly empty). Raises if the ticker died or the driver was
        shut down."""
        with self._wake:
            self._check_alive()
            self._pool.feed(sid, samples)
            self._pending = True
            gen0 = self._gen
            self._wake.notify_all()
            while self._gen == gen0 and not self._stop:
                self._wake.wait(timeout=1.0)
            self._check_alive()
            parts = self._out.get(sid, [])
            if parts:
                self._out[sid] = []
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))

    def flush(self, sid):
        """Finalize the stream (end-pad rule), return its remaining output
        and release the slot, also when the flush raises."""
        with self._lock:
            parts = self._out.pop(sid, [])
            try:
                parts.append(self._pool.flush(sid))
            finally:
                self._pool.close(sid)
        parts = [p for p in parts if p.size]
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))

    def abort(self, sid):
        """Release a stream's slot without finalizing (connection drop)."""
        with self._lock:
            self._out.pop(sid, None)
            try:
                self._pool.close(sid)
            except KeyError:
                pass                       # already flushed / closed

    def shutdown(self):
        """Stop the ticker thread (idempotent). Live slots are dropped."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        self._thread.join(timeout=10)


class PooledStreamSession:
    """Per-connection adapter with the `StreamingM2Enhancer` surface
    (`push` / `flush` / `chunk_frames`, and `close()` for abort paths)
    over a shared `StreamPoolDriver`: a `stream_factory` for
    `http_serving`, so concurrent HTTP streams share one batched tick::

        driver = StreamPoolDriver(MultiStreamM2Enhancer(m2, ...))
        server = EnhancementHTTPServer(
            svc, stream_factory=lambda: PooledStreamSession(driver))
    """

    def __init__(self, driver):
        self._driver = driver
        self.sid = driver.open()
        self.chunk_frames = driver.chunk_frames
        self._done = False

    def push(self, samples):
        return self._driver.push(self.sid, samples)

    def flush(self):
        self._done = True
        return self._driver.flush(self.sid)

    def close(self):
        """Release the slot if the stream was never finalized (abort)."""
        if not self._done:
            self._done = True
            self._driver.abort(self.sid)


__all__ = [
    "MultiStreamM2Enhancer",
    "PooledStreamSession",
    "StreamPoolDriver",
    "StreamingM2Enhancer",
    "StreamingSPPEnhancer",
    "StreamingWienerEnhancer",
]
