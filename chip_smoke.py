#!/usr/bin/env python3
"""Drive the PyTorch port's M2-IBM enhancement main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, in order; any failure exits nonzero without a result line:

1. device: CUDA is required; prints the card's name and power limit.
2. build: compiles `guided_vae_nmf_torch/csrc/*.cu` for sm_90a (timed).
3. kernels vs plain versions, on the card, at full width (F=513, L=32,
   H=128, K=10, the shipped M2-IBM decoder, seeded inputs) at B=2, N=256
   and at the main path's B=4, N=384: the MH chain (K1) in E- and WF-mode
   under injected accept/reject noise and at var_RW=0, and the M-step sums
   (K2) in 'h' and 'g' mode; then, at B=2, N=256, the accept rule under
   real uniforms and the in-kernel Philox stream.
4. main path: four synthetic speech-like mixtures (2-5 s, 5 dB SNR, int16)
   through `enhance_waveform(label_mode="dnn")` with the shipped M2-IBM and
   classifier weights and the default MCEMConfig (100 EM iterations), with
   the launch counters reset before and read after each run; the same
   mixtures as wav files through `enhance_files`; and one short utterance
   on the card against the CPU path at var_RW=0.
5. kernel times at the main-path shapes (CUDA events) beside their bounds
   and their plain versions' times.

Prints the card's name and power limit, a `{"kernels": [...]}` line, and
as its last line `{"ok": true, "device": {...}}`.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = dict(atol=2e-5, rtol=2e-4)
# Lengths of the main path's synthetic mixtures: 2-5 s, so padding and
# frame masks are exercised (they pad to 384 frames).
MAIN_SECONDS = (2.1, 3.3, 4.2, 4.9)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def compare(name, got, ref, atol=TOL["atol"], rtol=TOL["rtol"]):
    """Max abs / rel error of got vs ref (float64 on the host); fails
    where |got - ref| > atol + rtol |ref|."""
    g = got.detach().double().cpu().numpy()
    r = ref.detach().double().cpu().numpy()
    check(g.shape == r.shape, f"{name}: shape {g.shape} vs {r.shape}")
    check(np.all(np.isfinite(g)), f"{name}: non-finite kernel output")
    err = np.abs(g - r)
    rel = err / np.maximum(np.abs(r), 1e-30)
    ok = bool(np.all(err <= atol + rtol * np.abs(r)))
    log(f"  {name:<28s} max_abs {err.max():.3e}  max_rel {rel.max():.3e}  "
        f"tol atol {atol:g} rtol {rtol:g}  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return float(err.max())


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, launches=10, reps=5):
    """Milliseconds per fn() on the card: CUDA events around `launches`
    back-to-back calls, so the device queue stays full and the wrapper's
    host work is hidden; median over `reps` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def chain_inputs(torch, model, B, N, K, seed, device):
    """Seeded chain inputs at full width on the shipped decoder: X2 power
    frames, NMF factors, gains, binary labels -> ypre, Z ~ N(0, 1),
    Vs = decode(Z), and a mask whose last row ends 37 frames early."""
    from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts

    rng = np.random.RandomState(seed)
    dec = model.decoder
    F = dec.out.w.shape[1]
    L = dec.hidden[0].w.shape[0] - model.y_dim
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    y = t((rng.uniform(size=(B, N, model.y_dim)) > 0.5).astype(np.float32))
    l0 = dec.hidden[0]
    Z = t(rng.randn(B, N, L).astype(np.float32))
    mask = np.ones((B, N), np.float32)
    mask[-1, N - 37:] = 0.0
    return dict(
        dec_w=_dec_parts(dec, L),
        X2=t(rng.gamma(0.5, 2.0, (B, N, F)).astype(np.float32) + 1e-3),
        WH=(t(rng.uniform(0.01, 0.2, (B, K, F)).astype(np.float32)),
            t(rng.uniform(0.01, 1.0, (B, K, N)).astype(np.float32))),
        g=t(rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)),
        ypre=(y @ l0.w[L:] + l0.b).contiguous(), Z=Z,
        Vs=dec(torch.cat([Z, y], dim=-1)).contiguous(), mask=t(mask), L=L)


def decisive_noise(torch, seed, B, N, L, n_steps, device):
    """Normals plus accept uniforms of 0 (log u = -inf, always accept) or
    inf (always reject): no decision can flip on rounding differences."""
    rng = np.random.RandomState(seed)
    zn = rng.randn(B, n_steps, N, L).astype(np.float32)
    u = np.where(rng.uniform(size=(B, n_steps, N)) < 0.5, 0.0, np.inf)
    return (torch.tensor(zn, device=device),
            torch.tensor(u.astype(np.float32), device=device))


def speech_like_mixtures(seed, seconds, fs=16000, snr_db=5.0):
    """int16 (clean, mixture) pairs: harmonic voiced tones with a gliding
    f0, formant-like spectral tilt and syllable-rate (~4 Hz) on/off
    amplitude modulation, plus low-passed noise at `snr_db`."""
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        n = int(sec * fs)
        t = np.arange(n) / fs
        f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(
            2 * np.pi * rng.uniform(0.2, 0.6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / fs
        s = np.zeros(n)
        for k in range(1, 30):
            fk = k * f0
            amp = np.exp(-((fk.mean() - 700) / 900) ** 2) / k ** 0.5
            s += np.where(fk < 7000, amp, 0.0) * np.sin(k * phase)
        syl = 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
        gate = (np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6)) > -0.6)
        s *= syl * gate
        noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
        noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2)
                         / 10 ** (snr_db / 10))
        x = s + noise
        scale = 0.5 / np.max(np.abs(x))
        out.append((np.round(s * scale * 32767).astype(np.int16),
                    np.round(x * scale * 32767).astype(np.int16)))
    return out


def si_sdr(ref, est):
    ref = ref.astype(np.float64)
    est = est.astype(np.float64)
    a = np.dot(est, ref) / np.dot(ref, ref)
    e = est - a * ref
    return 10 * np.log10(np.sum((a * ref) ** 2) / np.sum(e**2))


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for one launch
# ---------------------------------------------------------------------------


def chain_bound(B, N, F, L, Hd, K, R, n_steps, mode):
    """(bound_ms, bound_by, flops, bytes) of one K1 launch. Operations per
    frame and step: the decoder's 2 (L Hd + Hd Hd + Hd F) multiply-adds,
    Hd (depth 2: 2 Hd) tanh and F exp, and per bin 8 more (g Vs + Vb,
    floor, reciprocal, log, X2 / Vx, two sums), plus 2 K F per frame to
    form Vb; transcendentals count as one operation. Bytes: every input
    read once and every output written once."""
    per_step = (2 * (L * Hd + Hd * Hd + Hd * F) + 2 * Hd + F + 8 * F
                + 6 * L)
    flops = B * N * (n_steps * per_step + 2 * K * F)
    if mode == "e":
        flops += 2 * 2 * B * K * N * F               # numW / denW
        out_bytes = 4 * (B * N * L + B * N * F + B * R * N * F
                         + 2 * B * K * F)
    else:
        out_bytes = 4 * (B * N * L + 3 * B * N * F)
    in_bytes = 4 * (2 * B * N * F + B * K * F + B * K * N + 2 * B * N
                    + B * N * Hd + B * N * L + L * Hd + Hd * Hd + Hd
                    + Hd * F + F)
    nbytes = in_bytes + out_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def sums_bound(B, R, N, F, K, mode):
    """(bound_ms, bound_by, flops, bytes) of one K2 launch. Operations: 2 K
    per bin to form Vb, 6 per sample (g Vs + Vb, floor, reciprocal and two
    sums), and in 'h' mode 4 K per bin for the H-update contraction."""
    flops = B * N * F * (2 * K + 6 * R + (4 * K if mode == "h" else 2))
    in_bytes = 4 * (B * R * N * F + B * N * F + B * K * F + B * K * N + B * N)
    out_bytes = 4 * 2 * B * N * (K if mode == "h" else 1)
    nbytes = in_bytes + out_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels(torch, model, dev, shapes):
    """Kernel vs plain version at full width, at each (B, N) of `shapes`;
    the Philox and accept-rule checks run at the first. Returns max abs
    errors."""
    from guided_vae_nmf_torch.mcem import (
        mh_chain, mh_chain_ref, nmf_sums, nmf_sums_ref)
    from guided_vae_nmf_torch.mcem.mh_chain import philox_streams

    K = 10
    err = {"mh_chain": 0.0, "nmf_sums": 0.0}

    def chain(c, fn, mode, nsamples, burnin, var_rw, **kw):
        return fn(c["dec_w"], c["X2"], c["WH"], c["g"], c["ypre"], c["Z"],
                  c["Vs"], mode=mode, nsamples=nsamples, burnin=burnin,
                  var_RW=var_rw, mask=c["mask"] if mode == "e" else None,
                  **kw)

    for B, N in shapes:
        c = chain_inputs(torch, model, B, N, K, 1, dev)
        L = c["L"]
        for mode, nsamples, burnin in (("e", 10, 30), ("wf", 25, 75)):
            names = (["Z", "Vs", "samples", "numW", "denW"] if mode == "e"
                     else ["Z", "Vs", "WFs_sum", "WFn_sum"])
            for var_rw, label in ((0.01, "injected"), (0.0, "var_RW=0")):
                if var_rw:
                    kw = dict(noise=decisive_noise(torch, 2, B, N, L,
                                                   nsamples + burnin, dev))
                    kw_ref = kw
                else:
                    kw = dict(seed=3)
                    kw_ref = dict(generator=torch.Generator(
                        device=dev).manual_seed(3))
                got = chain(c, mh_chain, mode, nsamples, burnin, var_rw,
                            **kw)
                ref = chain(c, mh_chain_ref, mode, nsamples, burnin, var_rw,
                            **kw_ref)
                torch.cuda.synchronize()
                log(f" K1 {mode}-mode, {label}, B={B} N={N}:")
                for name, a, b in zip(names, (got[0], got[1]) + got[2],
                                      (ref[0], ref[1]) + ref[2]):
                    err["mh_chain"] = max(err["mh_chain"],
                                          compare(name, a, b))
                if mode == "wf":
                    unity = (got[2][0] + got[2][1]) / nsamples
                    check(torch.allclose(unity, torch.ones_like(unity),
                                         atol=1e-5), "WFs + WFn != 1")
        rng = np.random.RandomState(6)
        samples = torch.tensor(rng.gamma(0.5, 2.0, (B, 10, N, 513)).astype(
            np.float32) + 1e-3, device=dev)
        for mode in ("h", "g"):
            args = (samples, c["WH"], c["g"], c["X2"])
            got = nmf_sums(*args, mode=mode)
            ref = nmf_sums_ref(*args, mode=mode)
            log(f" K2 {mode}-mode, B={B} N={N}:")
            for name, x, y in zip(("num", "den"), got, ref):
                err["nmf_sums"] = max(err["nmf_sums"], compare(name, x, y))

    # the accept rule itself under real uniforms: a decision whose margin
    # is below rounding may flip between the two, so count frames
    B, N = shapes[0]
    c = chain_inputs(torch, model, B, N, K, 1, dev)
    L = c["L"]
    chain_c = lambda *a, **kw: chain(c, *a, **kw)  # noqa: E731
    nsamples, burnin = 10, 30
    gen = np.random.RandomState(9)
    noise = (torch.tensor(gen.randn(B, 40, N, L).astype(np.float32),
                          device=dev),
             torch.tensor(gen.uniform(1e-6, 1, (B, 40, N)).astype(
                 np.float32), device=dev))
    got = chain_c(mh_chain, "e", nsamples, burnin, 0.01, noise=noise)
    ref = chain_c(mh_chain_ref, "e", nsamples, burnin, 0.01, noise=noise)
    same = torch.all(torch.isclose(got[0], ref[0], **TOL), dim=-1)
    frac = same.float().mean().item()
    log(f" K1 e-mode, uniform accept draws: {frac:.4f} of frames follow "
        "the plain version's trajectory (needs >= 0.95)")
    check(frac >= 0.95, "accept decisions disagree with the plain version")

    # in-kernel Philox
    a = chain_c(mh_chain, "e", nsamples, burnin, 0.01, seed=11)
    b = chain_c(mh_chain, "e", nsamples, burnin, 0.01, seed=11)
    check(torch.equal(a[0], b[0]) and torch.equal(a[2][0], b[2][0]),
          "Philox run is not reproducible")
    samples = a[2][0]
    rate = torch.any(samples[:, 1:] != samples[:, :-1],
                     dim=-1).float().mean().item()
    zn, u = philox_streams(11, B, N, L, nsamples + burnin, dev)
    inj = chain_c(mh_chain, "e", nsamples, burnin, 0.01, noise=(zn, u))
    log(f" K1 Philox: reproducible; sampling-phase acceptance {rate:.4f}; "
        f"proposal normals mean {zn.mean().item():+.5f} var "
        f"{zn.var().item():.5f} ({zn.numel()} draws); uniforms in "
        f"({u.min().item():.2e}, {u.max().item():.7f})")
    check(0.0 < rate < 1.0, "acceptance rate not strictly inside (0, 1)")
    check(abs(zn.mean().item()) < 0.01 and abs(zn.var().item() - 1) < 0.01,
          "proposal normals are not standard normal")
    check(torch.equal(a[0], inj[0]) and torch.equal(a[2][0], inj[2][0]),
          "the Philox run differs from the reported streams")
    return err


def main_batch(seed):
    """The main path's batch: (clean, mixture) int16 pairs of MAIN_SECONDS,
    the host-padded mixtures (B, L) and their frame masks (B, n_pad)."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.pipeline import HOP, NFFT, bucket_frames

    pairs = speech_like_mixtures(seed, MAIN_SECONDS)
    padded = [pad_signal_for_stft(x) for _, x in pairs]
    n_pad = bucket_frames(max(nf for _, nf in padded))
    Lw = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((len(pairs), Lw), np.int16)
    mask = np.zeros((len(pairs), n_pad), np.float32)
    for j, (xp, nf) in enumerate(padded):
        x_b[j, : min(len(xp), Lw)] = xp[:Lw]
        mask[j, :nf] = 1.0
    return pairs, x_b, mask


def phase_main(torch, model, classifier, mean, std, cfg, batch, seed, dev,
               gpu):
    """The main path through enhance_waveform; returns its shapes, times
    and launch counts."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.pipeline import NFFT, enhance_waveform

    pairs, x_b, mask = batch
    n_pad = mask.shape[1]
    audio_s = sum(MAIN_SECONDS)
    log(f" batch: B={len(pairs)}, {audio_s:.1f} s of audio, n_pad={n_pad} "
        f"frames, {cfg.niter} EM iterations")

    walls = []
    for rep in range(3):
        port.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s16, n16, y_soft, y_hard, ok = enhance_waveform(
            model, x_b, mask, cfg, classifier=classifier, mean=mean, std=std,
            label_mode="dnn", return_noise=True, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed + rep))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = port.launch_counts()
        log(f"  run {rep}: {walls[-1]:.3f} s wall, launches {counts}")
        check(counts == {"mh_chain": cfg.niter + 1,
                         "nmf_sums": 2 * cfg.niter},
              f"main path launches {counts}, expected 101 K1 and 200 K2")
    s16, n16, ok = (a.cpu().numpy() for a in (s16, n16, ok))
    check(bool(ok.all()), "non-finite enhancement output")
    check(s16.shape == (len(pairs), x_b.shape[1] - NFFT),
          f"s shape {s16.shape}")
    check(y_soft.shape == (len(pairs), 513, n_pad), "soft label shape")
    check(y_hard.shape == (len(pairs), 65, n_pad), "packed label shape")
    worst = 0
    for j, (clean, x) in enumerate(pairs):
        T = len(x)
        # WFs + WFn = 1, so s + n is the mixture up to PCM rounding
        recon = s16[j][:T].astype(np.int32) + n16[j][:T].astype(np.int32)
        worst = max(worst, int(np.abs(recon - x.astype(np.int32)).max()))
        log(f"  utt {j}: {T / 16000:.1f} s, SI-SDR mixture "
            f"{si_sdr(clean, x):+.2f} dB -> enhanced "
            f"{si_sdr(clean, s16[j][:T]):+.2f} dB")
    log(f"  |s + n - x| max {worst} LSB (needs <= 2: WFs + WFn = 1)")
    check(worst <= 2, "Wiener gains do not sum to one")
    wall = float(np.median(walls[1:]))
    log(f" main path: {wall:.3f} s wall for {audio_s:.1f} s of audio = "
        f"{audio_s / wall:.2f}x realtime (median of runs 1-2; {gpu})")
    return {"n_pad": n_pad, "B": len(pairs), "wall_s": wall,
            "walls_s": walls, "audio_s": audio_s,
            "x_realtime": audio_s / wall,
            "launches": port.launch_counts()}


def phase_files(torch, model, classifier, mean, std, pairs, cfg, seed,
                dev):
    """The same mixtures as wav files through enhance_files."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.data import read_wav_int16, write_wav
    from guided_vae_nmf_torch.pipeline import enhance_files, plan_batches

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        files = []
        for j, (_, x) in enumerate(pairs):
            write_wav(os.path.join(src, f"utt{j}_x.wav"), x, 16000)
            files.append(f"utt{j}.wav")
        port.reset_launch_counts()
        res = enhance_files(files, src, dst, model, classif_type="dnn",
                            classifier=classifier, mean=mean, std=std,
                            cfg=cfg, seed=seed, device=dev)
        counts = port.launch_counts()
        from guided_vae_nmf_torch.dsp import frame_count

        n_batches = len(plan_batches(
            files, [frame_count(len(x)) for _, x in pairs]))
        log(f" enhance_files: {res.n_processed} files in {float(res):.3f} s, "
            f"{n_batches} batches, launches {counts}")
        check(counts == {"mh_chain": (cfg.niter + 1) * n_batches,
                         "nmf_sums": 2 * cfg.niter * n_batches},
              "enhance_files did not run 101 K1 / 200 K2 launches a batch")
        for j, (_, x) in enumerate(pairs):
            s, _ = read_wav_int16(os.path.join(dst, f"utt{j}_s_est.wav"))
            n, _ = read_wav_int16(os.path.join(dst, f"utt{j}_n_est.wav"))
            yh = np.load(os.path.join(dst, f"utt{j}_ibm_hard_est.npy"))
            check(len(s) == len(x) and len(n) == len(x), "output length")
            check(np.array_equal(
                np.clip(x.astype(np.int32) - s, -32768, 32767), n),
                "n_est != x - s_est")
            check(yh.shape[0] == 513, "hard label shape")
            check(np.any(s != x), "enhance_files wrote passthrough")


def phase_reference(torch, model, classifier, mean, std, pairs, dev):
    """One short utterance on the card against the CPU path (plain
    versions) at var_RW=0, where the chains are deterministic."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.pipeline import (
        HOP, NFFT, bucket_frames, enhance_waveform)

    x = pairs[0][1][:16000]
    xp, nf = pad_signal_for_stft(x)
    n_pad = bucket_frames(nf)
    Lw = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((1, Lw), np.int16)
    x_b[0, : min(len(xp), Lw)] = xp[:Lw]
    mask = np.zeros((1, n_pad), np.float32)
    mask[0, :nf] = 1
    cfg = MCEMConfig(niter=3, nsamples_E_step=3, burnin_E_step=2,
                     nsamples_WF=3, burnin_WF=2, var_RW=0.0)
    rng = np.random.RandomState(5)
    init = {"W": rng.uniform(0.05, 1, (1, 513, 10)).astype(np.float32),
            "H": rng.uniform(0.05, 1, (1, 10, n_pad)).astype(np.float32)}
    outs = {}
    for d in ("cpu", dev):
        mods = [m.to(d) for m in (model, classifier)]
        outs[str(d)] = [a if a is None else a.cpu().numpy()
                        for a in enhance_waveform(
            mods[0], x_b, mask, cfg, classifier=mods[1], mean=mean, std=std,
            label_mode="dnn", device=d,
            init={k: torch.tensor(v, device=d) for k, v in init.items()})]
    for m in (model, classifier):
        m.to(dev)
    g, r = outs[str(dev)], outs["cpu"]
    diff = int(np.abs(g[0].astype(np.int32) - r[0].astype(np.int32)).max())
    log(f" card vs CPU path, 1 s at var_RW=0: max |s16 diff| {diff} LSB "
        f"(needs <= 2); hard labels equal: {np.array_equal(g[3], r[3])}")
    check(diff <= 2, "card and CPU paths disagree")
    check(np.array_equal(g[3], r[3]), "card and CPU labels disagree")


def phase_profile(torch, model, classifier, mean, std, x_b, mask, cfg,
                  dev, gpu):
    """One main-path batch under torch.profiler: device time by kernel
    group and the device's busy share of the wall time. Informational: the
    profiler's own cost inflates the wall time it is divided by."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from guided_vae_nmf_torch.pipeline import enhance_waveform

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enhance_waveform(model, x_b, mask, cfg, classifier=classifier,
                         mean=mean, std=std, label_mode="dnn", device=dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = {"mh_chain": 0.0, "nmf_sums": 0.0, "other": 0.0}
    other = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue     # host ops: their device time is their kernels'
        us = evt.self_device_time_total
        if not us:
            continue
        if "mh_chain_kernel" in evt.key or "sum_tiles_kernel" in evt.key:
            groups["mh_chain"] += us / 1e3
        elif "nmf_sums_kernel" in evt.key:
            groups["nmf_sums"] += us / 1e3
        else:
            groups["other"] += us / 1e3
            other[evt.key[:60]] = other.get(evt.key[:60], 0.0) + us / 1e3
    busy = sum(groups.values())
    if busy == 0.0:
        log(" profile: the profiler saw no device time (not measured)")
        return None
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    log(f" profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%); K1 {groups['mh_chain']:.2f} ms, "
        f"K2 {groups['nmf_sums']:.2f} ms, other kernels "
        f"{groups['other']:.2f} ms; {gpu}")
    for name, ms in top:
        log(f"   other: {ms:8.3f} ms  {name}")
    return {"wall_ms": wall_ms, "device_ms": groups, "busy_ms": busy,
            "top_other": top}


def phase_times(torch, model, cfg, B, N, dev, gpu, err, launches):
    """Per-launch kernel times at the main-path shapes, beside bounds and
    the plain versions' times; returns the `kernels` entries."""
    from guided_vae_nmf_torch.mcem import (
        mh_chain, mh_chain_ref, nmf_sums, nmf_sums_ref)

    K = cfg.nmf_rank
    c = chain_inputs(torch, model, B, N, K, 7, dev)
    L, F, Hd = c["L"], c["X2"].shape[-1], c["ypre"].shape[-1]

    def chain(fn, mode, nsamples, burnin, **kw):
        return lambda: fn(c["dec_w"], c["X2"], c["WH"], c["g"], c["ypre"],
                          c["Z"], c["Vs"], mode=mode, nsamples=nsamples,
                          burnin=burnin, var_RW=cfg.var_RW,
                          mask=c["mask"] if mode == "e" else None, **kw)

    gen = torch.Generator(device=dev).manual_seed(0)
    modes = {}
    for mode, ns, bi in (("e", cfg.nsamples_E_step, cfg.burnin_E_step),
                         ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
        bound, by, flops, nbytes = chain_bound(B, N, F, L, Hd, K, ns,
                                               ns + bi, mode)
        modes[mode] = dict(ms=time_cuda(chain(mh_chain, mode, ns, bi,
                                              seed=1)),
                           plain_ms=time_cuda(chain(mh_chain_ref, mode, ns,
                                                    bi, generator=gen),
                                              launches=2, reps=3),
                           bound_ms=bound, bound_by=by, flops=flops,
                           bytes=nbytes)
    R = cfg.nsamples_E_step
    samples = chain(mh_chain, "e", R, cfg.burnin_E_step, seed=2)()[2][0]
    smodes = {}
    for mode in ("h", "g"):
        args = (samples, c["WH"], c["g"], c["X2"])
        bound, by, flops, nbytes = sums_bound(B, R, N, F, K, mode)
        smodes[mode] = dict(
            ms=time_cuda(lambda: nmf_sums(*args, mode=mode)),
            plain_ms=time_cuda(lambda: nmf_sums_ref(*args, mode=mode)),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)

    def mix(ms, weights):
        """Per-launch averages over the main path's launch mix; bound_by
        is that of the mode with the largest share of the bound."""
        tot = sum(weights.values())
        out = {k: sum(weights[m] * ms[m][k] for m in ms) / tot
               for k in ("ms", "plain_ms", "bound_ms")}
        top = max(ms, key=lambda m: weights[m] * ms[m]["bound_ms"])
        out["bound_by"] = ms[top]["bound_by"]
        return out

    k1 = mix(modes, {"e": cfg.niter, "wf": 1})
    k2 = mix(smodes, {"h": 1, "g": 1})
    for name, m in (("K1 mh_chain", modes), ("K2 nmf_sums", smodes)):
        for mode, v in m.items():
            log(f"  {name} {mode:>2s}: {v['ms']:.4f} ms (plain "
                f"{v['plain_ms']:.3f} ms), bound {v['bound_ms']:.4f} ms by "
                f"{v['bound_by']} ({v['flops'] / 1e9:.3f} GFLOP, "
                f"{v['bytes'] / 1e6:.2f} MB) = "
                f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound; {gpu}")
    kernels = [
        dict(name="mh_chain", route="cuda",
             source="guided_vae_nmf_torch/csrc/mh_chain.cu",
             replaces="guided_vae_nmf_tpu/mcem/pallas_engine.py:494",
             launches=launches["mh_chain"], max_abs_err=err["mh_chain"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             shape=dict(B=B, N=N, F=F, L=L, H=Hd, K=K),
             modes=modes),
        dict(name="nmf_sums", route="cuda",
             source="guided_vae_nmf_torch/csrc/nmf_sums.cu",
             replaces="guided_vae_nmf_tpu/mcem/pallas_engine.py:651",
             launches=launches["nmf_sums"], max_abs_err=err["nmf_sums"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             shape=dict(B=B, R=R, N=N, F=F, K=K),
             modes=smodes),
    ]
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "chip_smoke.json"),
                    help="where the full JSON record goes")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "guided_vae_nmf_torch")):
        print("chip_smoke: the guided_vae_nmf_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.train import (
        load_classifier_meta, load_model, load_norm_stats)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_name_and_limit()
    log(f"device: {gpu} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    build_s = _build.build_all()
    log(f"build: csrc/*.cu for sm_90a in {build_s:.1f} s")

    art = os.path.join(root, "artifacts", "pretrained")
    model = load_model(os.path.join(art, "M2_ibm"), kind="dgm", y_dim=513,
                       device=dev)
    cdir = os.path.join(art, "classifier_ibm")
    classifier = load_model(cdir, kind="classifier", device=dev)
    mean, std = load_norm_stats(cdir)
    meta = load_classifier_meta(cdir)
    check(meta == {"features": "power", "threshold": 0.5},
          f"unexpected classifier protocol {meta}")

    batch = main_batch(args.seed)
    pairs, x_b, mask = batch
    log("kernels vs plain versions (full width, M2-IBM decoder):")
    err = phase_kernels(torch, model, dev, [(2, 256), mask.shape])
    log("main path (enhance_waveform, label_mode='dnn', MCEMConfig()):")
    cfg = MCEMConfig()
    main_res = phase_main(torch, model, classifier, mean, std, cfg, batch,
                          args.seed, dev, gpu)
    phase_files(torch, model, classifier, mean, std, pairs, cfg, args.seed,
                dev)
    phase_reference(torch, model, classifier, mean, std, pairs, dev)
    prof = phase_profile(torch, model, classifier, mean, std, x_b, mask, cfg,
                         dev, gpu)
    log("kernel times at the main-path shapes:")
    kernels = phase_times(torch, model, cfg, *mask.shape, dev, gpu, err,
                          main_res["launches"])

    record = {
        "gpu": gpu, "torch": torch.__version__, "build_s": build_s,
        "main_path": main_res, "profile": prof, "kernels": kernels,
        "seconds": time.perf_counter() - t_start,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {record['seconds']:.1f} s; record in {args.out}")
    print(gpu)
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k not in ("shape", "modes")}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
