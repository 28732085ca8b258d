"""Shard-balance / padding-waste harness for the mesh-sharded sweep
(counterpart of the JAX package's scripts/bench_shard_balance.py).

Synthesizes a deliberately skewed-length utterance set (lengths vary
about 10x), plans it with the mesh-aware batcher
(`pipeline.plan_batches`), and reports:

  * the batch plan (sizes x bucket n_pad),
  * duplicate-row padding waste (rows computed but never written),
  * frame-padding waste ((n_pad - n_frames) work inside kept rows),
  * per-shard assigned frame counts (load balance across the data axis),
  * the wall of the single-device and the sharded sweep, and
  * equality of the sharded outputs with the single-device sweep on the
    same ragged set.

The sweeps run the eager engine (`engine="xla"`, oracle labels), whose
rows draw from their own seeds whatever their batch, so the two sweeps
agree within the 4 LSB the JAX harness allows (a row in another batch
may round differently: the float64 products are blocked by the batch's
shape). `--cpu 0` (the default) runs on `make_mesh()`, every visible
card, and raises without one; `--cpu 1` runs on a mesh of eight CPU
devices (`make_mesh(devices=[cpu] * 8)`: eight shard threads on the
host).

Usage: python -m guided_vae_nmf_torch.scripts.bench_shard_balance
       [--utts 22] [--niter 3] [--cpu 0]
"""

import os
import sys
import tempfile
import time

from ._common import flag


def account(plan, label, files, n_frames_all, n_dev):
    """Print a plan's batches, duplicate-row and frame-padding waste and
    per-shard frames; returns (duplicate work, padded frames, total
    work) in row-frames."""
    import numpy as np

    from ..parallel import pad_to_multiple

    nf = dict(zip(files, n_frames_all))
    dup_rows = kept_frames = pad_frames = 0
    shard_frames = np.zeros(n_dev, np.int64)
    for paths, n_pad, _ in plan:
        B = len(paths)
        Bp = pad_to_multiple(B, n_dev)
        dup_rows += Bp - B
        kept_frames += sum(nf[p] for p in paths)
        pad_frames += sum(n_pad - nf[p] for p in paths)
        # row r of the padded batch lands on shard r * n_dev // Bp
        for r in range(Bp):
            shard_frames[r * n_dev // Bp] += n_pad
    print(f"\n[{label}] batches: " + ", ".join(
        f"{len(p)}x{n}" for p, n, _ in plan))
    dup_work = sum((pad_to_multiple(len(p), n_dev) - len(p)) * n
                   for p, n, _ in plan)
    tot_work = sum(pad_to_multiple(len(p), n_dev) * n for p, n, _ in plan)
    print(f"[{label}] duplicate rows: {dup_rows} "
          f"({100.0 * dup_work / tot_work:.1f}% of row-frame work)")
    print(f"[{label}] frame padding: {pad_frames} frames "
          f"({100.0 * pad_frames / tot_work:.1f}% of work; "
          f"{kept_frames} real)")
    print(f"[{label}] per-shard frames: {shard_frames.tolist()} "
          f"(imbalance {shard_frames.max() / shard_frames.mean():.2f}x)")
    return dup_work, pad_frames, tot_work


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_utts = flag(argv, "utts", 22, int)
    niter = flag(argv, "niter", 3, int)
    use_cpu = flag(argv, "cpu", 0, int)

    import numpy as np
    import torch

    from ..data import read_wav, write_wav
    from ..dsp.stft import frame_count
    from ..mcem import MCEMConfig
    from ..models import dgm_init
    from ..parallel import make_mesh
    from ..pipeline import enhance_files, plan_batches

    FS = 16000
    if use_cpu:
        dev = torch.device("cpu")
        mesh = make_mesh(devices=[dev] * 8)
    else:
        mesh = make_mesh()
        dev = mesh.devices.ravel()[0]
    n_dev = mesh.shape["data"]
    result = {}
    with tempfile.TemporaryDirectory() as work:
        proc = os.path.join(work, "proc")
        os.makedirs(proc)
        # skewed lengths: half short (1-2 s), a third medium (3-6 s), the
        # rest long (8-14 s)
        rng = np.random.RandomState(0)
        files = []
        for i in range(n_utts):
            if i % 2 == 0:
                sec = rng.uniform(1.0, 2.0)
            elif i % 3 == 0:
                sec = rng.uniform(8.0, 14.0)
            else:
                sec = rng.uniform(3.0, 6.0)
            n = int(sec * FS)
            t = np.arange(n) / FS
            s = 0.1 * np.sin(2 * np.pi * np.cumsum(
                140 + 40 * np.sin(2 * np.pi * 0.4 * t + i)) / FS)
            s *= np.clip(np.sin(2 * np.pi * 1.9 * t + 0.3 * i), 0, None)
            x = s + 0.05 * rng.randn(n)
            write_wav(os.path.join(proc, f"utt{i:03d}_s.wav"),
                      s.astype(np.float32), FS)
            write_wav(os.path.join(proc, f"utt{i:03d}_x.wav"),
                      x.astype(np.float32), FS)
            files.append(f"utt{i:03d}.wav")
        n_frames_all = [
            frame_count(len(read_wav(os.path.join(
                proc, f"utt{i:03d}_x.wav"))[0])) for i in range(n_utts)]

        naive = plan_batches(files, n_frames_all, batch_size=16, n_dev=1,
                             seed=0)
        account(naive, "mesh-naive plan (n_dev=1 cuts, mesh padding)",
                files, n_frames_all, n_dev)
        plan = plan_batches(files, n_frames_all, batch_size=16,
                            n_dev=n_dev, seed=0)
        dup_work, pad_frames, tot_work = account(
            plan, "mesh-aware plan", files, n_frames_all, n_dev)
        assert dup_work / tot_work < 0.10, "duplicate-row waste exceeds 10%"

        dgm = dgm_init(torch.Generator().manual_seed(0),
                       [513, 513, 8, [32]]).to(dev)
        cfg = MCEMConfig(niter=niter, nsamples_E_step=2, burnin_E_step=2,
                         nsamples_WF=2, burnin_WF=2)
        kw = dict(model_type="m2", classif_type="oracle", cfg=cfg,
                  batch_size=16, engine="xla")
        t0 = time.perf_counter()
        enhance_files(files, proc, os.path.join(work, "single"), dgm,
                      device=dev, **kw)
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        enhance_files(files, proc, os.path.join(work, "mesh"), dgm,
                      mesh=mesh, **kw)
        t_mesh = time.perf_counter() - t0
        worst = 0.0
        for i in range(n_utts):
            s1, _ = read_wav(os.path.join(work, "single",
                                          f"utt{i:03d}_s_est.wav"))
            sm, _ = read_wav(os.path.join(work, "mesh",
                                          f"utt{i:03d}_s_est.wav"))
            assert len(s1) == len(sm)
            worst = max(worst, float(np.max(np.abs(s1 - sm))))
        print(f"\nsharded == single-device on the ragged set: "
              f"max |delta| = {worst * 32768:.1f} LSB (PCM16)")
        assert worst <= 4.0 / 32768
        where = ("CPU shard threads share the host" if use_cpu
                 else "this machine's cards")
        print(f"wall: single-device {t_single:.1f}s, {n_dev}-way mesh "
              f"{t_mesh:.1f}s ({where})")
        result = {"n_dev": n_dev, "batches": len(plan),
                  "dup_share": dup_work / tot_work,
                  "pad_share": pad_frames / tot_work, "lsb": worst * 32768,
                  "single_s": t_single, "mesh_s": t_mesh}
    return result


if __name__ == "__main__":
    main()
