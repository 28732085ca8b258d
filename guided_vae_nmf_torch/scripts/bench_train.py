"""Training-throughput benchmark (counterpart of the JAX package's
scripts/bench_train.py).

Builds the diverse-noise labeled frame set the shipped checkpoints use
(pretrain_subset.build_dataset over `<data_root>/<dataset_size>/raw/`),
times `train_m2` for --epochs epochs at the reference batch size, and
prints one JSON line with frames/s and epoch wall-clock. `--stream R`
also trains from an HDF5 store of the frames replicated R times through
the double-buffered `H5StreamSource`. `--torch_baseline 1` also times the
reference's own torch model + SVI loop (its Python tree under
`--reference`, on the CPU) on the same frames; without that tree it says
it skipped the baseline.

Usage: python -m guided_vae_nmf_torch.scripts.bench_train [--epochs 20]
       [--batch_size 256] [--hidden 128] [--z 32] [--stream 0]
       [--torch_baseline 0 [--reference <reference repo>]] [--work <dir>]
       [--data_root data] [--dataset_size subset] [--device cuda|cpu]

--work defaults to a temporary directory, removed at the end.
"""

import json
import os
import shutil
import sys
import tempfile
import time

from ..config import PathsConfig, apply_overrides
from ._common import backend_info, device, flag
from .pretrain_subset import build_dataset


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, argv = apply_overrides(PathsConfig(), argv)
    epochs = flag(argv, "epochs", 20, int)
    batch_size = flag(argv, "batch_size", 256, int)
    hidden = flag(argv, "hidden", 128, int)
    z_dim = flag(argv, "z", 32, int)
    dims = (513, 513, z_dim, (hidden, hidden))
    torch_baseline = flag(argv, "torch_baseline", 0, int)
    reference = flag(argv, "reference", None)
    work = flag(argv, "work", None)
    stream = flag(argv, "stream", 0, int)
    dev = device(argv)

    from ..train import TrainConfig, train_m2

    (Xtr, Ytr), (Xva, Yva) = build_dataset(
        os.path.join(paths.data_root, paths.dataset_size))
    n_frames = len(Xtr)

    own = work is None
    if own:
        work = tempfile.mkdtemp(prefix="gvnmf_bench_train_")
    try:
        cfg = TrainConfig(end_epoch=epochs, batch_size=batch_size)
        t0 = time.perf_counter()
        _, hist = train_m2((Xtr, Ytr), (Xva, Yva), dims=dims, cfg=cfg,
                           model_dir=os.path.join(work, "M2"), name="M2",
                           device=dev)
        wall = time.perf_counter() - t0
        # the first epoch carries the first fit's start-up; epochs 2.. are
        # steady state
        steady = [h["time_s"] for h in hist[1:]] or [hist[0]["time_s"]]
        steady_epoch = sum(steady) / len(steady)

        result = {
            "epochs": epochs,
            "train_frames": n_frames,
            "batch_size": batch_size,
            "wall_s": round(wall, 2),
            "first_epoch_s": round(hist[0]["time_s"], 3),
            "steady_epoch_s": round(steady_epoch, 3),
            "steady_frames_per_s": round(n_frames / steady_epoch, 0),
        }

        if torch_baseline:
            if reference and os.path.isdir(os.path.join(reference,
                                                         "python")):
                result["torch_epoch_s"] = round(
                    _torch_epoch((Xtr, Ytr), batch_size, reference), 3)
                result["torch_frames_per_s"] = round(
                    n_frames / result["torch_epoch_s"], 0)
            else:
                print(f"reference tree {reference!r} absent; skipping the "
                      "torch baseline", flush=True)

        if stream:
            result.update(_stream_bench(
                (Xtr, Ytr), (Xva, Yva), cfg, work, dev, replicate=stream,
                dims=dims, base_rate=result["steady_frames_per_s"]))
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)

    result.update(backend_info())
    print(json.dumps(result))
    return result


def _stream_bench(train_data, valid_data, cfg, work, dev, replicate=10,
                  base_rate=None, dims=(513, 513, 32, (128, 128))):
    """Beyond-memory ingestion benchmark: replicate the frame set
    `replicate`x into an HDF5 store and train through the double-buffered
    H5StreamSource (data/h5io.py): the store's reads and host-to-device
    copies of chunk i+1 overlap the training steps over chunk i. Reports
    the streaming frames/s and its fraction of the in-memory rate."""
    from ..data import H5FrameWriter, H5StreamSource
    from ..train import TrainConfig, train_m2

    X, Y = train_data
    h5p = os.path.join(work, f"stream_{replicate}x.h5")
    usable = False
    if os.path.exists(h5p):
        try:  # a crashed writer leaves a file without the datasets
            H5StreamSource(h5p, "train").close()
            usable = True
        except (OSError, KeyError):
            os.remove(h5p)
    if not usable:
        w = H5FrameWriter(h5p, "train", compression=None,
                          chunk_frames=4096)
        for _ in range(replicate):
            w.append(X.T, Y.T)
        w.finalize()
    chunk = max(cfg.batch_size, (len(X) // cfg.batch_size)
                * cfg.batch_size)
    src = H5StreamSource(h5p, "train", chunk_frames=chunk, seed=0)
    n = src.n_chunks * src.chunk_frames
    scfg = TrainConfig(end_epoch=3, batch_size=cfg.batch_size)
    try:
        _, hist = train_m2(src, valid_data, dims=dims, cfg=scfg,
                           model_dir=os.path.join(work, "M2_stream"),
                           name="M2", device=dev)
    finally:
        src.close()
    steady = [h["time_s"] for h in hist[1:]] or [hist[0]["time_s"]]
    ep = sum(steady) / len(steady)
    out = {
        "stream_replicate": replicate,
        "stream_frames": n,
        "stream_epoch_s": round(ep, 3),
        "stream_frames_per_s": round(n / ep, 0),
    }
    if base_rate:
        out["stream_vs_inmem"] = round(out["stream_frames_per_s"]
                                       / base_rate, 3)
    return out


def _torch_epoch(train_data, batch_size, reference):
    """One epoch of the reference's own training step (torch, CPU):
    `r, mu, logvar = model(x, y); loss = elbo(...); backward; Adam`
    (reference scripts/training_M2.py:114-118), on the same frames."""
    import torch

    if reference not in sys.path:
        sys.path.insert(0, reference)
    from python.models.models import DeepGenerativeModel
    from python.models.utils import elbo

    X, Y = train_data
    model = DeepGenerativeModel([513, 513, 32, [128, 128]], None)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999))
    model.train()
    t0 = time.perf_counter()
    for lo in range(0, len(X) - batch_size + 1, batch_size):
        xb = torch.from_numpy(X[lo:lo + batch_size])
        yb = torch.from_numpy(Y[lo:lo + batch_size])
        r, mu, logvar = model(xb, yb)
        loss, recon, kl = elbo(xb, r, mu, logvar, 1e-8)
        loss.backward()
        opt.step()
        opt.zero_grad()
        float(loss.item())
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
