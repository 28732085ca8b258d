"""HDF5 frame stores: self-describing training datasets with STFT metadata
in attrs, resizable lzf-compressed (bins, frames) arrays, running mean/std
side-datasets, and a host-side frame-batch iterator feeding the jitted
training loop.

Capability parity with reference scripts/create_train_set.py:92-156 and
create_noisy_train_set.py:137-331 (schema: X_<split>/Y_<split> float32,
chunks (bins, 1), attrs fs/wlen_sec/hop_percent/win/dtype/quantile_* plus
X_<split>_mean / X_<split>_std) and python/data.py:28-82 (frame datasets).

The port's own copy of `guided_vae_nmf_tpu/data/h5io.py` (numpy and h5py):
each package reads the other's stores. `trainer.fit` copies the frames to
the device once and indexes them there; an `H5StreamSource` feeds it
chunk by chunk instead. h5py is imported when a store is opened, so the
rest of the port runs where h5py is not installed.
"""

import numpy as np


def _h5():
    import h5py

    return h5py


DEFAULT_ATTRS = {
    "fs": 16000,
    "wlen_sec": 64e-3,
    "hop_percent": 0.25,
    "win": "hann",
    "dtype": "complex64",
    "quantile_fraction": 0.98,
    "quantile_weight": 0.999,
}


class H5FrameWriter:
    """Appendable (bins, frames) X/Y store with the reference's schema."""

    def __init__(self, path, dataset_type, x_bins=513, y_bins=513,
                 attrs=None, compression="lzf", rdcc_nbytes=1024**2 * 400,
                 rdcc_nslots=int(1e5), track_stats=True,
                 chunk_frames=1):
        self.f = _h5().File(path, "a", rdcc_nbytes=rdcc_nbytes,
                         rdcc_nslots=rdcc_nslots)
        self.dataset_type = dataset_type
        self.compression = compression
        for k, v in {**DEFAULT_ATTRS, **(attrs or {})}.items():
            self.f.attrs[k] = v
        # (bins, 1) is the reference schema (one frame per HDF5 chunk,
        # python/data.py:53-82); streaming training stores want large
        # frame blocks instead: column reads over (bins, 1) chunks cost
        # one B-tree lookup per frame
        self.f.attrs["X_chunks"] = (x_bins, chunk_frames)
        self.f.attrs["Y_chunks"] = (y_bins, chunk_frames)
        self.f.attrs["compression"] = compression or "none"

        for name, bins in (("X_" + dataset_type, x_bins),
                           ("Y_" + dataset_type, y_bins)):
            if name in self.f:
                del self.f[name]
        self.fx = self.f.create_dataset(
            "X_" + dataset_type, shape=(x_bins, 0), dtype="float32",
            maxshape=(x_bins, None), chunks=(x_bins, chunk_frames),
            compression=compression,
        )
        self.fy = self.f.create_dataset(
            "Y_" + dataset_type, shape=(y_bins, 0), dtype="float32",
            maxshape=(y_bins, None), chunks=(y_bins, chunk_frames),
            compression=compression,
        )
        self.track_stats = track_stats
        self._sum = np.zeros((x_bins, 1), np.float64)
        self._sum_sq = np.zeros((x_bins, 1), np.float64)
        self._n = 0

    def append(self, spectrogram, label):
        """Append (bins, n) spectrogram/label frame columns."""
        n = spectrogram.shape[1]
        self.fx.resize(self.fx.shape[1] + n, axis=1)
        self.fx[:, -n:] = spectrogram
        self.fy.resize(self.fy.shape[1] + n, axis=1)
        self.fy[:, -n:] = label
        if self.track_stats:
            self._sum += spectrogram.sum(axis=1, keepdims=True)
            self._sum_sq += (spectrogram.astype(np.float64) ** 2).sum(
                axis=1, keepdims=True
            )
            self._n += n

    def finalize(self):
        """Write X_<split>_mean / X_<split>_std (reference
        create_noisy_train_set.py:299-331) and close."""
        if self.track_stats and self._n > 0:
            mean = (self._sum / self._n).astype(np.float32)
            var = self._sum_sq / self._n - (self._sum / self._n) ** 2
            std = np.sqrt(np.maximum(var, 0)).astype(np.float32)
            for suffix, data in (("_mean", mean), ("_std", std)):
                name = "X_" + self.dataset_type + suffix
                if name in self.f:
                    del self.f[name]
                d = self.f.create_dataset(
                    name, shape=data.shape, dtype="float32",
                    compression=self.compression,
                )
                d[...] = data
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()


class H5FrameReader:
    """Lazy frame access over an H5 store (reference python/data.py:53-82).

    Unlike the reference's torch Dataset (one 513-dim column per
    __getitem__ across 8 worker processes), batches are sliced directly as
    contiguous or gathered column blocks: the trainer wants (batch, bins)
    arrays, not items.
    """

    def __init__(self, path, dataset_type, rdcc_nbytes=1024**2 * 400,
                 rdcc_nslots=int(1e5)):
        self.f = _h5().File(path, "r", rdcc_nbytes=rdcc_nbytes,
                         rdcc_nslots=rdcc_nslots)
        self.X = self.f["X_" + dataset_type]
        self.Y = self.f["Y_" + dataset_type]
        self.attrs = dict(self.f.attrs)
        self.n_frames = self.X.shape[1]
        self.mean = None
        self.std = None
        if "X_" + dataset_type + "_mean" in self.f:
            self.mean = self.f["X_" + dataset_type + "_mean"][...]
            self.std = self.f["X_" + dataset_type + "_std"][...]

    def load_all(self):
        """Materialize (frames, bins) X and Y: the frame stores of this
        task are hundreds of MB at most, so whole-array residency on the
        device is the trainer's fast path."""
        return self.X[...].T, self.Y[...].T

    def close(self):
        self.f.close()


def frame_batches(X, Y, batch_size, key=None, drop_remainder=True):
    """Yield (x, y) batches of rows from (frames, bins) arrays, shuffled when
    a numpy RandomState/Generator `key` is given. Host-side generator; the
    training loop copies each batch to the device."""
    n = X.shape[0]
    idx = np.arange(n)
    if key is not None:
        key.shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        sel = idx[i: i + batch_size]
        yield X[sel], (Y[sel] if Y is not None else None)


class H5StreamSource:
    """Double-buffered H5 frame streaming for training sets larger than
    device memory.

    The trainer's fast path keeps the whole frame store resident on the
    device; past device memory that breaks. This source cuts the store
    into `chunk_frames`-frame super-chunks and feeds them with
    one-chunk-lookahead prefetch on a reader thread, so the host H5 read
    of chunk i+1 overlaps the device's work on chunk i (trainer.fit
    streams when given this object as train_data). Shuffling is
    two-level — chunk order per epoch plus rows within each chunk — the
    standard streaming compromise (exact global shuffles need the
    in-memory path).
    """

    def __init__(self, path, dataset_type, chunk_frames=65536, seed=0):
        self.path = path
        self.dataset_type = dataset_type
        self.chunk_frames = int(chunk_frames)
        self.seed = seed
        self._reader = H5FrameReader(path, dataset_type)
        self.n_frames = self._reader.n_frames
        self.x_dim = self._reader.X.shape[0]
        self.y_dim = self._reader.Y.shape[0]
        self.mean = self._reader.mean
        self.std = self._reader.std
        if self.n_frames < self.chunk_frames:
            self.chunk_frames = self.n_frames
        # Cover the n_frames % chunk_frames tail with a final FULL-SIZE
        # chunk starting at n_frames - chunk_frames: every frame is seen
        # each epoch (the tail-overlap rows repeat — benign under the
        # two-level shuffle) and the device keeps one compiled chunk
        # shape. A ragged tail chunk would instead silently drop up to
        # chunk_frames-1 frames per epoch.
        self._starts = list(range(0, self.n_frames - self.chunk_frames + 1,
                                  self.chunk_frames))
        if self._starts[-1] + self.chunk_frames < self.n_frames:
            self._starts.append(self.n_frames - self.chunk_frames)
        self.n_chunks = len(self._starts)

    def _load_chunk(self, chunk_idx):
        lo = self._starts[chunk_idx]
        hi = lo + self.chunk_frames
        # contiguous column block, shipped unshuffled: within-chunk
        # shuffling happens on the device through the trainer's batch
        # index matrix, so the host pays no gather copy
        return self._reader.X[:, lo:hi].T, self._reader.Y[:, lo:hi].T

    def epoch_chunks(self, epoch):
        """Yield (X (chunk, x_dim), Y (chunk, y_dim)) with one-chunk
        lookahead prefetch."""
        from concurrent.futures import ThreadPoolExecutor

        rng = np.random.RandomState((self.seed, epoch))
        order = rng.permutation(self.n_chunks)
        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(self._load_chunk, order[0])
            for j in range(self.n_chunks):
                cur = nxt.result()
                if j + 1 < self.n_chunks:
                    nxt = pool.submit(self._load_chunk, order[j + 1])
                yield cur

    def close(self):
        self._reader.close()
