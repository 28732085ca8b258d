"""Frame-dataset shims.

Capability parity with reference python/data.py:9-82: the padding collate
for variable-length spectrograms and indexable frame datasets over
in-memory or HDF5-backed (bins, frames) arrays. The trainer consumes
whole (frames, bins) arrays or `h5io.H5StreamSource` chunks; these shims
keep the reference's item-wise access patterns available for tooling and
tests. The port's own copy of `guided_vae_nmf_tpu/data/datasets.py`.
"""

import numpy as np

from .h5io import H5FrameReader


def collate_fn(batch):
    """Pad a list of (bins, frames_i) spectrograms to the max frame count
    with each array's minimum value (reference data.py:9-14) and stack to
    (B, bins, max_frames)."""
    max_len = max(s.shape[1] for s in batch)
    out = [
        np.pad(s, ((0, 0), (0, max_len - s.shape[1])), mode="minimum")
        for s in batch
    ]
    return np.stack(out)


class SpectrogramFrames:
    """Frame-wise view of a (bins, total_frames) array: item i is the
    513-dim column i (reference data.py:28-37)."""

    def __init__(self, data):
        self.data = data

    def __getitem__(self, i):
        return self.data[:, i]

    def __len__(self):
        return self.data.shape[1]


class SpectrogramLabeledFrames(SpectrogramFrames):
    """Frame + label column pairs (reference data.py:40-50)."""

    def __init__(self, data, labels):
        super().__init__(data)
        self.labels = labels

    def __getitem__(self, i):
        return self.data[:, i], self.labels[:, i]


class HDF5SpectrogramLabeledFrames:
    """Lazy h5-backed labeled frame dataset (reference data.py:53-82); the
    file is opened on first access so instances pickle cleanly into worker
    processes."""

    def __init__(self, output_h5_dir, dataset_type,
                 rdcc_nbytes=1024**2 * 400, rdcc_nslots=int(1e5)):
        self.output_h5_dir = output_h5_dir
        self.dataset_type = dataset_type
        self.rdcc_nbytes = rdcc_nbytes
        self.rdcc_nslots = rdcc_nslots
        r = H5FrameReader(output_h5_dir, dataset_type)
        self.dataset_len = r.n_frames
        r.close()
        self._reader = None

    def _open(self):
        if self._reader is None:
            self._reader = H5FrameReader(
                self.output_h5_dir, self.dataset_type,
                rdcc_nbytes=self.rdcc_nbytes, rdcc_nslots=self.rdcc_nslots,
            )
        return self._reader

    def __getitem__(self, i):
        r = self._open()
        return r.X[:, i], r.Y[:, i]

    def __len__(self):
        return self.dataset_len

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_reader"] = None
        return state

    def __del__(self):
        if self._reader is not None:
            self._reader.close()
