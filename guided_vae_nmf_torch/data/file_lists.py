"""Speech corpus file lists and pickle dataset round-trip.

Capability parity with reference python/dataset/csr1_wjs0_dataset.py:19-129:
globs WSJ0 wavs per split and round-trips concatenated frame arrays through
pickle with the reference's path conventions, so the bundled golden pickles
under data/subset/pickle remain loadable and regenerable.

The port's own copy of `guided_vae_nmf_tpu/data/file_lists.py`.
"""

import os
import pickle
from glob import glob

SPLIT_DIRS = {
    "train": "si_tr_s",
    "validation": "si_dt_05",
    "test": "si_et_05",
}


def speech_list(input_speech_dir, dataset_type="train"):
    """Sorted relative paths of WSJ0 wavs for a split (reference
    csr1_wjs0_dataset.py:19-54). Paths are relative to `input_speech_dir`."""
    if dataset_type not in SPLIT_DIRS:
        raise ValueError(f"unknown dataset_type: {dataset_type}")
    subdir = SPLIT_DIRS[dataset_type]
    pattern = os.path.join(
        input_speech_dir, "CSR-1-WSJ-0", "WAV", "wsj0", subdir, "**", "*.wav"
    )
    paths = glob(pattern, recursive=True)
    prefix = os.path.join(input_speech_dir, "")
    rel = [p[len(prefix):] if p.startswith(prefix) else p for p in paths]
    return sorted(rel)


def _pickle_path(data_dir, dataset_type, suffix):
    subdir = SPLIT_DIRS[dataset_type]
    return os.path.join(data_dir, "CSR-1-WSJ-0", f"{subdir}_{suffix}.p")


def write_dataset(data, output_data_dir, dataset_type, suffix):
    """Pickle (protocol 4) an array under the reference's naming scheme
    (csr1_wjs0_dataset.py:59-97)."""
    path = _pickle_path(output_data_dir, dataset_type, suffix)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


def read_dataset(data_dir, dataset_type, suffix):
    """Load a pickled dataset array (csr1_wjs0_dataset.py:98-129)."""
    with open(_pickle_path(data_dir, dataset_type, suffix), "rb") as f:
        return pickle.load(f)
