from .datasets import (
    HDF5SpectrogramLabeledFrames,
    SpectrogramFrames,
    SpectrogramLabeledFrames,
    collate_fn,
)
from .file_lists import SPLIT_DIRS, read_dataset, speech_list, write_dataset
from .h5io import H5FrameReader, H5FrameWriter, H5StreamSource, frame_batches
from .noise import (
    demand_noise_list,
    mix_at_snr,
    noise_list_preprocessed,
    noise_segment,
    preprocess_noise,
    qut_noise_list,
    snr_gain,
    synthetic_noise_bank,
    write_preprocessed_noise,
)
from .synthesis import (
    VOICE_VARIANTS,
    augment_clean,
    create_clean_frames,
    create_noisy_frames,
    create_test_mixtures,
    pitch_shift,
    pv_stretch,
    speed_perturb,
    voice_variants,
)
from .wav import read_wav, read_wav_int16, wav_num_samples, write_wav

__all__ = [
    "H5FrameReader", "H5FrameWriter", "H5StreamSource",
    "HDF5SpectrogramLabeledFrames", "SPLIT_DIRS", "SpectrogramFrames",
    "SpectrogramLabeledFrames", "VOICE_VARIANTS", "augment_clean",
    "collate_fn", "create_clean_frames", "create_noisy_frames",
    "create_test_mixtures", "demand_noise_list", "frame_batches",
    "mix_at_snr", "noise_list_preprocessed", "noise_segment", "pitch_shift",
    "preprocess_noise", "pv_stretch", "qut_noise_list", "read_dataset",
    "read_wav", "read_wav_int16", "snr_gain", "speech_list",
    "speed_perturb", "synthetic_noise_bank", "voice_variants",
    "wav_num_samples", "write_dataset", "write_preprocessed_noise",
    "write_wav",
]
