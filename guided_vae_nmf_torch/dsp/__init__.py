from .stft import (
    frame_count,
    istft_masked,
    istft_masked_ri,
    pad_signal_for_stft,
    periodic_hann,
    stft_batch_padded,
    stft_params,
)

__all__ = [
    "frame_count", "istft_masked", "istft_masked_ri", "pad_signal_for_stft",
    "periodic_hann", "stft_batch_padded", "stft_params",
]
