from .stft import (
    frame_count,
    istft,
    istft_masked,
    istft_masked_ri,
    istft_torch,
    pad_signal_for_stft,
    periodic_hann,
    stft,
    stft_batch_padded,
    stft_params,
    stft_torch,
)
from .targets import (
    clean_speech_IBM,
    clean_speech_IBM_torch,
    clean_speech_VAD,
    clean_speech_VAD_torch,
    ideal_wiener_mask,
    lorenz_threshold,
    noise_aware_IBM,
    noise_aware_IRM,
    noise_robust_clean_speech_IBM,
    noise_robust_clean_speech_VAD,
)

__all__ = [
    "clean_speech_IBM", "clean_speech_IBM_torch", "clean_speech_VAD",
    "clean_speech_VAD_torch", "frame_count", "ideal_wiener_mask", "istft",
    "istft_masked", "istft_masked_ri", "istft_torch", "lorenz_threshold",
    "noise_aware_IBM", "noise_aware_IRM", "noise_robust_clean_speech_IBM",
    "noise_robust_clean_speech_VAD", "pad_signal_for_stft", "periodic_hann",
    "stft", "stft_batch_padded", "stft_params", "stft_torch",
]
