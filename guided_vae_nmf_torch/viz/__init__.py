from .figures import (
    Figure,
    display_multiple_signals,
    display_multiple_spectro,
    display_power_spectro,
    display_spectrogram,
    display_waveplot,
    display_wav_spectro_mask,
    grid,
    power_to_db,
)

__all__ = [
    "Figure", "display_multiple_signals", "display_multiple_spectro",
    "display_power_spectro", "display_spectrogram", "display_waveplot",
    "display_wav_spectro_mask", "grid", "power_to_db",
]
