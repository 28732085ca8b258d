from .wav import read_wav, read_wav_int16, wav_num_samples, write_wav

__all__ = ["read_wav", "read_wav_int16", "wav_num_samples", "write_wav"]
