from .file_lists import SPLIT_DIRS, read_dataset, speech_list, write_dataset
from .wav import read_wav, read_wav_int16, wav_num_samples, write_wav

__all__ = ["SPLIT_DIRS", "read_dataset", "read_wav", "read_wav_int16",
           "speech_list", "wav_num_samples", "write_dataset", "write_wav"]
