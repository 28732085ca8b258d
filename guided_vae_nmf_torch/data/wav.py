"""Wav file IO without libsndfile (numpy/scipy only).

The port's own copy of `guided_vae_nmf_tpu/data/wav.py`: 16-bit PCM wav and
NIST SPHERE reads, soundfile-compatible float scaling (reads return float64
in [-1, 1) scaled by 1/32768; writes clip and scale symmetrically).
"""

import numpy as np
from scipy.io import wavfile


def _read_nist_sphere(path):
    """Read a NIST SPHERE file (WSJ0's native container): 'NIST_1A' magic, an
    ASCII key/value header of declared size, then raw PCM."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"not a NIST SPHERE file: {path}")
        header_size = int(f.read(8).strip())
        header = f.read(header_size - 16).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines():
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                key, type_flag, value = parts
                fields[key] = int(value) if type_flag.startswith("-i") else value
        f.seek(header_size)
        n = fields["sample_count"] * fields.get("channel_count", 1)
        n_bytes = fields.get("sample_n_bytes", 2)
        if n_bytes != 2:
            raise ValueError(f"unsupported SPHERE sample width: {n_bytes}")
        byte_format = fields.get("sample_byte_format", "01")
        dtype = "<i2" if byte_format == "01" else ">i2"
        data = np.frombuffer(f.read(n * 2), dtype=dtype).astype(np.int16)
    if fields.get("channel_count", 1) > 1:
        data = data.reshape(-1, fields["channel_count"])
    return int(fields["sample_rate"]), data


def read_wav(path):
    """Read a wav file -> (float64 samples in [-1,1), sample_rate).

    Handles RIFF wav and NIST SPHERE containers; PCM16/PCM32/uint8 are
    scaled as soundfile.read does, float wavs pass through. `path` may be a
    seekable binary file object (RIFF only)."""
    if hasattr(path, "read"):
        fs, data = wavfile.read(path)
    else:
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic.startswith(b"NIST_1A"):
            fs, data = _read_nist_sphere(path)
        else:
            fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float64) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float64) - 128.0) / 128.0
    else:  # float32 / float64 wavs
        x = data.astype(np.float64)
    return x, int(fs)


def read_wav_int16(path):
    """Read a PCM16 wav/SPHERE file as raw int16 samples -> (int16 array,
    sample_rate). The device applies the same 1/32768 scaling as
    :func:`read_wav`; non-PCM16 sources are quantized."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"NIST_1A"):
        fs, data = _read_nist_sphere(path)
    else:
        fs, data = wavfile.read(path)
    if data.dtype != np.int16:
        x, fs = read_wav(path)
        data = np.clip(np.round(np.asarray(x) * 32768.0),
                       -32768, 32767).astype(np.int16)
    return data, int(fs)


def wav_num_samples(path):
    """Per-channel sample count from the container header only (no PCM
    read), for bucketing a sweep by length before any decode."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic.startswith(b"NIST_1A"):
            header_size = int(f.read(8).strip())
            header = f.read(header_size - 16).decode(
                "ascii", errors="replace")
            for line in header.splitlines():
                parts = line.split(None, 2)
                if len(parts) == 3 and parts[0] == "sample_count":
                    return int(parts[2])
            raise ValueError(f"no sample_count in SPHERE header: {path}")
        if magic[:4] != b"RIFF":
            raise ValueError(f"not a RIFF/SPHERE file: {path}")
        f.seek(12)  # past RIFF size + WAVE tag
        channels, bits = 1, 16
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"no data chunk found: {path}")
            tag = head[:4]
            size = int.from_bytes(head[4:8], "little")
            if tag == b"fmt ":
                fmt = f.read(size)
                channels = int.from_bytes(fmt[2:4], "little")
                bits = int.from_bytes(fmt[14:16], "little")
            elif tag == b"data":
                return size // (max(channels, 1) * max(bits // 8, 1))
            else:
                f.seek(size + (size & 1), 1)


def write_wav(path, x, fs):
    """Write float samples in [-1, 1] as 16-bit PCM; int16 input is written
    as-is (already quantized by the pipeline)."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        wavfile.write(path, int(fs), x)
        return
    scaled = np.clip(np.round(x.astype(np.float64) * 32768.0),
                     -32768, 32767).astype(np.int16)
    wavfile.write(path, int(fs), scaled)
