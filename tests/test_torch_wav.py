"""Wav IO: the port's copy of `data/wav.py` against the original, on RIFF
and NIST SPHERE files. Both are numpy/scipy, so they must agree exactly."""

import numpy as np
import pytest

from guided_vae_nmf_tpu.data import wav as jwav
from guided_vae_nmf_torch.data import wav as twav


def _sphere(path, pcm, fs=16000):
    """A little-endian PCM16 NIST SPHERE file with a 1024-byte header."""
    fields = (f"sample_rate -i {fs}\nsample_count -i {len(pcm)}\n"
              "channel_count -i 1\nsample_n_bytes -i 2\n"
              "sample_byte_format -s2 01\nend_head\n")
    head = b"NIST_1A\n   1024\n" + fields.encode("ascii")
    path.write_bytes(head.ljust(1024, b" ") + pcm.astype("<i2").tobytes())


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_write_wav_matches_the_original(tmp_path, kind):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.2, 1.2, 4001)      # out-of-range samples clip
    if kind == "int16":
        x = rng.randint(-32768, 32768, 4001).astype(np.int16)
    twav.write_wav(str(tmp_path / "t.wav"), x, 16000)
    jwav.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("container", ["riff", "sphere"])
def test_reads_match_the_original(tmp_path, container):
    pcm = np.random.RandomState(1).randint(-32768, 32768, 5003).astype(
        np.int16)
    path = tmp_path / "u.wav"
    if container == "riff":
        jwav.write_wav(str(path), pcm, 16000)
    else:
        _sphere(path, pcm)
    a, fa = twav.read_wav_int16(str(path))
    b, fb = jwav.read_wav_int16(str(path))
    assert fa == fb == 16000 and np.array_equal(a, b) and np.array_equal(
        a, pcm)
    xa, _ = twav.read_wav(str(path))
    xb, _ = jwav.read_wav(str(path))
    assert np.array_equal(xa, xb)
    assert twav.wav_num_samples(str(path)) == jwav.wav_num_samples(
        str(path)) == len(pcm)
