"""ctypes bindings for the native (C++) host data loader.

Counterpart of `guided_vae_nmf_tpu/data/native_loader.py`, over the port's
own copy of the source, `csrc/gvnmf_native.cpp`. :func:`build` compiles it
with `g++ -O3 -fPIC -shared -std=c++17` into the port's build directory
(`_build.build_dir()`), under a file name that carries the hash of the
source and the flags, as the CUDA kernels are built; it never writes
anywhere else. The library decodes wav / NIST-SPHERE files, assembles the
sweep's int16 batch rows (bit-equal to the Python path) and computes STFT
power and complex spectrograms (equal to `dsp.stft` within float32
rounding). The C calls release the GIL, so a thread pool decodes and
assembles in parallel.

This is host I/O, not a device path: where no compiler is found or the
build fails, :func:`is_available` is false and the callers
(`pipeline.load_mixture`, the sweeps' row assembly) take the pure-Python
path. Each native call adds one to its count (:func:`call_counts`), which
shows which path a run took.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

import numpy as np

from .. import _build

SOURCE = _build.CSRC / "gvnmf_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()          # the build and load
_count_lock = threading.Lock()
_lib = None
_error = None           # why the library is unavailable, once known
_counts = Counter()


class NativeBuildError(RuntimeError):
    """g++ is missing, failed, or its library does not load."""


def lib_path():
    """The library's path in the build directory, named by the hash of the
    source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _build.build_dir() / f"libgvnmf_native-{h.hexdigest()[:16]}.so"


def _declare(lib):
    c_long, c_int, c_double = ctypes.c_long, ctypes.c_int, ctypes.c_double
    p_double = ctypes.POINTER(c_double)
    p_float = ctypes.POINTER(ctypes.c_float)
    lib.gvnmf_decode.restype = c_long
    lib.gvnmf_decode.argtypes = [ctypes.c_char_p, p_double, c_long,
                                 ctypes.POINTER(c_int)]
    lib.gvnmf_frame_count.restype = c_long
    lib.gvnmf_frame_count.argtypes = [c_long, c_int, c_double, c_double]
    lib.gvnmf_bins.restype = c_int
    lib.gvnmf_bins.argtypes = [c_int, c_double]
    for name in ("gvnmf_stft_power", "gvnmf_stft_complex"):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [p_double, c_long, c_int, c_double, c_double, p_float]
    lib.gvnmf_load_power.restype = c_long
    lib.gvnmf_load_power.argtypes = [ctypes.c_char_p, c_double, c_int,
                                     c_double, c_double, p_float, c_long]
    lib.gvnmf_assemble_utt.restype = c_int
    lib.gvnmf_assemble_utt.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16), c_long, c_int,
        c_int, c_int, ctypes.POINTER(c_long), ctypes.POINTER(c_long)]
    return lib


def build():
    """Compile the library if its file is missing and load it; returns the
    seconds spent. Raises NativeBuildError when g++ is missing or fails or
    the library does not load."""
    global _lib, _error
    t0 = time.perf_counter()
    with _lock:
        if _lib is not None:
            return 0.0
        out = lib_path()
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise NativeBuildError("g++ not found")
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(f"g++: {e}") from e
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ failed:\n{proc.stderr[-2000:]}")
            os.replace(tmp, out)
        try:
            _lib = _declare(ctypes.CDLL(str(out)))
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"{out}: {e}") from e
        _error = None
    return time.perf_counter() - t0


def _load():
    """The loaded library, building it on first use; None (and the reason
    in :func:`unavailable_reason`) when it cannot be built."""
    global _error
    if _lib is None and _error is None:
        try:
            build()
        except NativeBuildError as e:
            _error = str(e)
    return _lib


def is_available():
    return _load() is not None


has_assemble = is_available     # the port's copy always has the assembler


def unavailable_reason():
    """Why the library is not available ('' when it is)."""
    _load()
    return _error or ""


def _count(name):
    with _count_lock:
        _counts[name] += 1


def call_counts():
    """Native calls per entry point since the last reset."""
    with _count_lock:
        return dict(_counts)


def reset_call_counts():
    with _count_lock:
        _counts.clear()


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def read_wav_native(path):
    """Native decode -> (float64 samples, fs); raises IOError on failure."""
    lib = _lib_or_raise()
    _count("decode")
    fs = ctypes.c_int(0)
    n = lib.gvnmf_decode(path.encode(), None, 0, ctypes.byref(fs))
    if n < 0:
        raise IOError(f"native decode failed: {path}")
    out = np.empty(n, np.float64)
    lib.gvnmf_decode(path.encode(),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     n, ctypes.byref(fs))
    return out, int(fs.value)


def _stft_native(fn, x, fs, wlen_sec, hop_percent, per_bin):
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float64)
    frames = lib.gvnmf_frame_count(len(x), fs, wlen_sec, hop_percent)
    bins = lib.gvnmf_bins(fs, wlen_sec)
    out = np.empty((frames, bins, per_bin), np.float32)
    rc = getattr(lib, fn)(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x), fs,
        wlen_sec, hop_percent,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"native {fn} failed")
    return out


def stft_power_native(x, fs=16000, wlen_sec=64e-3, hop_percent=0.25):
    """Native STFT power spectrogram -> (bins, frames) float32 (the
    reference orientation)."""
    _count("stft_power")
    return _stft_native("gvnmf_stft_power", x, fs, wlen_sec, hop_percent,
                        1)[..., 0].T


def stft_complex_native(x, fs=16000, wlen_sec=64e-3, hop_percent=0.25):
    """Native complex STFT -> (bins, frames) complex64 (the reference
    orientation)."""
    _count("stft_complex")
    out = _stft_native("gvnmf_stft_complex", x, fs, wlen_sec, hop_percent,
                       2)
    return out.view(np.complex64)[..., 0].T


def load_power_native(path, cut_sec=0.1, fs=16000, wlen_sec=64e-3,
                      hop_percent=0.25, max_frames=8192):
    """Fused native decode + burst cut + peak-normalize + STFT power ->
    (bins, frames) float32. One C call, GIL released."""
    lib = _lib_or_raise()
    _count("load_power")
    bins = lib.gvnmf_bins(fs, wlen_sec)
    buf = np.empty((max_frames, bins), np.float32)
    frames = lib.gvnmf_load_power(
        path.encode(), cut_sec, fs, wlen_sec, hop_percent,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size)
    if frames < 0:
        raise IOError(f"native load failed ({frames}): {path}")
    return np.ascontiguousarray(buf[:frames]).T


def assemble_utt_native(path, row, fs=16000, nfft=1024, hop=256):
    """Decode + end-pad + reflect-pad + PCM16-quantize one utterance into
    the pre-zeroed int16 `row` (a view into a sweep's (B, L) batch), in
    C++ with the GIL released. Returns (n_frames, t_orig). Raises
    ValueError for another sample rate than `fs`, IOError for a file that
    does not decode."""
    if row.dtype != np.int16 or not row.flags.c_contiguous or row.ndim != 1:
        raise ValueError("row must be a contiguous 1-d int16 view into the "
                         "batch")
    lib = _lib_or_raise()
    _count("assemble_utt")
    n_frames, t_orig = ctypes.c_long(), ctypes.c_long()
    rc = lib.gvnmf_assemble_utt(
        path.encode(), row.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        row.shape[0], fs, nfft, hop, ctypes.byref(n_frames),
        ctypes.byref(t_orig))
    if rc == -2:
        raise ValueError(f"{path}: sample rate is not {fs}")
    if rc != 0:
        raise IOError(f"native assemble failed ({rc}) for {path}")
    return int(n_frames.value), int(t_orig.value)
