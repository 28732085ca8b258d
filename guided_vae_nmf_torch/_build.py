"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. The build happens at first
use, all sources in parallel, into a git-ignored directory
(`build/gvnmf_torch/` beside the package, or `$GVNMF_TORCH_BUILD_DIR`). A
library's file name carries the hash of its source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt and
a current one is reused. ptxas reports each kernel's
registers, shared memory and spills (`-Xptxas -v`); the report is kept
beside the library (:func:`build_log`).

Nothing here runs at import: the CPU tests import every module on a
machine without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


class KernelError(RuntimeError):
    """A kernel could not be built (nvcc missing or failing) or a launch
    returned a CUDA error. Callers that retry or degrade on other runtime
    errors let this one through: a card whose kernels do not work must not
    produce output."""


def build_dir():
    env = os.environ.get("GVNMF_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "gvnmf_torch"


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels need the CUDA "
                          "toolkit (set CUDA_HOME)")
    return found


def _lib_path(src):
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all():
    """Compile every stale `csrc/*.cu` (one nvcc per source, all started
    together) and load every library. Returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = _lib_path(src)
            if src.stem not in _libs and not out.exists():
                todo[src] = out
        if todo:
            build_dir().mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src, out in todo.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failed = []
            for src, out, tmp, proc in procs:
                log = proc.communicate()[0].decode(errors="replace")
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                else:
                    out.with_suffix(".log").write_text(log)
                    os.replace(tmp, out)
            if failed:
                raise KernelError("nvcc failed for " + "\n".join(failed))
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
    return time.perf_counter() - t0


def build_log(name):
    """nvcc's output (the ptxas resource report) from building
    `csrc/<name>.cu`, or '' if the library was not built here."""
    path = _lib_path(CSRC / f"{name}.cu").with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name):
    """The loaded library built from `csrc/<name>.cu`."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(status, what):
    """Raise KernelError on a nonzero cudaError_t returned by a C entry
    point."""
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status}")
