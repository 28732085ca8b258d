"""Deployment diagnostics: one command that answers "why doesn't it run?"

Checks, without hanging on a wedged driver:
  - torch's version and its CUDA build,
  - the GPU, by a probe in a subprocess bounded by --probe_s (device
    count and name), with nvidia-smi's name and power limit,
  - nvcc, and the CUDA kernels: each `csrc/*.cu` is built (or found
    built) in the build directory and its library loads,
  - the native host loader (`csrc/gvnmf_native.cpp`, built with g++ into
    the same directory; optional) and a decode self-test,
  - the pretrained artifacts and the data root,
  - that the serving and streaming modules import.

Exit code 0 when every required check passes. The port runs on the GPU
and has no CPU fallback, so the card and the kernel builds are required.

Usage: python -m guided_vae_nmf_torch.scripts.doctor [--probe_s 30]
       [--models artifacts/pretrained] [--data_root data]
       [--dataset_size subset]
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

from ..config import PathsConfig, apply_overrides
from ._common import flag

GREEN, RED, DIM, END = "\033[32m", "\033[31m", "\033[2m", "\033[0m"


def _mark(ok):
    return f"{GREEN}ok{END}" if ok else f"{RED}FAIL{END}"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    probe_s = flag(rest, "probe_s", 30.0, float)
    art = flag(rest, "models", "artifacts/pretrained")
    required_ok = True

    def check(name, ok, detail="", required=True):
        nonlocal required_ok
        tag = _mark(ok) if required else (
            f"{GREEN}ok{END}" if ok else f"{DIM}unavailable{END}")
        print(f"  [{tag}] {name}" + (f" - {detail}" if detail else ""))
        if required and not ok:
            required_ok = False

    print("gvnmf-torch doctor")

    # --- torch + the card ---------------------------------------------------
    import torch

    from .. import _build
    from ..cli import cuda_probe, nvidia_smi

    check("torch", torch.version.cuda is not None,
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    n_dev = 0
    try:
        n_dev, name = cuda_probe(probe_s)
        check("GPU", n_dev > 0, f"{n_dev} device(s)"
              + (f", {name}" if n_dev else ""))
    except subprocess.TimeoutExpired:
        check("GPU", False, f"probe unresponsive after {probe_s:.0f}s")
    except RuntimeError as e:
        check("GPU", False, str(e))
    smi = nvidia_smi(probe_s)
    check("nvidia-smi (name, power limit)", smi is not None,
          smi or "unavailable", required=False)

    # --- nvcc + the kernels ---------------------------------------------------
    try:
        check("nvcc", True, _build._nvcc())
        try:
            secs = _build.build_all()
            check("CUDA kernels", True, f"built and loaded in "
                  f"{_build.build_dir()} ({secs:.1f} s)")
        except (_build.KernelError, OSError) as e:
            check("CUDA kernels", False, str(e)[-300:])
    except _build.KernelError as e:
        check("nvcc", False, str(e))
        check("CUDA kernels", False, "need nvcc")

    # --- the native host loader (optional: the Python path stays) -------------
    from ..data import native_loader as nl
    from ..data import write_wav

    try:
        secs = nl.build()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "t.wav")
            write_wav(path, np.linspace(-0.5, 0.5, 333).astype(np.float32),
                      16000)
            y, fs = nl.read_wav_native(path)
        check("native C++ loader", fs == 16000 and len(y) == 333,
              f"g++ build in {nl.lib_path().parent} ({secs:.1f} s), decode "
              "self-test", required=False)
    except (nl.NativeBuildError, OSError) as e:
        check("native C++ loader", False, str(e)[-300:], required=False)

    # --- artifacts + data -------------------------------------------------------
    names = ("M1", "M2_ibm", "M2_vad", "classifier_ibm", "classifier_vad",
             "wiener")
    have = [m for m in names if os.path.isdir(os.path.join(art, m))]
    check("pretrained artifacts", len(have) == len(names),
          f"{len(have)}/{len(names)} model dirs under {art}",
          required=False)
    check("data root", os.path.isdir(paths.processed_wav_dir),
          paths.processed_wav_dir, required=False)

    # --- serving modules ----------------------------------------------------------
    try:
        from .. import http_serving, serving, streaming  # noqa: F401

        check("serving modules import", True)
    except ImportError as e:
        check("serving modules import", False, str(e))

    print("doctor:", "healthy" if required_ok else "REQUIRED CHECKS FAILED")
    return 0 if required_ok else 1


if __name__ == "__main__":
    sys.exit(main())
