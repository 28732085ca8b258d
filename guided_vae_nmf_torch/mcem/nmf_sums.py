"""K2: one-pass NMF M-step sums over the MH sample buffer.

Counterpart of `nmf_sums_pallas` in `guided_vae_nmf_tpu/mcem/pallas_engine.py`
(modes 'h' and 'g' with the NMF factors `WH=`). The kernel is
`csrc/nmf_sums.cu`; :func:`nmf_sums_ref` is its plain PyTorch version.
:func:`nmf_sums` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

import ctypes

import torch

from .. import _build
from .engine import VX_FLOOR

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.library("nmf_sums")
    if lib.gvnmf_nmf_sums.argtypes is None:
        lib.gvnmf_nmf_sums.argtypes = [_VP] * 7 + [_I] * 6 + [_VP]
        lib.gvnmf_nmf_sums.restype = _I
        lib.gvnmf_nmf_sums_kmax.argtypes = []
        lib.gvnmf_nmf_sums_kmax.restype = _I
    return lib


def nmf_sums_ref(samples, WH, g, X2, mode="h"):
    """Plain PyTorch version (also the CPU path). samples (B, R, N, F),
    WH = (Wt (B, K, F), H (B, K, N)), g (B, N), X2 (B, N, F).

    'h' -> (numH, denH) (B, N, K): (X2 sum_r Vx^-2) W and (sum_r Vx^-1) W;
    'g' -> (num, den) (B, N): sum_f X2 sum_r Vs Vx^-2, sum_{r,f} Vs Vx^-1."""
    Wt, H = WH
    Vb = torch.einsum("bkn,bkf->bnf", H, Wt)
    inv = 1.0 / torch.clamp_min(g[:, None, :, None] * samples + Vb[:, None],
                                VX_FLOOR)
    if mode == "h":
        s1 = torch.sum(inv, dim=1)
        s2 = torch.sum(inv * inv, dim=1)
        return (torch.einsum("bnf,bkf->bnk", X2 * s2, Wt),
                torch.einsum("bnf,bkf->bnk", s1, Wt))
    num = torch.sum(X2 * torch.sum(samples * inv * inv, dim=1), dim=-1)
    den = torch.sum(samples * inv, dim=(1, 3))
    return num, den


def nmf_sums(samples, WH, g, X2, mode="h"):
    """M-step sums (see :func:`nmf_sums_ref`)."""
    if mode not in ("h", "g"):
        raise ValueError(f"mode must be 'h' or 'g', got {mode!r}")
    if samples.device.type == "cpu":
        return nmf_sums_ref(samples, WH, g, X2, mode=mode)
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    dev = samples.device
    lib = _lib()
    Wt, H = WH
    B, R, N, F = samples.shape
    K = Wt.shape[1]
    if K > lib.gvnmf_nmf_sums_kmax():
        raise ValueError(f"NMF rank {K} exceeds the kernel's "
                         f"{lib.gvnmf_nmf_sums_kmax()}")
    for name, t, shape in (("samples", samples, (B, R, N, F)),
                           ("Wt", Wt, (B, K, F)), ("H", H, (B, K, N)),
                           ("g", g, (B, N)), ("X2", X2, (B, N, F))):
        if t.dtype != torch.float32 or t.device != dev or not \
                t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: need contiguous float32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out_shape = (B, N, K) if mode == "h" else (B, N)
    o1 = torch.empty(out_shape, device=dev)
    o2 = torch.empty(out_shape, device=dev)
    with torch.cuda.device(dev):
        status = lib.gvnmf_nmf_sums(
            samples.data_ptr(), Wt.data_ptr(), H.data_ptr(), g.data_ptr(),
            X2.data_ptr(), o1.data_ptr(), o2.data_ptr(), B, R, N, F, K,
            0 if mode == "h" else 1,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "nmf_sums kernel")
    nmf_sums.launches += 1
    return o1, o2


nmf_sums.launches = 0
