"""The EM cost pass: each row's masked expected negative log-likelihood
over the MH sample dumps, once an EM iteration.

    c[b, n]  = sum_r sum_f (log Vx + X2 / Vx),
               Vx = max(g[b, n] Vs[b, r, n, f] + Vb[b, n, f], VX_FLOOR)
    cost[b]  = sum_n mask[b, n] c[b, n] / (R F sum_n mask[b, n])

with Vb = H^T Wt from the NMF factors (`WH=`) or a given (B, N, F) noise
variance (`Vb=`), over float32 or bfloat16 dumps. The JAX package computes
the same cost in one sum (`pallas_engine._masked_cost_batched`, plain
jnp); here the sum runs per frame first. The kernel is `csrc/em_cost.cu`;
:func:`em_cost_ref` is its plain PyTorch version. :func:`em_cost` launches
the kernel for CUDA tensors and runs the plain version for CPU tensors.
`em_cost.launches` counts kernel launches per variant: "wh", "vb", and
"wh_fast", "vb_fast" over bfloat16 dumps.
"""

import ctypes

import torch

from .. import _build, _launches
from .engine import VX_FLOOR

_VP, _I = ctypes.c_void_p, ctypes.c_int
# The kernel's largest F (two bins a thread of at most 1024), checked
# against csrc/em_cost.cu's when it is loaded.
FMAX = 2048


def _lib():
    lib = _build.library("em_cost")
    if lib.gvnmf_em_cost.argtypes is None:
        lib.gvnmf_em_cost.argtypes = [_VP] * 9 + [_I] * 6 + [_VP]
        lib.gvnmf_em_cost.restype = _I
        lib.gvnmf_em_cost_fmax.argtypes = []
        lib.gvnmf_em_cost_fmax.restype = _I
        if lib.gvnmf_em_cost_fmax() != FMAX:
            raise _build.KernelError(
                f"em_cost.cu's largest F differs from the wrapper's {FMAX}")
    return lib


def _check_args(samples, WH, g, X2, mask, Vb):
    """Raises ValueError unless exactly one of WH / Vb is given and every
    tensor has its shape."""
    if (WH is None) == (Vb is None):
        raise ValueError("pass exactly one of Vb / WH")
    if samples.dim() != 4:
        raise ValueError("samples: need (B, R, N, F), got "
                         f"{tuple(samples.shape)}")
    for name, t, shape in _needs(samples, WH, g, X2, mask, Vb):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: need {shape}, got {tuple(t.shape)}")


def _check_widths(F, K=None):
    """Raises ValueError for widths the kernel does not take: F bins from
    1 to FMAX, NMF rank K >= 1 (None: the Vb form, no K)."""
    if not 1 <= F <= FMAX:
        raise ValueError(f"F={F}: the cost kernel takes 1 <= F <= {FMAX}")
    if K is not None and K < 1:
        raise ValueError(f"NMF rank {K}: the kernel takes a rank of 1 or "
                         "more")


def _needs(samples, WH, g, X2, mask, Vb):
    B, R, N, F = samples.shape
    need = [("samples", samples, (B, R, N, F)), ("g", g, (B, N)),
            ("X2", X2, (B, N, F)), ("mask", mask, (B, N))]
    if WH is None:
        return need + [("Vb", Vb, (B, N, F))]
    K = WH[0].shape[1]
    return need + [("Wt", WH[0], (B, K, F)), ("H", WH[1], (B, K, N))]


def em_cost_ref(samples, WH, g, X2, mask, Vb=None):
    """Plain PyTorch version (also the CPU path). samples (B, R, N, F)
    float32 or bfloat16 (read as float32), exactly one of WH = (Wt (B, K,
    F), H (B, K, N)) and Vb (B, N, F), g and mask (B, N), X2 (B, N, F).
    Returns cost (B,)."""
    _check_args(samples, WH, g, X2, mask, Vb)
    if WH is not None:
        Wt, H = WH
        Vb = torch.einsum("bkn,bkf->bnf", H, Wt)
    Vx = torch.clamp_min(g[:, None, :, None] * samples.float()
                         + Vb[:, None], VX_FLOOR)
    c = torch.sum(torch.log(Vx) + X2[:, None] / Vx, dim=(1, 3))  # (B, N)
    count = samples.shape[1] * X2.shape[-1] * torch.sum(mask, dim=1)
    return torch.sum(mask * c, dim=1) / count


def em_cost(samples, WH, g, X2, mask, Vb=None):
    """The masked cost (see :func:`em_cost_ref`). On the card every
    tensor is float32 (the dumps float32 or bfloat16), contiguous and on
    the dumps' device, or this raises ValueError."""
    _check_args(samples, WH, g, X2, mask, Vb)
    if samples.device.type == "cpu":
        return em_cost_ref(samples, WH, g, X2, mask, Vb=Vb)
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    dev = samples.device
    B, R, N, F = samples.shape
    K = 0 if WH is None else WH[0].shape[1]
    _check_widths(F, None if WH is None else K)
    bf16 = samples.dtype == torch.bfloat16
    for name, t, _ in _needs(samples, WH, g, X2, mask, Vb):
        dtype = torch.bfloat16 if name == "samples" and bf16 else \
            torch.float32
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} on {dev}, got "
                f"{t.dtype} on {t.device}"
                + ("" if t.is_contiguous() else ", not contiguous"))
    Wt, H = WH if WH is not None else (None, None)
    c = torch.empty((B, N), device=dev)
    cost = torch.empty((B,), device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        status = _lib().gvnmf_em_cost(
            ptr(samples), ptr(Vb), ptr(Wt), ptr(H), ptr(g), ptr(X2),
            ptr(mask), ptr(c), ptr(cost), B, R, N, F, K, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "em_cost kernel")
    _launches.count(em_cost, "em_cost", ("wh" if WH is not None else "vb")
                    + ("_fast" if bf16 else ""))
    return cost


em_cost.launches = dict.fromkeys(("wh", "vb", "wh_fast", "vb_fast"), 0)
