"""K2: one-pass NMF M-step sums over the MH sample buffer.

Counterpart of `nmf_sums_pallas` in `guided_vae_nmf_tpu/mcem/pallas_engine.py`
(modes 'h' and 'g'), in two forms: with the NMF factors `WH=` (K2a) or with
a given noise variance `Vb=` (K2b, the fixed-noise models), each over
float32 samples in exact math or in fast mode (K2c): over the chain's
bfloat16 sample dumps and, with `approx_recip`, with every 1/Vx from the
hardware approximate reciprocal (within 1 ulp; the plain version divides
exactly). The kernel is `csrc/nmf_sums.cu`; :func:`nmf_sums_ref` is its
plain PyTorch version. :func:`nmf_sums` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors. `nmf_sums.launches`
counts kernel launches per variant: "h_wh", "g_wh", "h_vb", "g_vb" for
exact launches and the same names ending in "_fast" for launches over
bfloat16 samples or with `approx_recip`; a launch of the WH form at a rank
past `NARROW_RANK` runs the wide kernel and counts under "h_wh_wide",
"g_wh_wide" (and "_fast").

The kernel streams tiles of a few frames through shared memory, two bins
of every frame a thread, so it takes F up to `FMAX`, any N, R and storage
offset, and any NMF rank K >= 1 (:func:`check_widths`): up to
`NARROW_RANK` the narrow kernel, past it the wide one, which reads Wt
through L1 / L2 and contracts `NARROW_RANK` ranks at a time;
:func:`launch_geometry` reports the launch, frames a tile included.
"""

import ctypes

import torch

from .. import _build, _launches
from .engine import VX_FLOOR

_VP, _I = ctypes.c_void_p, ctypes.c_int
# The kernel's limits, checked against csrc/nmf_sums.cu's when it is
# loaded: F up to two bins a consumer thread of at most 992; the narrow
# kernel's largest NMF rank (the wide kernel takes the larger ones).
FMAX = 1984
NARROW_RANK = 16


def _lib():
    lib = _build.library("nmf_sums")
    if lib.gvnmf_nmf_sums.argtypes is None:
        lib.gvnmf_nmf_sums.argtypes = [_VP] * 8 + [_I] * 8 + [_VP]
        lib.gvnmf_nmf_sums.restype = _I
        lib.gvnmf_nmf_sums_geometry.argtypes = [_I] * 9 + [_VP]
        lib.gvnmf_nmf_sums_geometry.restype = _I
        for fn, want in ((lib.gvnmf_nmf_sums_narrow_rank, NARROW_RANK),
                         (lib.gvnmf_nmf_sums_fmax, FMAX)):
            fn.argtypes = []
            fn.restype = _I
            if fn() != want:
                raise _build.KernelError(
                    f"nmf_sums.cu's {fn.__name__} differs from the "
                    f"wrapper's {want}")
    return lib


def check_widths(F, K=None):
    """Raises ValueError for widths the kernel does not take: F bins from
    1 to FMAX, NMF rank K >= 1 (None: the Vb form, no K)."""
    if not 1 <= F <= FMAX:
        raise ValueError(f"F={F}: the sums kernel takes 1 <= F <= {FMAX} "
                         "(two bins a thread of at most 992)")
    if K is not None and K < 1:
        raise ValueError(f"NMF rank {K}: the kernel takes a rank of 1 or "
                         "more")


def launch_geometry(B, R, N, F, K, mode="h", vb=False, bf16=False,
                    approx_recip=False, device=None):
    """The launch `nmf_sums` makes at these shapes on the current card,
    without launching: CTAs, threads and dynamic shared memory a CTA,
    ring stages, frames a tile, reduction segments a frame, CTAs an SM,
    SMs and registers a thread; "wide": whether the wide kernel runs.
    CUDA only."""
    check_widths(F, None if vb else K)
    lib = _lib()
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        _build.check(lib.gvnmf_nmf_sums_geometry(
            B, R, N, F, K, 0 if mode == "h" else 1, int(vb), int(bf16),
            int(approx_recip), out), "nmf_sums geometry query")
    keys = ("ctas", "threads", "smem_bytes", "stages", "frames",
            "segments", "ctas_per_sm", "sms", "registers")
    return dict(zip(keys, out), wide=not vb and K > NARROW_RANK)


def _check_args(WH, X2, mode, Vb):
    if mode not in ("h", "g"):
        raise ValueError(f"mode must be 'h' or 'g', got {mode!r}")
    if (WH is None) == (Vb is None):
        raise ValueError("pass exactly one of Vb / WH")
    if X2 is None and (mode == "g" or WH is not None):
        raise ValueError(f"mode {mode!r} with "
                         f"{'Vb' if WH is None else 'WH'} needs X2")


def nmf_sums_ref(samples, WH, g, X2=None, mode="h", Vb=None,
                 approx_recip=False):
    """Plain PyTorch version (also the CPU path). samples (B, R, N, F)
    float32 or bfloat16 (read as float32), exactly one of WH = (Wt (B, K, F),
    H (B, K, N)) and Vb (B, N, F), g (B, N), X2 (B, N, F) (not needed in 'h'
    mode with Vb). `approx_recip` changes nothing here (exact 1/Vx).

    'h' with WH -> (numH, denH) (B, N, K): (X2 sum_r Vx^-2) W and
    (sum_r Vx^-1) W; 'h' with Vb -> (s1, s2) (B, N, F): sum_r Vx^-1 and
    sum_r Vx^-2; 'g' -> (num, den) (B, N): sum_f X2 sum_r Vs Vx^-2,
    sum_{r,f} Vs Vx^-1."""
    _check_args(WH, X2, mode, Vb)
    samples = samples.float()
    if WH is not None:
        Wt, H = WH
        Vb = torch.einsum("bkn,bkf->bnf", H, Wt)
    inv = 1.0 / torch.clamp_min(g[:, None, :, None] * samples + Vb[:, None],
                                VX_FLOOR)
    if mode == "h":
        s1 = torch.sum(inv, dim=1)
        s2 = torch.sum(inv * inv, dim=1)
        if WH is None:
            return s1, s2
        return (torch.einsum("bnf,bkf->bnk", X2 * s2, Wt),
                torch.einsum("bnf,bkf->bnk", s1, Wt))
    num = torch.sum(X2 * torch.sum(samples * inv * inv, dim=1), dim=-1)
    den = torch.sum(samples * inv, dim=(1, 3))
    return num, den


def nmf_sums(samples, WH, g, X2=None, mode="h", Vb=None, approx_recip=False):
    """M-step sums (see :func:`nmf_sums_ref`)."""
    _check_args(WH, X2, mode, Vb)
    if samples.device.type == "cpu":
        return nmf_sums_ref(samples, WH, g, X2, mode=mode, Vb=Vb,
                            approx_recip=approx_recip)
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    dev = samples.device
    B, R, N, F = samples.shape
    Wt, H = WH if WH is not None else (None, None)
    K = 0 if WH is None else Wt.shape[1]
    check_widths(F, None if WH is None else K)
    lib = _lib()
    need = [("samples", samples, (B, R, N, F)), ("g", g, (B, N))]
    if WH is None:
        need.append(("Vb", Vb, (B, N, F)))
    else:
        need += [("Wt", Wt, (B, K, F)), ("H", H, (B, K, N))]
    if X2 is not None:
        need.append(("X2", X2, (B, N, F)))
    bf16 = samples.dtype == torch.bfloat16
    for name, t, shape in need:
        dtype = torch.bfloat16 if name == "samples" and bf16 else \
            torch.float32
        if t.dtype != dtype or t.device != dev or not \
                t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if mode == "g":
        out_shape = (B, N)
    else:
        out_shape = (B, N, K) if WH is not None else (B, N, F)
    o1 = torch.empty(out_shape, device=dev)
    o2 = torch.empty(out_shape, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        status = lib.gvnmf_nmf_sums(
            ptr(samples), ptr(Vb), ptr(Wt), ptr(H), ptr(g), ptr(X2),
            ptr(o1), ptr(o2), B, R, N, F, K, 0 if mode == "h" else 1,
            int(bf16), int(bool(approx_recip)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "nmf_sums kernel")
    key = f"{mode}_{'vb' if WH is None else 'wh'}"
    if WH is not None and K > NARROW_RANK:
        key += "_wide"
    _launches.count(nmf_sums, "nmf_sums",
                    key + ("_fast" if bf16 or approx_recip else ""))
    return o1, o2


nmf_sums.launches = dict.fromkeys(
    (f"{mode}_{form}{level}" for level in ("", "_fast")
     for mode, form in (("h", "wh"), ("g", "wh"), ("h", "vb"), ("g", "vb"),
                        ("h", "wh_wide"), ("g", "wh_wide"))), 0)
