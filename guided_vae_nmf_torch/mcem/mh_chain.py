"""K1: the fused Metropolis-Hastings chain over the VAE latent.

Counterpart of `mh_chain_pallas` in `guided_vae_nmf_tpu/mcem/pallas_engine.py`
(E-mode and WF-mode), in two forms: with the NMF factors `WH=` (K1a) or
with a given noise variance `Vb=` (K1b, the fixed-noise models), each in
exact math with float32 sample dumps or with the fast-mode options (K1c):
`samples_dtype=torch.bfloat16` dumps (E-mode), `approx_recip` and
`approx_trans`, and with the decoder's products in bfloat16 (K1d,
`matmul_dtype=torch.bfloat16`). The kernel is `csrc/mh_chain.cu`;
:func:`mh_chain_ref` is its plain PyTorch version, step by step the same
function.

Under `matmul_dtype=torch.bfloat16` both operands of each of the decoder's
three products are rounded to bfloat16 (round to nearest even) and the
products summed in float32, as the TPU kernel's `mm` does; `ypre`, the
biases and all chain state stay float32. A product of two bfloat16 values
is exact in float32, so the two versions differ only in the order of the
sums, and where that moves a hidden output across a bfloat16 rounding
boundary, by one bfloat16 ulp of that operand.

Under `approx_trans` both evaluate the decoder's output exp, the data
term's log and the accept test's log u with :func:`fast_exp` /
:func:`fast_log` (the TPU kernel's `_fast_exp` / `_fast_log`), op for op,
so they agree bit for bit. `approx_recip` makes the kernel form every 1/Vx
with the hardware approximate reciprocal (within 1 ulp); the plain version
has no such reciprocal and divides exactly, so there the two differ by at
most 1 ulp per reciprocal.

:func:`mh_chain` launches a kernel for CUDA tensors and runs the plain
version for CPU tensors. :func:`plan_chain` makes every decision about the
kernel: which form runs, its CTAs a cluster, its weight block and whether
it skips padding; the launch runs what the plan says. The kernel has three
forms. The cluster form (`csrc/mh_chain.cu`, K1a-K1d) runs on thread-block
clusters of `CLUSTER` CTAs, each holding a column slice of the decoder's
weights in shared memory; it takes decoders of one hidden width whose
slices fit; :func:`pack_weights` lays the slices out, and
:func:`launch_geometry` reports the launch; given the live flags of
:func:`live_pairs` it skips every tile pair that holds no valid frame.
The extended cluster form (K1e, `csrc/mh_chain_ext.cu`) runs the same
design on clusters of 4 or 8 CTAs (the smallest that holds a rank's
slices) with every hidden layer sliced on its own, so it takes decoders
of unequal widths and wider ones (:func:`ext_cluster`,
:func:`ext_geometry`; its blocks are `pack_weights(dec_w, cluster)`).
The general form (K1g,
`csrc/mh_chain_general.cu`) takes every other decoder of 1 to 4 hidden
layers, of any widths up to its shared-memory limit (:func:`general_tile`),
at any F and NMF rank: one CTA a tile of 16, 8 or 4 frames, the weights
streamed through shared memory by bulk copies from the block
:func:`pack_general` lays out (:func:`general_geometry`). The plan
picks the first form that takes the shapes, in that order
(:func:`chain_form`). Layouts are
frames-major:
X2, Vs, Vb (B, N, F); g, mask (B, N); ypre (B, N, H); Z (B, N, L); the NMF
factors Wt (B, K, F) and H (B, K, N). `mh_chain.launches` counts kernel
launches per variant: "e_wh", "wf_wh", "e_vb", "wf_vb" for exact launches,
the same names ending in "_fast" for launches with a fast option but not
`approx_trans`, in "_trans" for those with `approx_trans`, and the level's
key followed by "_mm16" for launches with bfloat16 products (for example
"e_wh_fast_mm16"); a launch of the general form has "_gen" after the form
("e_wh_gen", "wf_vb_gen_trans", "e_wh_gen_fast_mm16"), one of the
extended cluster form "_ext" ("e_wh_ext", "wf_vb_ext_fast").
"""

import ctypes

import numpy as np
import torch

from .. import _build, _launches
from .engine import VX_FLOOR

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_VP] * 20 + [_I] * 9 + [_F, _I, ctypes.c_uint64] + [_I] * 4
             + [_VP])
# The general form's entry point: 22 pointers (the packed weights, bm as
# an array), B, N, F, L, the widths' array, depth, K, n_steps, burnin,
# sqrt_var, mode, seed, the four options and the stream.
_GEN_ARGTYPES = ([_VP] * 22 + [_I] * 4 + [_VP] + [_I] * 4 + [_F, _I,
                 ctypes.c_uint64] + [_I] * 4 + [_VP])
# The extended cluster form's entry point: 19 pointers, B, N, F, L, the
# widths' array, depth, K, CTAs a cluster, n_steps, burnin, sqrt_var, mode,
# seed, the four options and the stream.
_EXT_ARGTYPES = ([_VP] * 19 + [_I] * 4 + [_VP] + [_I] * 5
                 + [_F, _I, ctypes.c_uint64] + [_I] * 4 + [_VP])
# The general and extended forms' most hidden layers (checked against the
# libraries).
MAX_DEPTH = 4
# CTAs of the kernel's thread-block cluster: each holds a column slice of
# the decoder's weights (see :func:`pack_weights`).
CLUSTER = 4
# The extended cluster form's cluster sizes, tried in order (8 is the
# portable maximum).
EXT_CLUSTERS = (4, 8)
# Frames a tile of the cluster forms; N must be a multiple for every form
# (the general form's tile, 16, 8 or 4, divides it).
FRAME_TILE = 16
# Launch limits: threads a CTA of the cluster form (384 at F = 768, the
# most bins it takes) and the dynamic shared memory a CTA may take on the
# H100 (bytes).
_MAX_BLOCK = 384
SMEM_MAX = 232448
# Threads a CTA of the extended cluster form at most (Fsl <= 160 bins a
# rank; mh_chain_ext.cu's launch bound).
_EXT_MAX_BLOCK = 320
# The general form (mh_chain_general.cu): its frame tiles, tried in order,
# the stages of its weight ring and their floats, tried in order at each
# tile, and its consumer threads a CTA at most (checked against the library
# at launch).
GEN_TILES = (16, 8, 4)
GEN_STAGES = 4
GEN_SLOTS = (8192, 4096)
# the general form's units (columns) an output item, and the multiple of
# floats its packed rows are padded to
GEN_COLS = 4
GEN_PAD = 8
_GEN_MAX_CONSUMERS = 288
_LN2 = 0.6931471805599453
_SQRT2 = 1.4142135623730951
SAMPLE_DTYPES = (torch.float32, torch.bfloat16)
MATMUL_DTYPES = (torch.float32, torch.bfloat16)
LEVELS = ("", "_fast", "_trans")


def fast_log(x):
    """The TPU kernel's `_fast_log` for positive normal float32s, op for op:
    log x = e ln2 + 2s (1 + s^2/3 + s^4/5 + s^6/7) with s = (m - 1)/(m + 1)
    and the mantissa m in [sqrt(1/2), sqrt(2)) (|rel err| < 2e-7)."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, 0.5 * m, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = 2.0 * s * (1.0 + s2 * (0.33333333 + s2 * (0.2 + s2 * 0.14285714)))
    return e * _LN2 + p


def fast_exp(x):
    """The TPU kernel's `_fast_exp`, op for op: 2^zi times a degree-6
    Taylor of the Cody-Waite residual, x clamped to [-87, 88]
    (|rel err| < 3e-7)."""
    x = torch.clamp(x, -87.0, 88.0)
    zi = torch.floor(x * (1.0 / _LN2) + 0.5)
    r = (x - zi * 0.693359375) + zi * 2.12194440e-4
    p = 1.0 + r * (1.0 + r * (0.5 + r * (0.16666666666666666 + r * (
        0.041666666666666664 + r * (0.008333333333333333
                                    + r * 0.001388888888888889)))))
    scale = ((zi.to(torch.int32) + 127) << 23).view(torch.float32)
    return scale * p


def _variant(mode, form, samples_dtype, approx_recip, approx_trans,
             matmul_dtype=torch.float32):
    """The `mh_chain.launches` key of a launch (`form` "wh" / "vb", or
    "wh_gen" / "vb_gen" for the general form, "wh_ext" / "vb_ext" for the
    extended cluster form)."""
    mm = "_mm16" if matmul_dtype == torch.bfloat16 else ""
    if approx_trans:
        return f"{mode}_{form}_trans{mm}"
    fast = approx_recip or (mode == "e" and samples_dtype == torch.bfloat16)
    return f"{mode}_{form}{'_fast' if fast else ''}{mm}"


def bf16_weights(dec_w):
    """The decoder's parts with the weights of its three products (w1, the
    hidden layers' w, wo) rounded to bfloat16 and held as float32, the
    operands K1d reads; the biases stay as they are. Rounding is
    idempotent, so the plain version may take these too
    (:func:`plan_chain` rounds them once a plan)."""
    def r(w):
        return w.to(torch.bfloat16).float()

    return {"w1": r(dec_w["w1"]),
            "mid": tuple((r(w), b) for w, b in dec_w["mid"]),
            "wo": r(dec_w["wo"]), "bo": dec_w["bo"]}


def _cdiv(a, b):
    return -(-a // b)


def _round4(a):
    return (a + 3) // 4 * 4


def _slices(x, n, cluster):
    """x (..., n) cut along its last axis into `cluster` slices of ceil(n /
    cluster) (the last ones ragged or empty, zero-filled), each padded with
    zeros to a multiple of 4: (cluster, ..., padded)."""
    width = _cdiv(n, cluster)
    x = torch.nn.functional.pad(x, (0, cluster * width - n))
    x = x.reshape(*x.shape[:-1], cluster, width).movedim(-2, 0)
    return torch.nn.functional.pad(x, (0, _round4(width) - width))


def pack_weights(dec_w, cluster=CLUSTER):
    """A cluster form's per-rank weight blocks (C, P) float32 for clusters
    of C = `cluster` CTAs: the cluster form's at C = CLUSTER, the extended
    cluster form's at its cluster size. Rank r of a cluster owns the output
    bins [r Fsl, (r+1) Fsl), Fsl = ceil(F / C), and of each hidden layer d
    the units [r Hsl_d, (r+1) Hsl_d), Hsl_d = ceil(H_d / C) (the last ranks
    ragged or empty); its block holds, zero-padded to rows of Fsp = Fsl and
    Hsp_d = Hsl_d rounded up to a multiple of 4: wo [H_depth][Fsp], bo
    [Fsp], w1 [L][Hsp_1], then per hidden layer d after the first its
    weights [H_d-1][Hsp_d] and bias [Hsp_d]. At one hidden width the two
    forms' layouts agree. The kernel copies a rank's block into shared
    memory once a launch. Bfloat16-rounded weights (:func:`bf16_weights`)
    are packed as they are."""
    w1, wo = dec_w["w1"], dec_w["wo"]
    F = wo.shape[1]
    parts = [_slices(wo, F, cluster), _slices(dec_w["bo"], F, cluster),
             _slices(w1, w1.shape[1], cluster)]
    for w, b in dec_w["mid"]:
        parts += [_slices(w, w.shape[1], cluster),
                  _slices(b, b.shape[0], cluster)]
    return torch.cat([p.reshape(cluster, -1) for p in parts],
                     dim=1).contiguous()


def _lib():
    lib = _build.library("mh_chain")
    if lib.gvnmf_mh_chain.argtypes is None:
        lib.gvnmf_mh_chain.argtypes = _ARGTYPES
        lib.gvnmf_mh_chain.restype = _I
        lib.gvnmf_mh_chain_tile.argtypes = []
        lib.gvnmf_mh_chain_tile.restype = _I
        lib.gvnmf_mh_chain_cluster.argtypes = []
        lib.gvnmf_mh_chain_cluster.restype = _I
        lib.gvnmf_mh_chain_smem.argtypes = [_I] * 5
        lib.gvnmf_mh_chain_smem.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_packed.argtypes = [_I] * 4
        lib.gvnmf_mh_chain_packed.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_block.argtypes = [_I]
        lib.gvnmf_mh_chain_block.restype = _I
        lib.gvnmf_mh_chain_occupancy.argtypes = [_I] * 5 + [_VP]
        lib.gvnmf_mh_chain_occupancy.restype = _I
        if lib.gvnmf_mh_chain_cluster() != CLUSTER:
            raise _build.KernelError("mh_chain.cu's cluster size differs "
                                     f"from the wrapper's {CLUSTER}")
        lib.gvnmf_philox_streams.argtypes = [ctypes.c_uint64] + [_I] * 4 + [
            _VP] * 3
        lib.gvnmf_philox_streams.restype = _I
    return lib


def _lib_general():
    lib = _build.library("mh_chain_general")
    if lib.gvnmf_mh_chain_general.argtypes is None:
        lib.gvnmf_mh_chain_general.argtypes = _GEN_ARGTYPES
        lib.gvnmf_mh_chain_general.restype = _I
        lib.gvnmf_mh_chain_general_depth.argtypes = []
        lib.gvnmf_mh_chain_general_depth.restype = _I
        for fn in (lib.gvnmf_mh_chain_general_tile,
                   lib.gvnmf_mh_chain_general_block):
            fn.argtypes = [_I, _I, _VP, _I, _I]
            fn.restype = _I
        lib.gvnmf_mh_chain_general_smem.argtypes = [_I, _I, _VP, _I, _I]
        lib.gvnmf_mh_chain_general_smem.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_general_packed.argtypes = [_I, _I, _VP, _I]
        lib.gvnmf_mh_chain_general_packed.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_general_registers.argtypes = [_VP]
        lib.gvnmf_mh_chain_general_registers.restype = _I
        if lib.gvnmf_mh_chain_general_depth() != MAX_DEPTH:
            raise _build.KernelError("mh_chain_general.cu's depth limit "
                                     f"differs from the wrapper's {MAX_DEPTH}")
    return lib


def _lib_ext():
    lib = _build.library("mh_chain_ext")
    if lib.gvnmf_mh_chain_ext.argtypes is None:
        lib.gvnmf_mh_chain_ext.argtypes = _EXT_ARGTYPES
        lib.gvnmf_mh_chain_ext.restype = _I
        lib.gvnmf_mh_chain_ext_depth.argtypes = []
        lib.gvnmf_mh_chain_ext_depth.restype = _I
        lib.gvnmf_mh_chain_ext_block.argtypes = [_I, _I]
        lib.gvnmf_mh_chain_ext_block.restype = _I
        lib.gvnmf_mh_chain_ext_packed.argtypes = [_I, _I, _VP, _I, _I]
        lib.gvnmf_mh_chain_ext_packed.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_ext_smem.argtypes = [_I, _I, _VP, _I, _I, _I]
        lib.gvnmf_mh_chain_ext_smem.restype = ctypes.c_longlong
        lib.gvnmf_mh_chain_ext_occupancy.argtypes = [_I, _I, _VP, _I, _I, _I,
                                                     _VP]
        lib.gvnmf_mh_chain_ext_occupancy.restype = _I
        if lib.gvnmf_mh_chain_ext_depth() != MAX_DEPTH:
            raise _build.KernelError("mh_chain_ext.cu's depth limit differs "
                                     f"from the wrapper's {MAX_DEPTH}")
    return lib


def widths(dec_w):
    """The decoder's hidden widths (H1, ..., H_depth)."""
    return (dec_w["w1"].shape[1],
            *(w.shape[1] for w, _ in dec_w["mid"]))


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _one_of(WH, Vb):
    if (WH is None) == (Vb is None):
        raise ValueError("pass exactly one of Vb / WH")


def mh_chain_ref(dec_w, X2, WH, g, ypre, Z, Vs, mode="e", nsamples=10,
                 burnin=30, var_RW=0.01, noise=None, mask=None,
                 generator=None, Vb=None, samples_dtype=torch.float32,
                 approx_recip=False, approx_trans=False,
                 matmul_dtype=torch.float32):
    """Plain PyTorch version of the chain (also the CPU path).

    Exactly one of WH = (Wt, H) and Vb (B, N, F) gives the noise variance.
    noise: (Zn (B, n_steps, N, L), U (B, n_steps, N)) recorded streams;
    without it they are drawn from `generator`. Returns (Z, Vs, extra):
    extra = (samples (B, nsamples, N, F), numW (B, K, F), denW (B, K, F))
    in 'e' mode with WH, (samples, s1, s2) with s1 = sum 1/Vx and
    s2 = sum 1/Vx^2 (B, N, F) in 'e' mode with Vb, and (WFs_sum, WFn_sum)
    (B, N, F) in 'wf' mode. The samples are rounded to `samples_dtype`;
    `approx_trans` swaps the exp / log for :func:`fast_exp` /
    :func:`fast_log`; `approx_recip` changes nothing here (exact 1/Vx);
    `matmul_dtype=torch.bfloat16` rounds both operands of each decoder
    product to bfloat16 and sums the exact products in float32."""
    _one_of(WH, Vb)
    _check_dtype(samples_dtype)
    _check_matmul_dtype(matmul_dtype)
    log_ = fast_log if approx_trans else torch.log
    exp_ = fast_exp if approx_trans else torch.exp
    B, N, F = X2.shape
    L = Z.shape[-1]
    n_steps = nsamples + burnin
    if noise is None:
        Zn = torch.randn((B, n_steps, N, L), generator=generator,
                         device=X2.device)
        U = torch.rand((B, n_steps, N), generator=generator,
                       device=X2.device)
    else:
        Zn, U = noise
    if WH is not None:
        Wt, H = WH
        Vb = torch.einsum("bkn,bkf->bnf", H, Wt)
    G = g[..., None]
    sqrt_var = float(np.sqrt(var_RW))

    if matmul_dtype == torch.bfloat16:
        def mm(a, w):
            return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    else:
        def mm(a, w):
            return a @ w

    def decode(Zc):
        h = torch.tanh(mm(Zc, dec_w["w1"]) + ypre)
        for w, b in dec_w["mid"]:
            h = torch.tanh(mm(h, w) + b)
        return exp_(mm(h, dec_w["wo"]) + dec_w["bo"])

    def mix_var(Vs_):
        return torch.clamp_min(G * Vs_ + Vb, VX_FLOOR)

    def rowsum(Vx, inv):
        return torch.sum(log_(Vx) + inv * X2, dim=-1)

    def propose(m, Z, s):
        Zp = Z + sqrt_var * Zn[:, m]
        Vsp = decode(Zp)
        Vxp = mix_var(Vsp)
        invp = 1.0 / Vxp
        sp = rowsum(Vxp, invp)
        acc = (s - sp) + 0.5 * torch.sum(Z * Z - Zp * Zp, dim=-1)
        return log_(U[:, m]) < acc, Zp, Vsp, invp, sp

    Vx0 = mix_var(Vs)
    s = rowsum(Vx0, 1.0 / Vx0)
    for m in range(burnin):
        accept, Zp, _, _, sp = propose(m, Z, s)
        Z = torch.where(accept[..., None], Zp, Z)
        s = torch.where(accept, sp, s)
    Vs = decode(Z)
    inv = 1.0 / mix_var(Vs)
    acc1 = torch.zeros_like(X2)
    acc2 = torch.zeros_like(X2)
    samples = []
    for m in range(nsamples):
        accept, Zp, Vsp, invp, sp = propose(burnin + m, Z, s)
        a = accept[..., None]
        Z = torch.where(a, Zp, Z)
        Vs = torch.where(a, Vsp, Vs)
        inv = torch.where(a, invp, inv)
        s = torch.where(accept, sp, s)
        if mode == "wf":
            t = Vb * inv
            acc2 = acc2 + t              # WFn sum
            acc1 = acc1 + (1.0 - t)      # WFs sum
        else:
            samples.append(Vs)
            acc1 = acc1 + inv            # s1
            acc2 = acc2 + inv * inv      # s2
    if mode == "wf":
        return Z, Vs, (acc1, acc2)
    samples = torch.stack(samples, dim=1).to(samples_dtype)
    if WH is None:
        return Z, Vs, (samples, acc1, acc2)
    m3 = mask[..., None]
    numW = torch.einsum("bkn,bnf->bkf", H, X2 * acc2 * m3)
    denW = torch.einsum("bkn,bnf->bkf", H, acc1 * m3)
    return Z, Vs, (samples, numW, denW)


def _check_dtype(samples_dtype):
    if samples_dtype not in SAMPLE_DTYPES:
        raise ValueError(f"samples_dtype must be one of {SAMPLE_DTYPES}, got "
                         f"{samples_dtype}")


def _check_matmul_dtype(matmul_dtype):
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}, got "
                         f"{matmul_dtype}")


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layers(dec_w, ws, L, F, device):
    """The decoder's weights against its widths `ws`."""
    _check("w1", dec_w["w1"], (L, ws[0]), device)
    for i, (w, b) in enumerate(dec_w["mid"]):
        _check(f"mid[{i}] weights", w, (ws[i], ws[i + 1]), device)
        _check(f"mid[{i}] bias", b, (ws[i + 1],), device)
    _check("wo", dec_w["wo"], (ws[-1], F), device)
    _check("bo", dec_w["bo"], (F,), device)


def _block(F, cluster, least=64):
    """Threads a CTA of either cluster form: a thread per 4 columns x 4
    frames of the rank's Fsp-column slice of 32 frames, in warps, at least
    `least` (the cluster form's 64, the extended form's 256)."""
    nq = _round4(_cdiv(F, cluster)) // 4
    return max(least, 32 * _cdiv(8 * nq, 32))


def cluster_smem(F, L, Hd, K, depth):
    """The cluster form's dynamic shared memory a CTA (bytes) at one hidden
    width Hd (mh_chain.cu's `smem_floats`)."""
    T = 2 * FRAME_TILE
    Fsp, Hsp = _round4(_cdiv(F, CLUSTER)), _round4(_cdiv(Hd, CLUSTER))
    P = Hd * Fsp + Fsp + L * Hsp + (depth - 1) * (Hd * Hsp + Hsp)
    nw = _block(F, CLUSTER) // 32
    return 4 * (P + 4 * T * Fsp + 2 * Hd * T + Hsp * T + 3 * L * T
                + _round4(K) * T + CLUSTER * nw * T + 7 * T + 4)


def ext_sizes(F, L, ws, K, cluster):
    """(threads a CTA, floats of a rank's weight block, dynamic shared
    memory a CTA in bytes) of the extended cluster form at these shapes
    with `cluster` CTAs a cluster (mh_chain_ext.cu's `geometry` and
    `smem_floats`): the weight block, the two accumulators of the rank's
    columns for 32 frames (X2 and Vb live in registers), two activation
    buffers as tall as the widest even and odd hidden layer, the first
    layer's ypre, Z, Zp and the normals, the H tile, the per-warp frame
    sums of every rank."""
    T = 2 * FRAME_TILE
    Fsp = _round4(_cdiv(F, cluster))
    hsp = [_round4(_cdiv(h, cluster)) for h in ws]
    P = (ws[-1] * Fsp + Fsp + L * hsp[0]
         + sum(ws[d - 1] * hsp[d] + hsp[d] for d in range(1, len(ws))))
    nt = _block(F, cluster, least=256)
    rows = max(ws[0::2]) + max(ws[1::2], default=0)
    floats = (P + 2 * T * Fsp + rows * T + hsp[0] * T + 3 * L * T
              + _round4(K) * T + cluster * (nt // 32) * T + 7 * T + 4)
    return nt, P, 4 * floats


def ext_cluster(F, L, ws, K, smem_max=SMEM_MAX):
    """The extended cluster form's cluster size at these shapes: the first
    of EXT_CLUSTERS whose CTA fits its block size and `smem_max` bytes of
    shared memory, or None."""
    if not 1 <= len(ws) <= MAX_DEPTH:
        return None
    for c in EXT_CLUSTERS:
        nt, _, smem = ext_sizes(F, L, ws, K, c)
        if nt <= _EXT_MAX_BLOCK and smem <= smem_max:
            return c
    return None


def general_sizes(F, L, ws, K, T, slot):
    """(threads a CTA, dynamic shared memory a CTA in bytes) of the general
    form at frame tile T and ring stages of `slot` floats
    (mh_chain_general.cu's `consumers` and `smem_floats`): a consumer
    thread per output item of GEN_COLS columns x 8 frames (x 4 at T = 4),
    in warps, 64 to 288, and a producer warp; the weight ring (GEN_STAGES
    stages of `slot` floats), two activation buffers [rows][T] as tall as
    the widest even and the widest odd hidden layer (one at depth 1), Z,
    Zp and the normals, the H tile, the output items' frame partials, 7 T
    floats of per-frame state and the ring's 2 GEN_STAGES mbarriers."""
    nq = _cdiv(F, GEN_COLS)
    nfg = T // min(T, 8)
    nc = min(_GEN_MAX_CONSUMERS, max(64, 32 * _cdiv(nfg * nq, 32)))
    rows = _round4(max(ws[0::2])) + _round4(max(ws[1::2], default=0))
    floats = (GEN_STAGES * slot
              + T * (rows + 3 * _round4(L) + _round4(K) + _round4(nq) + 7)
              + 4 * GEN_STAGES)
    return nc + 32, 4 * floats


def general_plan(F, L, ws, K, smem_max=SMEM_MAX):
    """The general form's (frame tile, floats a ring stage) at these shapes
    (K the NMF rank, 0 for the Vb form): the first of GEN_TILES = (16, 8,
    4) whose CTA fits `smem_max` bytes, with the first of GEN_SLOTS =
    (8192, 4096) that fits beside it; None where none does. A tile of T
    frames with stages of S floats takes

        4 (4 S + T (R + 3 L4 + K4 + Q4 + 7) + 16) bytes,

    R = round4(max(H1, H3)) + round4(max(H2, H4)) the rows of the two
    activation buffers (the second 0 at depth 1), L4, K4, Q4 = L, K and
    ceil(F / 4) rounded up to multiples of 4 (:func:`general_sizes`). At
    F=513, L=32, K=10 (3 L4 + K4 + Q4 + 7 = 247) the 232,448 B a CTA may
    take hold R = 10,180 at T = 4 and S = 4096: one hidden layer of up to
    10,180 units, or two alternating layers of that many together."""
    for T in GEN_TILES:
        for slot in GEN_SLOTS:
            if general_sizes(F, L, ws, K, T, slot)[1] <= smem_max:
                return T, slot
    return None


def general_tile(F, L, ws, K, smem_max=SMEM_MAX):
    """The general form's frame tile at these shapes, or None where it
    does not take them (:func:`general_plan`)."""
    plan = general_plan(F, L, ws, K, smem_max)
    return None if plan is None else plan[0]


def _round_pad(a):
    return _cdiv(a, GEN_PAD) * GEN_PAD


def general_packed(F, L, ws):
    """Floats of the general form's packed weight block
    (:func:`pack_general`)."""
    return sum(i * _round_pad(o) for i, o in zip((L, *ws), (*ws, F)))


def pack_general(dec_w):
    """The general form's weight block: w1, the hidden layers' weights
    after it and wo, layer after layer, each [inputs][outputs rounded up to
    GEN_PAD] with its rows zero-padded, so that every run the kernel copies
    (a k-tile of rows, or a row's column chunk) is 16-byte aligned and an
    output item of up to 8 columns lies in its row. The biases are read
    from the decoder's parts. Bfloat16-rounded weights
    (:func:`bf16_weights`) are packed as they are."""
    mats = [dec_w["w1"], *(w for w, _ in dec_w["mid"]), dec_w["wo"]]
    return torch.cat([torch.nn.functional.pad(
        w, (0, _round_pad(w.shape[1]) - w.shape[1])).reshape(-1)
        for w in mats]).contiguous()


def chain_form(F, L, ws, K, N, smem_max=SMEM_MAX):
    """The chain's form at these shapes (ws the hidden widths, K the NMF
    rank, 0 for the Vb form), as the plan picks it: ("cluster", CLUSTER)
    where the cluster form takes the decoder (one hidden width, F <= 768,
    its CTA within `smem_max` bytes), else ("ext", C) where a cluster of C
    CTAs of the extended form holds it (:func:`ext_cluster`), else
    ("general", None), K1g. N must be a multiple of FRAME_TILE for the
    cluster forms. A function of the shapes alone."""
    if N % FRAME_TILE == 0:
        if (len(set(ws)) == 1 and _block(F, CLUSTER) <= _MAX_BLOCK
                and cluster_smem(F, L, ws[0], K, len(ws)) <= smem_max):
            return "cluster", CLUSTER
        c = ext_cluster(F, L, ws, K, smem_max)
        if c is not None:
            return "ext", c
    return "general", None


FORMS = ("auto", "cluster", "ext", "general")


def plan_chain(dec_w, F, L, K, N, device, matmul_dtype=torch.float32,
               form="auto"):
    """The decoder as the chain reads it at these shapes (K the NMF rank,
    0 for the Vb form) on a device of `device`'s type: its parts "w1",
    "mid", "wo", "bo", rounded by :func:`bf16_weights` where
    `matmul_dtype` is torch.bfloat16, and

    - "form": the kernel that runs, "cluster" (K1a-K1d), "ext" (K1e) or
      "general" (K1g) on CUDA, "plain" (:func:`mh_chain_ref`) elsewhere;
    - "cluster": CTAs a cluster of the cluster forms, else None;
    - "packed": the form's weight block (:func:`pack_weights` at that
      cluster size, or :func:`pack_general`), on the parts' device; None
      for the plain version;
    - "skips": whether the form skips the tile pairs its live flags mark
      dead (only the cluster form does);
    - "at": what it was planned for, (F, L, K, N, device type,
      matmul_dtype); :func:`mh_chain` refuses a plan made for another
      launch.

    form: "auto" plans the form :func:`chain_form` picks; "cluster",
    "ext" or "general" plan that form (to time or test one form where
    another would run) and raise ValueError where it does not take the
    shapes. Off CUDA the plain version runs whatever the form. All but the
    weights is a function of the shapes, the device type, `matmul_dtype`
    and `form`, so a plan of CPU tensors for device "cuda" shows what the
    card runs. A caller that runs many chains plans once
    (`mcem_batch_fused` does); :func:`mh_chain` plans bare parts itself."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    _check_matmul_dtype(matmul_dtype)
    parts = {k: dec_w[k] for k in ("w1", "mid", "wo", "bo")}
    if matmul_dtype == torch.bfloat16:
        parts = bf16_weights(parts)
    kind = torch.device(device).type
    plan = dict(parts, form="plain", cluster=None, packed=None, skips=False,
                at=(F, L, K, N, kind, matmul_dtype))
    if kind != "cuda":
        return plan
    ws = widths(parts)
    if form == "auto":
        form, cl = chain_form(F, L, ws, K, N)
    elif form == "cluster":
        cl = CLUSTER
        if chain_form(F, L, ws, K, N)[0] != "cluster":
            raise ValueError(f"the cluster form does not take the decoder "
                             f"{tuple(ws)} at F={F}, L={L}, K={K}, N={N}")
    elif form == "ext":
        cl = ext_cluster(F, L, ws, K)
        if cl is None or N % FRAME_TILE:
            raise ValueError(f"the extended cluster form does not take the "
                             f"decoder {tuple(ws)} at F={F}, L={L}, K={K}, "
                             f"N={N}")
    else:
        cl = None
    if form == "general":
        _check_general(N, F, L, ws, K)
        packed = pack_general(parts)
    else:
        packed = pack_weights(parts, cl)
    return dict(plan, form=form, cluster=cl, packed=packed,
                skips=form == "cluster")


def general_geometry(F, L, ws, K, device=None):
    """The general form's launch at these shapes: frames a CTA, threads and
    dynamic shared memory a CTA, the floats of the packed weight block
    (each from the library and equal to the wrapper's mirror), registers a
    thread (E-mode WH kernel). CUDA only; ValueError where the form does
    not take the decoder."""
    _check_general(FRAME_TILE, F, L, ws, K)
    T, nt, smem, packed = _general_checked(F, L, ws, K)
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        _build.check(_lib_general().gvnmf_mh_chain_general_registers(out),
                     "mh_chain_general attributes query")
    return {"frames": T, "threads": nt, "smem_bytes": smem,
            "packed_floats": packed, "registers": out[0]}


def ext_geometry(F, L, ws, K, device=None):
    """The extended cluster form's launch at these shapes on the current
    card: CTAs a cluster, frames a cluster, threads and dynamic shared
    memory a CTA, the floats of a rank's weight block, registers a thread
    and the clusters that can be resident at once (exact E-mode kernel, WH
    form; `cudaOccupancyMaxActiveClusters`). CUDA only; ValueError where no
    cluster holds the decoder."""
    c = ext_cluster(F, L, ws, K)
    if c is None:
        raise ValueError(f"no cluster of {EXT_CLUSTERS} CTAs holds the "
                         f"decoder {tuple(ws)} at F={F}, L={L}, K={K}")
    lib = _lib_ext()
    hw = _ints(ws)
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        _build.check(lib.gvnmf_mh_chain_ext_occupancy(
            F, L, hw, len(ws), K, c, out), "mh_chain_ext occupancy query")
    return {"cluster": c, "frames": 2 * FRAME_TILE, "threads": out[2],
            "smem_bytes": lib.gvnmf_mh_chain_ext_smem(F, L, hw, len(ws), K,
                                                      c),
            "packed_floats": lib.gvnmf_mh_chain_ext_packed(F, L, hw,
                                                           len(ws), c),
            "registers": out[0], "max_active_clusters": out[1]}


def launch_geometry(F, L, Hd, K, depth, device=None):
    """The chain kernel's launch at these shapes on the current card:
    CTAs a cluster, frames a cluster, threads and dynamic shared memory a
    CTA, the floats of a rank's weight block, registers a thread and the
    clusters that can be resident at once (exact E-mode kernel, WH form).
    CUDA only."""
    lib = _lib()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        _build.check(lib.gvnmf_mh_chain_occupancy(F, L, Hd, K, depth, out),
                     "mh_chain occupancy query")
    return {"cluster": CLUSTER, "frames": lib.gvnmf_mh_chain_tile(),
            "threads": out[2], "smem_bytes": lib.gvnmf_mh_chain_smem(
                F, L, Hd, K, depth),
            "packed_floats": lib.gvnmf_mh_chain_packed(F, L, Hd, depth),
            "registers": out[0], "max_active_clusters": out[1]}


# Frames a tile pair, the cluster form's unit of work (one cluster each).
PAIR = 2 * FRAME_TILE


def live_pairs(mask):
    """The cluster form's live flags for a frame mask (B, N): (B,
    ceil(N / PAIR)) bool, live[b, p] = any(mask[b, PAIR p : PAIR (p + 1)] >
    0), one a tile pair in the kernel's layout (with an odd tile count the
    last pair is that tile alone). On the mask's device, with no host
    sync."""
    B, N = mask.shape
    pad = -N % PAIR
    return (torch.nn.functional.pad(mask, (0, pad)) > 0).view(
        B, (N + pad) // PAIR, PAIR).any(-1)


def mh_chain(dec_w, X2, WH, g, ypre, Z, Vs, seed=0, mode="e", nsamples=10,
             burnin=30, var_RW=0.01, noise=None, mask=None, Vb=None,
             samples_dtype=torch.float32, approx_recip=False,
             approx_trans=False, matmul_dtype=torch.float32, live=None):
    """Run the chain over a frames-major batch (see :func:`mh_chain_ref`
    for the arguments and results). `Vs` must be decode(Z): the initial data
    term comes from it and the kernel re-derives Vs at the burn-in boundary.
    E-mode with WH needs the frame mask; the Vb form is unmasked.
    `samples_dtype` is the E-mode sample dump's type (WF-mode has none and
    ignores it, as the JAX kernel does). `matmul_dtype` is torch.float32 or
    torch.bfloat16 (K1d, the decoder's products on bfloat16 operands).

    dec_w: the decoder's parts, or a plan of them (:func:`plan_chain`) for
    this launch's shapes, device type and `matmul_dtype`; bare parts are
    planned with the form the plan picks.

    seed: keys the in-kernel Philox stream on CUDA (the CPU path seeds a
    `torch.Generator` with it); ignored when `noise` is given.

    live: optional (B, ceil(N / PAIR)) bool flags of :func:`live_pairs`.
    The cluster form runs no chain on a pair whose flag is False and
    writes there what a chain that rejects every proposal leaves
    (`csrc/mh_chain.cu`'s file comment); every other output is the same
    as with live=None. The other forms and the CPU path compute every
    frame."""
    if mode not in ("e", "wf"):
        raise ValueError(f"mode must be 'e' or 'wf', got {mode!r}")
    _one_of(WH, Vb)
    _check_dtype(samples_dtype)
    _check_matmul_dtype(matmul_dtype)
    if mode == "e" and WH is not None and mask is None:
        raise ValueError("E-mode with WH needs the frame mask")
    B, N, F = X2.shape
    L = Z.shape[-1]
    Wt, H = WH if WH is not None else (None, None)
    K = 0 if WH is None else Wt.shape[1]
    if live is not None:
        want = (B, -(-N // PAIR))
        if (live.dtype != torch.bool or tuple(live.shape) != want
                or live.device != X2.device or not live.is_contiguous()):
            raise ValueError(f"live must be a contiguous bool tensor of "
                             f"shape {want} on {X2.device}, got "
                             f"{live.dtype} {tuple(live.shape)} on "
                             f"{live.device}")
    at = (F, L, K, N, X2.device.type, matmul_dtype)
    if "form" not in dec_w:
        dec_w = plan_chain(dec_w, *at)
    elif dec_w["at"] != at:
        raise ValueError(f"the decoder was planned for (F, L, K, N, device, "
                         f"matmul_dtype) = {dec_w['at']}, not {at}")
    fast_kw = dict(samples_dtype=samples_dtype, approx_recip=approx_recip,
                   approx_trans=approx_trans, matmul_dtype=matmul_dtype)
    if X2.device.type == "cpu":
        gen = None
        if noise is None:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
        return mh_chain_ref(dec_w, X2, WH, g, ypre, Z, Vs, mode=mode,
                            nsamples=nsamples, burnin=burnin, var_RW=var_RW,
                            noise=noise, mask=mask, generator=gen, Vb=Vb,
                            **fast_kw)
    if X2.device.type != "cuda":
        raise ValueError(f"unsupported device {X2.device}")
    dev = X2.device
    ws = widths(dec_w)
    n_steps = nsamples + burnin
    noise_in = (("Vb", Vb, (B, N, F)),) if WH is None else (
        ("Wt", Wt, (B, K, F)), ("H", H, (B, K, N)))
    for name, t, shape in (
            ("X2", X2, (B, N, F)), *noise_in,
            ("g", g, (B, N)), ("ypre", ypre, (B, N, ws[0])),
            ("Z", Z, (B, N, L)), ("Vs", Vs, (B, N, F))):
        _check(name, t, shape, dev)
    _check_layers(dec_w, ws, L, F, dev)
    use_mask = mode == "e" and WH is not None
    if use_mask:
        _check("mask", mask, (B, N), dev)
    zn = u = None
    if noise is not None:
        zn, u = noise
        _check("Zn", zn, (B, n_steps, N, L), dev)
        _check("U", u, (B, n_steps, N), dev)
    kernel, cl, packed = dec_w["form"], dec_w["cluster"], dec_w["packed"]
    tile = FRAME_TILE
    if kernel == "general":
        tile = _general_checked(F, L, ws, K)[0]
    z_out = torch.empty_like(Z)
    vs_out = torch.empty_like(X2)
    part1 = part2 = out3 = None
    bf16 = mode == "e" and samples_dtype == torch.bfloat16
    if mode == "wf":
        out1 = torch.empty_like(X2)
        out2 = torch.empty_like(X2)
    elif WH is None:
        out1 = torch.empty((B, nsamples, N, F), device=dev,
                           dtype=samples_dtype)
        out2 = torch.empty_like(X2)
        out3 = torch.empty_like(X2)
    else:
        out1 = torch.empty((B, nsamples, N, F), device=dev,
                           dtype=samples_dtype)
        out2 = torch.empty((B, K, F), device=dev)
        out3 = torch.empty((B, K, F), device=dev)
        part1 = torch.empty((B, N // tile, K, F), device=dev)
        part2 = torch.empty_like(part1)
    ptrs = (_ptr(X2), _ptr(Vb), _ptr(Wt), _ptr(H),
            _ptr(mask if use_mask else None), _ptr(g), _ptr(ypre), _ptr(Z),
            _ptr(Vs), _ptr(zn), _ptr(u))
    outs = (_ptr(z_out), _ptr(vs_out), _ptr(out1), _ptr(out2), _ptr(out3),
            _ptr(part1), _ptr(part2))
    opts = (float(np.sqrt(var_RW)), 0 if mode == "e" else 1,
            int(seed) & (2**64 - 1), int(bf16), int(bool(approx_recip)),
            int(bool(approx_trans)),
            int(matmul_dtype == torch.bfloat16), _stream(dev))
    key = "wh" if WH is not None else "vb"
    if kernel == "cluster":
        lib = _lib()
        _check("packed weights", packed,
               (CLUSTER, lib.gvnmf_mh_chain_packed(F, L, ws[0], len(ws))),
               dev)
        with torch.cuda.device(dev):
            status = lib.gvnmf_mh_chain(
                *ptrs, _ptr(packed), _ptr(live), *outs, B, N, F, L, ws[0], K,
                len(ws), n_steps, burnin, *opts)
        _build.check(status, "mh_chain kernel")
    elif kernel == "ext":
        _check("packed weights", packed, (cl, _ext_packed(F, L, ws, K, cl)),
               dev)
        with torch.cuda.device(dev):
            status = _lib_ext().gvnmf_mh_chain_ext(
                *ptrs, _ptr(packed), *outs, B, N, F, L, _ints(ws), len(ws), K,
                cl, n_steps, burnin, *opts)
        _build.check(status, "mh_chain_ext kernel")
        key += "_ext"
    else:
        _check("packed weights", packed, (general_packed(F, L, ws),), dev)
        if packed.data_ptr() % 16:
            raise ValueError("the packed weights must be 16-byte aligned")
        scratch = torch.empty((5, B, N, F), device=dev)
        bm = (_VP * (MAX_DEPTH - 1))(*(b.data_ptr() for _, b in
                                       dec_w["mid"]))
        with torch.cuda.device(dev):
            status = _lib_general().gvnmf_mh_chain_general(
                *ptrs, _ptr(packed), bm, _ptr(dec_w["bo"]), *outs,
                _ptr(scratch), B, N, F, L, _ints(ws), len(ws), K, n_steps,
                burnin, *opts)
        _build.check(status, "mh_chain_general kernel")
        key += "_gen"
    _launches.count(mh_chain, "mh_chain", _variant(mode, key, **fast_kw))
    if mode == "wf":
        return z_out, vs_out, (out1, out2)
    return z_out, vs_out, (out1, out2, out3)


def _ext_packed(F, L, ws, K, cl):
    """The floats of a rank's K1e weight block, from the library, which
    must agree with :func:`ext_sizes` (the wrapper's dispatch and packing
    rest on it)."""
    lib = _lib_ext()
    hw = _ints(ws)
    got = (lib.gvnmf_mh_chain_ext_block(F, cl),
           lib.gvnmf_mh_chain_ext_packed(F, L, hw, len(ws), cl),
           lib.gvnmf_mh_chain_ext_smem(F, L, hw, len(ws), K, cl))
    if got != ext_sizes(F, L, ws, K, cl):
        raise _build.KernelError(
            f"mh_chain_ext.cu's geometry {got} differs from the wrapper's "
            f"{ext_sizes(F, L, ws, K, cl)}")
    return got[1]


def _check_general(N, F, L, ws, K):
    """Raises ValueError for shapes the general form does not take: N not
    a multiple of FRAME_TILE, a depth outside 1 to MAX_DEPTH, or a decoder
    whose smallest frame tile (4) needs more than SMEM_MAX bytes of shared
    memory a CTA, 4 (4 * 4096 + 4 (R + 3 L4 + K4 + Q4 + 7) + 16) with R =
    round4(max(H1, H3)) + round4(max(H2, H4)), L4, K4, Q4 = L, K, ceil(F /
    4) rounded up to multiples of 4 (:func:`general_plan`)."""
    if N % FRAME_TILE:
        raise ValueError(f"N={N} must be a multiple of {FRAME_TILE}")
    if not 1 <= len(ws) <= MAX_DEPTH:
        raise ValueError(f"the CUDA chain takes 1 to {MAX_DEPTH} decoder "
                         f"hidden layers, got {len(ws)}")
    if general_tile(F, L, ws, K) is None:
        smem = general_sizes(F, L, ws, K, GEN_TILES[-1], GEN_SLOTS[-1])[1]
        raise ValueError(
            f"shapes need {smem} B of shared memory per CTA, past "
            f"{SMEM_MAX} (hidden widths {ws}, L={L}, K={K}, F={F}: the "
            "general form holds the activations of the widest even and the "
            f"widest odd hidden layer for a tile of {GEN_TILES[-1]} frames)")


def _general_checked(F, L, ws, K):
    """The general form's (frame tile, threads a CTA, shared memory a CTA,
    floats of the packed block) from the library, which must agree with
    the wrapper's mirror (the launch's scratch and packing rest on it)."""
    lib = _lib_general()
    hw = _ints(ws)
    got = (lib.gvnmf_mh_chain_general_tile(F, L, hw, len(ws), K),
           lib.gvnmf_mh_chain_general_block(F, L, hw, len(ws), K),
           lib.gvnmf_mh_chain_general_smem(F, L, hw, len(ws), K),
           lib.gvnmf_mh_chain_general_packed(F, L, hw, len(ws)))
    T, slot = general_plan(F, L, ws, K) or (0, GEN_SLOTS[-1])
    want = (T, *general_sizes(F, L, ws, K, T or GEN_TILES[-1], slot),
            general_packed(F, L, ws))
    if got != want:
        raise _build.KernelError(
            f"mh_chain_general.cu's geometry {got} differs from the "
            f"wrapper's {want}")
    return got


mh_chain.launches = dict.fromkeys(
    (f"{mode}_{form}{gen}{level}{mm}" for gen in ("", "_gen", "_ext")
     for mm in ("", "_mm16") for level in LEVELS
     for mode, form in (("e", "wh"), ("wf", "wh"), ("e", "vb"),
                        ("wf", "vb"))), 0)


def philox_streams(seed, B, N, L, n_steps, device):
    """The (Zn, U) streams the CUDA chain draws in-kernel for `seed`, in the
    `noise=` layout: running the chain with them reproduces its Philox run
    (without `approx_trans`, under which its Box-Muller logs are
    :func:`fast_log`'s). CUDA only (a diagnostic of the kernel's
    generator)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the in-kernel Philox stream exists only on CUDA")
    lib = _lib()
    zn = torch.empty((B, n_steps, N, L), device=device)
    u = torch.empty((B, n_steps, N), device=device)
    with torch.cuda.device(device):
        status = lib.gvnmf_philox_streams(int(seed) & (2**64 - 1), B, N, L,
                                          n_steps, zn.data_ptr(),
                                          u.data_ptr(), _stream(device))
    _build.check(status, "philox_streams kernel")
    return zn, u
