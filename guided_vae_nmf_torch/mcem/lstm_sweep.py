"""The RVAE decoder's sweeps for the Langevin chain, and the chain step's
two elementwise passes (`csrc/lstm_sweep.cu`).

A Langevin step needs the log joint's gradient in Z through the decoder's
bidirectional LSTM (`models.rvae`): a forward sweep over the sequence
(both directions, in frame order and against it) that keeps each frame's
gates and cell, the output layer and the likelihood's gradient, and a
backward sweep, backpropagation through time in the reverse order, that
gives dL/dz. The sweeps are ordered in time; a plain PyTorch or library
LSTM launches kernels per timestep, thousands of times a batch, so on the
card each sweep is one kernel launch over the whole sequence.

- :func:`forward_sweep` (Z, lengths, w_ih, w_hh, b) -> (Hout (B, N, 2 H),
  save (2, B, N, 5, H) of i, f, g, o, c), pad frames 0;
- :func:`backward_sweep` (dH, save, lengths, w_ih, w_hh) -> the partial
  dL/dz (D, B, N, L) whose sum over D, in order, is dL/dz (D = 4 from
  the kernel: direction by CTA; 2 from the plain loops: direction);
- :func:`lik_grad` (O, b_o, X2, Vb, g, mask, floor) -> (Vs = exp(O + b_o),
  dJ/dO): Vx = max(g Vs + Vb, floor), dJ/dO = g Vs (X2 - Vx) / Vx^2 on
  valid frames where Vx is above the floor (autograd's clamp), 0
  elsewhere;
- :func:`langevin_update` (Z, parts, eps, mask, eta) -> Z + eta (sum(parts)
  - Z) + sqrt(2 eta) eps on valid frames, Z elsewhere.

CUDA tensors launch the kernels (or raise `_build.KernelError`); CPU
tensors run the plain versions (`*_ref`, also the kernels' oracle on the
card). Every kernel sums in a fixed order with no atomics and computes
each row alone, so a batch's rows equal the same rows run alone.
The four kernels count their launches in :data:`kernels` (`launches`:
"fwd", "bwd", "lik", "update"), read by the package's `launch_counts()`
under "lstm_sweep": a Langevin step runs one of each, with two cuBLAS
products (the output layer and its transpose) between them.
"""

import ctypes
import math
from types import SimpleNamespace

import torch

from .. import _build, _launches
from ..models.rvae import bilstm_scan

HIDDEN = 128            # the kernels' units per direction
MAX_L = 16              # the kernels' largest latent size
RC_CHOICES = (1, 2, 4)  # rows a cluster of the sweep kernels

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_max_clusters = {}
# The four kernels' launch counts, one variant a kernel.
kernels = SimpleNamespace(launches=dict.fromkeys(
    ("fwd", "bwd", "lik", "update"), 0))


def _lib():
    lib = _build.library("lstm_sweep")
    if lib.gvnmf_lstm_fwd.argtypes is None:
        lib.gvnmf_lstm_fwd.argtypes = [_VP] * 7 + [_I] * 4 + [_VP]
        lib.gvnmf_lstm_bwd.argtypes = [_VP] * 6 + [_I] * 4 + [_VP]
        lib.gvnmf_rvae_lik.argtypes = [_VP] * 8 + [_I] * 2 + [_F, _VP]
        lib.gvnmf_langevin_update.argtypes = ([_VP] * 5 + [_I] * 3
                                              + [_F] * 2 + [_VP])
        lib.gvnmf_lstm_max_clusters.argtypes = [_I, _VP]
        lib.gvnmf_lstm_hidden.argtypes = []
        for fn in (lib.gvnmf_lstm_fwd, lib.gvnmf_lstm_bwd,
                   lib.gvnmf_rvae_lik, lib.gvnmf_langevin_update,
                   lib.gvnmf_lstm_max_clusters, lib.gvnmf_lstm_hidden):
            fn.restype = _I
        if lib.gvnmf_lstm_hidden() != HIDDEN:
            raise _build.KernelError("lstm_sweep.cu's units differ from the "
                                     f"wrapper's {HIDDEN}")
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, t, shape, device):
    if (t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous float32 {tuple(shape)} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _lengths_on(lengths, device):
    return torch.as_tensor(lengths, device=device).to(torch.int32)


def max_clusters(rc, device):
    """Clusters of the sweep kernel at `rc` rows a cluster that can be
    resident at once on `device` (cudaOccupancyMaxActiveClusters)."""
    key = (torch.device(device).index, rc)
    if key not in _max_clusters:
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            _build.check(_lib().gvnmf_lstm_max_clusters(rc, out),
                         "lstm_sweep occupancy")
        _max_clusters[key] = out[0]
    return _max_clusters[key]


def rows_per_cluster(B, device):
    """The fewest rows a cluster (1, 2 or 4) at which the launch's 2 x
    ceil(B / rc) clusters are resident at once, else 4. A row's arithmetic
    does not depend on it."""
    for rc in RC_CHOICES:
        if 2 * -(-B // rc) <= max_clusters(rc, device):
            return rc
    return RC_CHOICES[-1]


def _check_weights(w_ih, w_hh, b, device):
    L = w_ih.shape[1]
    if w_hh.shape[1] != HIDDEN or not 1 <= L <= MAX_L:
        raise ValueError(f"the sweep kernels take {HIDDEN} units and at "
                         f"most {MAX_L} latent dims, got {w_hh.shape[1]} "
                         f"and {L}")
    _check("w_ih", w_ih, (2, L, 4 * HIDDEN), device)
    _check("w_hh", w_hh, (2, HIDDEN, 4 * HIDDEN), device)
    if b is not None:
        _check("b", b, (2, 4 * HIDDEN), device)
    return L


def forward_sweep(Z, lengths, w_ih, w_hh, b):
    """Both directions of the decoder's LSTM over Z (B, N, L): (Hout, save),
    see the module docstring."""
    if Z.device.type != "cuda":
        return bilstm_scan(Z, lengths, w_ih, w_hh, b, keep=True)
    dev = Z.device
    B, N, L = Z.shape
    if _check_weights(w_ih, w_hh, b, dev) != L:
        raise ValueError(f"Z has {L} latent dims, w_ih {w_ih.shape[1]}")
    _check("Z", Z, (B, N, L), dev)
    lens = _lengths_on(lengths, dev)
    Hout = torch.empty((B, N, 2 * HIDDEN), device=dev)
    save = torch.empty((2, B, N, 5, HIDDEN), device=dev)
    rc = rows_per_cluster(B, dev)
    with torch.cuda.device(dev):
        status = _lib().gvnmf_lstm_fwd(
            Z.data_ptr(), lens.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
            b.data_ptr(), Hout.data_ptr(), save.data_ptr(), B, N, L, rc,
            _stream(dev))
    _build.check(status, "lstm_sweep forward kernel")
    _launches.count(kernels, "lstm_sweep", "fwd")
    return Hout, save


def _bptt_frames(t, lengths, d):
    """Frame (B,) of backpropagation-through-time step t of direction d
    (each direction against its own order: the forward one from the row's
    last valid frame, the backward one from its first), and the rows where
    it is a valid frame."""
    n = lengths - 1 - t if d == 0 else torch.full_like(lengths, t)
    return n.clamp_min(0), t < lengths


def backward_sweep_ref(dH, save, lengths, w_ih, w_hh):
    """Plain backpropagation through time of both directions: (2, B, N, L)
    partials of dL/dz, one a direction, 0 at pad frames."""
    B, N, _ = dH.shape
    H = w_hh.shape[1]
    L = w_ih.shape[1]
    lengths = torch.as_tensor(lengths, device=dH.device).to(torch.long)
    out = dH.new_zeros((2, B, N, L))
    rows = torch.arange(B, device=dH.device)
    for d in (0, 1):
        dh_rec = dH.new_zeros((B, H))
        dc_next = dH.new_zeros((B, H))
        for t in range(int(lengths.max()) if B else 0):
            n, act = _bptt_frames(t, lengths, d)
            i, f, g, o, c = save[d, rows, n].unbind(1)
            # the cell before this frame in the direction's own order
            prev = n - 1 if d == 0 else n + 1
            has = (prev >= 0) & (prev < lengths)
            c_prev = torch.where(has[:, None],
                                 save[d, rows, prev.clamp(0, N - 1), 4], 0.0)
            dh = dH[rows, n, d * H:(d + 1) * H] + dh_rec
            tc = torch.tanh(c)
            d_o = dh * tc * o * (1 - o)
            dc = dh * o * (1 - tc * tc) + dc_next
            dg = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                            dc * i * (1 - g * g), d_o], dim=-1)
            dg = torch.where(act[:, None], dg, 0.0)
            dh_rec = dg @ w_hh[d].T
            dc_next = dc * f
            out[d, rows[act], n[act]] = (dg @ w_ih[d].T)[act]
    return out


def backward_sweep(dH, save, lengths, w_ih, w_hh):
    """dL/dz's partials (D, B, N, L) from dL/dHout (B, N, 2 H) and the
    forward sweep's `save`; see the module docstring."""
    if dH.device.type != "cuda":
        return backward_sweep_ref(dH, save, lengths, w_ih, w_hh)
    dev = dH.device
    B, N, _ = dH.shape
    L = _check_weights(w_ih, w_hh, None, dev)
    _check("dH", dH, (B, N, 2 * HIDDEN), dev)
    _check("save", save, (2, B, N, 5, HIDDEN), dev)
    lens = _lengths_on(lengths, dev)
    parts = torch.empty((4, B, N, L), device=dev)
    rc = rows_per_cluster(B, dev)
    with torch.cuda.device(dev):
        status = _lib().gvnmf_lstm_bwd(
            dH.data_ptr(), save.data_ptr(), lens.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), parts.data_ptr(), B, N, L, rc,
            _stream(dev))
    _build.check(status, "lstm_sweep backward kernel")
    _launches.count(kernels, "lstm_sweep", "bwd")
    return parts


def lik_grad_ref(O, bo, X2, Vb, g, mask, floor):
    Vs = torch.exp(O + bo)
    gVs = g[..., None] * Vs
    Vx = gVs + Vb
    keep = (mask[..., None] > 0) & (Vx >= floor)
    inv = 1.0 / torch.clamp_min(Vx, floor)
    return Vs, torch.where(keep, (X2 * inv - 1.0) * inv * gVs, 0.0)


def lik_grad(O, bo, X2, Vb, g, mask, floor):
    """(Vs, dJ/dO), each (B, N, F); see the module docstring."""
    if O.device.type != "cuda":
        return lik_grad_ref(O, bo, X2, Vb, g, mask, floor)
    dev = O.device
    B, N, F = O.shape
    for name, t, shape in (("O", O, (B, N, F)), ("bo", bo, (F,)),
                           ("X2", X2, (B, N, F)), ("Vb", Vb, (B, N, F)),
                           ("g", g, (B, N)), ("mask", mask, (B, N))):
        _check(name, t, shape, dev)
    Vs = torch.empty_like(O)
    G = torch.empty_like(O)
    with torch.cuda.device(dev):
        status = _lib().gvnmf_rvae_lik(
            O.data_ptr(), bo.data_ptr(), X2.data_ptr(), Vb.data_ptr(),
            g.data_ptr(), mask.data_ptr(), Vs.data_ptr(), G.data_ptr(),
            B * N, F, float(floor), _stream(dev))
    _build.check(status, "rvae likelihood kernel")
    _launches.count(kernels, "lstm_sweep", "lik")
    return Vs, G


def langevin_update_ref(Z, parts, eps, mask, eta):
    grad = parts[0]
    for p in parts[1:]:
        grad = grad + p
    Zn = Z + eta * (grad - Z) + math.sqrt(2.0 * eta) * eps
    return torch.where(mask[..., None] > 0, Zn, Z)


def langevin_update(Z, parts, eps, mask, eta):
    """One unadjusted Langevin move of Z (B, N, L) at step size `eta`; see
    the module docstring."""
    if Z.device.type != "cuda":
        return langevin_update_ref(Z, parts, eps, mask, eta)
    dev = Z.device
    B, N, L = Z.shape
    D = parts.shape[0]
    for name, t, shape in (("Z", Z, (B, N, L)), ("parts", parts, (D, B, N, L)),
                           ("eps", eps, (B, N, L)), ("mask", mask, (B, N))):
        _check(name, t, shape, dev)
    out = torch.empty_like(Z)
    with torch.cuda.device(dev):
        status = _lib().gvnmf_langevin_update(
            Z.data_ptr(), parts.data_ptr(), eps.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B * N, L, D, float(eta),
            float(math.sqrt(2.0 * eta)), _stream(dev))
    _build.check(status, "langevin update kernel")
    _launches.count(kernels, "lstm_sweep", "update")
    return out

