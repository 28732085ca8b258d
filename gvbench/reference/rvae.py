"""The recurrent VAE with a Langevin E-step inside the NMF-noise EM,
written out again in plain PyTorch: the benchmark's reference for the
`rvae` family, and the CPU tests' reference for the port's RVAE. It
imports nothing of the program under test and nothing of JAX, and keeps
TF32 off for every product it does not round itself.

Model (Leglaive et al., arXiv:1910.10942, the non-causal BRNN variant),
frames-major, one row an utterance with its first `lengths[b]` frames
valid: a bidirectional LSTM decoder over Z (B, N, L) (each direction over
the row's valid frames alone; the backward one from the last valid frame),
o = W_o [->h; <-h] + b_o and Vs = exp(o). LSTM gates i, f, g, o in that
order, c = f c' + i g, h = o tanh(c), pre-activations x W_ih + h' W_hh + b
((in, out) weights, one bias). Encoder mean: a bidirectional LSTM over X2,
an LSTM over the previous frame's mean, tanh dense layers and a linear
head, in frame order.

E-step (Sadeghi and Serizel, arXiv:2309.10439): unadjusted Langevin
dynamics Z <- Z + eta grad log p(X, Z) + sqrt(2 eta) eps at valid frames,
the gradient by autograd through both LSTMs (no hand-written
backpropagation), log p(X, Z) = sum over valid frames of
-sum_f (log Vx + X2 / Vx) - |z|^2 / 2, Vx = max(g Vs + Vb, 1e-10). E chains
keep the last R iterates' Vs for the M-step (W, H, L1 normalisation, g:
`mcem.mstep_nmf`); the Wiener-filter chain averages g Vs / Vx and
Vb / Vx over its last iterates.

Departures from the papers:
- the encoder reads the mixture's power spectrogram (the paper's encoder
  was trained on clean speech and reads the observed spectrogram in the
  EM), and only its mean is used, as the chain's starting point;
- LSTMs carry one bias per gate (the paper's implementation has PyTorch's
  two, b_ih + b_hh, which sum to one);
- the EM is the NMF-noise MCEM of arXiv:2102.06454 with its chain lengths,
  the E-step replaced by Langevin dynamics as in arXiv:2309.10439 (which
  names the sampler, not these lengths); no accept test;
- weights are drawn from a seed (:func:`init_weights`): there are no
  trained RVAE weights.

Every function takes a precision: "f64" is the reference, "f32" float32,
"tf32" the control (each product's operands, and in the gradient each
product's incoming gradient, rounded to TF32).
"""

import math

import torch

from . import mcem
from .precision import cast, round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VX_FLOOR = 1e-10


# -- weights -----------------------------------------------------------------

def init_weights(seed, dims):
    """The float32 weights {name: tensor} an RVAE of dims [x_dim, z_dim,
    rnn, dense_g] draws from a CPU torch.Generator seeded with `seed`, in
    this order: the encoder's x-LSTM forward and backward, its z-LSTM (each
    w_ih (in, 4H), w_hh (H, 4H), b (4H), uniform in +-1/sqrt(H)), its dense
    layers and mean head (Xavier-normal w (in, out), zero b), the decoder's
    LSTM forward and backward, its output layer."""
    F, L, Hn, dense = dims
    gen = torch.Generator().manual_seed(int(seed))
    w = {}

    def lstm(name, n_in):
        k = 1.0 / math.sqrt(Hn)
        for part, shape in (("w_ih", (n_in, 4 * Hn)), ("w_hh", (Hn, 4 * Hn)),
                            ("b", (4 * Hn,))):
            w[f"{name}.{part}"] = (torch.rand(shape, generator=gen) * 2
                                   - 1) * k

    def dense_layer(name, n_in, n_out):
        std = math.sqrt(2.0 / (n_in + n_out))
        w[f"{name}.w"] = std * torch.randn(n_in, n_out, generator=gen)
        w[f"{name}.b"] = torch.zeros(n_out)

    lstm("enc_x_f", F)
    lstm("enc_x_b", F)
    lstm("enc_z", L)
    sizes = [3 * Hn, *dense]
    for i in range(len(dense)):
        dense_layer(f"enc_g.{i}", sizes[i], sizes[i + 1])
    dense_layer("enc_mu", sizes[-1], L)
    lstm("dec_f", L)
    lstm("dec_b", L)
    dense_layer("dec_out", 2 * Hn, F)
    return w


class Params:
    """The weights in a precision on a device, by name."""

    def __init__(self, weights, prec, device):
        self.prec = prec
        self.t = {k: cast(v, prec).to(device) for k, v in weights.items()}
        self.n_dense = sum(k.startswith("enc_g.") and k.endswith(".w")
                           for k in weights)

    def __getitem__(self, key):
        return self.t[key]


# -- products ----------------------------------------------------------------

class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return round_tf32(grad)


def _r(x, prec):
    return _TF32.apply(x) if prec == "tf32" else x


def mm(a, b, prec):
    """a @ b in the precision; with "tf32" the operands are rounded to TF32
    forward and the gradients flowing back through them too."""
    return _r(a, prec) @ _r(b, prec)


# -- networks ----------------------------------------------------------------

def _rev_index(lengths, N, device):
    """(B, N) index that reverses each row's valid frames and keeps its pad
    frames (an involution)."""
    t = torch.arange(N, device=device)[None, :]
    ln = lengths.to(device)[:, None]
    return torch.where(t < ln, ln - 1 - t, t)


def _gather(x, idx):
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bilstm(p, pre, x, lengths, prec):
    """The bidirectional LSTM `pre` ("dec" or "enc_x") over x (B, N, in):
    (B, N, 2H) = [->h; <-h], 0 at pad frames. The backward direction runs
    forward over each row's reversed valid frames."""
    B, N, _ = x.shape
    idx = _rev_index(lengths, N, x.device)
    valid = (torch.arange(N, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])
    xs = torch.stack([x, _gather(x, idx)])                     # (2, B, N, in)
    w_ih = torch.stack([p[f"{pre}_f.w_ih"], p[f"{pre}_b.w_ih"]])
    w_hh = torch.stack([p[f"{pre}_f.w_hh"], p[f"{pre}_b.w_hh"]])
    b = torch.stack([p[f"{pre}_f.b"], p[f"{pre}_b.b"]])
    xw = mm(xs, w_ih[:, None], prec) + b[:, None, None]        # (2, B, N, 4H)
    Hn = w_hh.shape[1]
    h = x.new_zeros((2, B, Hn))
    c = x.new_zeros((2, B, Hn))
    outs = []
    for t in range(N):
        gates = xw[:, :, t] + mm(h, w_hh, prec)
        i, f, g, o = gates.split(Hn, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    hs = torch.stack(outs, dim=2)                              # (2, B, N, H)
    out = torch.cat([hs[0], _gather(hs[1], idx)], dim=-1)
    return out * valid[..., None].to(out.dtype)


def decode_logvar(p, Z, lengths, prec):
    """o (B, N, F), the decoder's log-variances."""
    Hout = bilstm(p, "dec", Z, lengths, prec)
    return mm(Hout, p["dec_out.w"], prec) + p["dec_out.b"]


def encode_mean(p, X2, lengths, prec):
    """The encoder's mean Z (B, N, L) in frame order."""
    B, N, _ = X2.shape
    gx = bilstm(p, "enc_x", X2, lengths, prec)
    Hn = p["enc_z.w_hh"].shape[0]
    h = X2.new_zeros((B, Hn))
    c = X2.new_zeros((B, Hn))
    mu = X2.new_zeros((B, p["enc_mu.w"].shape[1]))
    out = []
    for n in range(N):
        gates = (mm(mu, p["enc_z.w_ih"], prec) + mm(h, p["enc_z.w_hh"], prec)
                 + p["enc_z.b"])
        i, f, g, o = gates.split(Hn, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        a = torch.cat([gx[:, n], h], dim=-1)
        for k in range(p.n_dense):
            a = torch.tanh(mm(a, p[f"enc_g.{k}.w"], prec) + p[f"enc_g.{k}.b"])
        mu = mm(a, p["enc_mu.w"], prec) + p["enc_mu.b"]
        out.append(mu)
    return torch.stack(out, dim=1)


# -- the E-step --------------------------------------------------------------

def log_joint(p, Z, X2, Vb, g, mask, lengths, prec):
    """(sum over the batch of log p(X, Z), Vs (B, N, F))."""
    Vs = torch.exp(decode_logvar(p, Z, lengths, prec))
    Vx = torch.clamp_min(g[..., None] * Vs + Vb, VX_FLOOR)
    m = mask[..., None]
    J = -torch.sum(m * (torch.log(Vx) + X2 / Vx)) - 0.5 * torch.sum(
        m * Z * Z)
    return J, Vs


def grad_log_joint(p, Z, X2, Vb, g, mask, lengths, prec):
    """(d log p(X, Z) / dZ by autograd, Vs at Z)."""
    with torch.enable_grad():
        Zg = Z.detach().requires_grad_(True)
        J, Vs = log_joint(p, Zg, X2, Vb, g, mask, lengths, prec)
        (grad,) = torch.autograd.grad(J, Zg)
    return grad, Vs.detach()


def langevin_chain(p, X2, Vb, g, mask, lengths, Z, eps, mode, nsamples,
                   burnin, eta, prec):
    """burnin + nsamples Langevin steps from Z with the draws eps (steps, B,
    N, L). Returns {"Z", "Vs" (at the last Z), and "samples" (B, R, N, F) in
    mode "e" or "ws" / "wn" (sums of g Vs / Vx and Vb / Vx) in mode "wf"}.
    Every input is cast to the precision's dtype."""
    X2, Vb, g, mask, Z, eps = (cast(t, prec) for t in
                               (X2, Vb, g, mask, Z, eps))
    valid = mask[..., None] > 0
    sq = math.sqrt(2.0 * eta)
    samples, ws, wn = [], 0.0, 0.0
    S = burnin + nsamples
    for m in range(S + 1):
        if m < S:
            grad, Vs = grad_log_joint(p, Z, X2, Vb, g, mask, lengths, prec)
        else:
            with torch.no_grad():
                Vs = torch.exp(decode_logvar(p, Z, lengths, prec))
        if m > burnin:
            if mode == "e":
                samples.append(Vs)
            else:
                gVs = g[..., None] * Vs
                inv = 1.0 / torch.clamp_min(gVs + Vb, VX_FLOOR)
                ws = ws + gVs * inv
                wn = wn + Vb * inv
        if m < S:
            Z = torch.where(valid, Z + eta * grad + sq * eps[m], Z)
    out = {"Z": Z, "Vs": Vs}
    if mode == "e":
        out["samples"] = torch.stack(samples, dim=1)
    else:
        out.update(ws=ws, wn=wn)
    return out


def h_sums(samples, g, Vb, prec):
    """(s1, s2) (B, N, F): sum_r 1 / Vx and sum_r 1 / Vx^2 over the dumps,
    the W update's per-bin sums."""
    samples, g, Vb = (cast(t, prec) for t in (samples, g, Vb))
    inv = 1.0 / torch.clamp_min(g[:, None, :, None] * samples + Vb[:, None],
                                VX_FLOOR)
    return torch.sum(inv, dim=1), torch.sum(inv * inv, dim=1)


def mstep(samples, Wt, H, g, X2, mask, prec):
    """W, H, L1 normalisation and g from the dumps: (Wt (B, K, F), H, g)."""
    numW, denW = mcem.w_sums(samples, Wt, H, g, X2, mask, prec)
    return mcem.mstep_nmf(samples, numW, denW, Wt, H, g, X2, prec)


def cost(samples, Wt, H, g, X2, mask, prec):
    """(B,) masked expected negative log-likelihood over the dumps."""
    samples, g, X2, mask = (cast(t, prec) for t in (samples, g, X2, mask))
    Vb = mcem.noise_var(cast(Wt, prec), cast(H, prec), prec)
    Vx = torch.clamp_min(g[:, None, :, None] * samples + Vb[:, None],
                         VX_FLOOR)
    per = torch.log(Vx) + X2[:, None] / Vx
    total = torch.sum(per * mask[:, None, :, None], dim=(1, 2, 3))
    return total / (samples.shape[1] * X2.shape[-1] * torch.sum(mask, 1))


def em(p, X2, mask, W0, H0, draws, cfg, prec, Z0=None):
    """The whole EM of a batch: X2 (B, N, F), mask (B, N) (valid frames
    first), the NMF init W0 (B, F, K) and H0 (B, K, N), `draws` the chains'
    eps in order (niter E chains, then the WF chain), cfg a dict with
    niter, nsamples_E_step, burnin_E_step, nsamples_WF, burnin_WF and
    ld_step. Z0 defaults to the encoder's mean. Returns the engine's dict,
    frames-major: WFs, WFn (B, N, F), cost (B, niter), W (B, F, K), H, g,
    Z (B, N, L)."""
    X2, mask = cast(X2, prec), cast(mask, prec)
    lengths = (mask > 0).sum(-1)
    Z = encode_mean(p, X2, lengths, prec) if Z0 is None else cast(Z0, prec)
    Wt, H = cast(W0, prec).transpose(1, 2), cast(H0, prec)
    g = torch.ones_like(mask)
    eta = cfg["ld_step"]
    costs = []
    for it in range(cfg["niter"]):
        Vb = mcem.noise_var(Wt, H, prec)
        r = langevin_chain(p, X2, Vb, g, mask, lengths, Z, draws[it], "e",
                           cfg["nsamples_E_step"], cfg["burnin_E_step"], eta,
                           prec)
        Z = r["Z"]
        Wt, H, g = mstep(r["samples"], Wt, H, g, X2, mask, prec)
        costs.append(cost(r["samples"], Wt, H, g, X2, mask, prec))
    Vb = mcem.noise_var(Wt, H, prec)
    r = langevin_chain(p, X2, Vb, g, mask, lengths, Z, draws[cfg["niter"]],
                       "wf", cfg["nsamples_WF"], cfg["burnin_WF"], eta, prec)
    R = cfg["nsamples_WF"]
    return {"WFs": r["ws"] / R, "WFn": r["wn"] / R,
            "cost": torch.stack(costs, dim=1) if costs else None,
            "W": Wt.transpose(1, 2), "H": H, "g": g, "Z": r["Z"]}
