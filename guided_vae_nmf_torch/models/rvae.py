"""The recurrent VAE (RVAE) of Leglaive, Alameda-Pineda, Girin and Horaud,
"A recurrent variational autoencoder for speech enhancement" (ICASSP 2020,
arXiv:1910.10942), in its non-causal (BRNN) form, frames-major.

Decoder: a bidirectional LSTM over the latent sequence, then one dense
layer to the log-variances: with z_n (n = 1..N, L dims),

    ->h_n = LSTM_f(z_n, ->h_{n-1}),   <-h_n = LSTM_b(z_n, <-h_{n+1}),
    o_n = W_o [->h_n; <-h_n] + b_o,   Vs_n = exp(o_n).

Encoder (used for the chain's starting point, its posterior mean only):
a bidirectional LSTM g^x over the power spectrogram, an LSTM g^z over the
previous frame's mean, dense tanh layers over [g^x_n; g^z_n] and a linear
mean head: g^z_n = LSTM(mu_{n-1}, .), g_n = tanh(W_g [g^x_n; g^z_n] + b_g),
mu_n = W_mu g_n + b_mu, computed in frame order.

Every LSTM has standard i, f, g, o gates (in that order along its 4 H
outputs): c = f c' + i g, h = o tanh(c), pre-activations x W_ih + h' W_hh
+ b with the port's (in, out) weight layout and a single bias.

Padding: a row's valid frames are its first `lengths[b]`. Each direction
of a bidirectional LSTM runs over them alone: the backward direction
starts at the row's own last valid frame, so pad frames never reach valid
ones, and both directions' outputs are 0 at pad frames. The encoder's
ordered z-loop runs forward over every frame; a pad frame follows the
valid ones and cannot reach them.

:func:`bilstm_scan` is the plain PyTorch recurrence (any device), used by
the encoder and as the CPU path and oracle of the decoder's sweep kernels
(`mcem.lstm_sweep`), which run the decoder on the card.
"""

import math

import torch
from torch import nn

from .nets import Linear, linear_init


class LSTM(nn.Module):
    """One LSTM direction: w_ih (in, 4 H), w_hh (H, 4 H), b (4 H), gate
    order i, f, g, o."""

    def __init__(self, n_in, hidden):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(n_in, 4 * hidden),
                                 requires_grad=False)
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden),
                                 requires_grad=False)
        self.b = nn.Parameter(torch.zeros(4 * hidden), requires_grad=False)


class RVAE(nn.Module):
    """dims = [x_dim, z_dim, rnn, dense_g]: F, L, the LSTMs' units per
    direction, and the encoder's dense tanh widths (a list)."""

    def __init__(self, dims):
        super().__init__()
        x_dim, z_dim, rnn, dense_g = dims
        self.x_dim, self.z_dim, self.rnn = x_dim, z_dim, rnn
        self.enc_x_f = LSTM(x_dim, rnn)
        self.enc_x_b = LSTM(x_dim, rnn)
        self.enc_z = LSTM(z_dim, rnn)
        sizes = [3 * rnn, *dense_g]
        self.enc_g = nn.ModuleList(Linear(sizes[i], sizes[i + 1])
                                   for i in range(len(sizes) - 1))
        self.enc_mu = Linear(sizes[-1], z_dim)
        self.dec_f = LSTM(z_dim, rnn)
        self.dec_b = LSTM(z_dim, rnn)
        self.dec_out = Linear(2 * rnn, x_dim)

    def init_order(self):
        """The modules in the order :func:`rvae_init` draws them."""
        return [self.enc_x_f, self.enc_x_b, self.enc_z, *self.enc_g,
                self.enc_mu, self.dec_f, self.dec_b, self.dec_out]

    def decoder_weights(self):
        """The decoder's LSTM weights stacked by direction (forward,
        backward): w_ih (2, L, 4 H), w_hh (2, H, 4 H), b (2, 4 H)."""
        return stacked(self.dec_f, self.dec_b)


def stacked(fwd, bwd):
    return (torch.stack([fwd.w_ih, bwd.w_ih]).contiguous(),
            torch.stack([fwd.w_hh, bwd.w_hh]).contiguous(),
            torch.stack([fwd.b, bwd.b]).contiguous())


def lstm_init(lstm, generator):
    """w_ih, w_hh, then b, each uniform in +-1/sqrt(H) (PyTorch's LSTM
    init), in place."""
    k = 1.0 / math.sqrt(lstm.w_hh.shape[0])
    with torch.no_grad():
        for p in (lstm.w_ih, lstm.w_hh, lstm.b):
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * k)
    return lstm


def rvae_init(generator, dims):
    """An RVAE with seeded weights, frozen, on the CPU: module by module
    in `RVAE.init_order()`, LSTMs uniform in +-1/sqrt(H) (w_ih, w_hh, b),
    dense layers Xavier-normal with zero bias (`nets.linear_init`), all
    from the CPU `generator`."""
    model = RVAE(dims)
    for m in model.init_order():
        if isinstance(m, LSTM):
            lstm_init(m, generator)
        else:
            linear_init(m, generator)
    return model.eval()


def _cell(pre, c, H):
    """One LSTM step from the pre-activations (..., 4H) and the cell c:
    (i, f, g, o, c, h)."""
    sg = torch.sigmoid(pre)
    i, f, o = sg[..., :H], sg[..., H:2 * H], sg[..., 3 * H:]
    g = torch.tanh(pre[..., 2 * H:3 * H])
    c = torch.addcmul(f * c, i, g)
    return i, f, g, o, c, o * torch.tanh(c)


def _reversed_valid(lengths, N):
    """(B, N) frame index that reverses each row's valid frames and keeps
    its pad frames in place (an involution)."""
    t = torch.arange(N, device=lengths.device)
    ln = lengths[:, None]
    return torch.where(t < ln, ln - 1 - t, t)


def bilstm_scan(x, lengths, w_ih, w_hh, b, keep=False):
    """Plain bidirectional LSTM over x (B, N, in) with each row's valid
    frames `lengths` (B,) int: returns (Hout (B, N, 2 H) = [->h; <-h],
    save (2, B, N, 5, H) of i, f, g, o, c, or None). Pad frames are 0 in
    both. w_ih (2, in, 4 H), w_hh (2, H, 4 H), b (2, 4 H). The backward
    direction runs forward over each row's reversed valid frames, both
    directions in one batched step."""
    B, N, n_in = x.shape
    H = w_hh.shape[1]
    lengths = lengths.to(device=x.device, dtype=torch.long)
    T = int(lengths.max()) if B else 0
    rev = _reversed_valid(lengths, N)
    xs = torch.stack([x, x.gather(1, rev[..., None].expand(B, N, n_in))])
    xw = torch.matmul(xs, w_ih[:, None]) + b[:, None, None]  # (2, B, N, 4H)
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    outs = []
    for t in range(T):
        i, f, g, o, c, h = _cell(torch.baddbmm(xw[:, :, t], h, w_hh), c, H)
        outs.append(torch.stack([h, i, f, g, o, c], dim=2) if keep else h)
    pad = x.new_zeros((2, B, N - T) + outs[0].shape[2:]) if outs else None
    seq = torch.cat([torch.stack(outs, dim=2), pad], dim=2) if outs else (
        x.new_zeros((2, B, N) + ((6, H) if keep else (H,))))
    valid = (torch.arange(N, device=x.device) < lengths[:, None]).to(x.dtype)

    def frames_major(d):
        # direction d's outputs in frame order, 0 at pad frames
        z = seq[d] if d == 0 else seq[1].gather(1, rev.view(
            B, N, *([1] * (seq.dim() - 3))).expand(seq[1].shape))
        return z * valid.view(B, N, *([1] * (z.dim() - 2)))

    fw, bw = frames_major(0), frames_major(1)
    if not keep:
        return torch.cat([fw, bw], dim=-1), None
    Hout = torch.cat([fw[:, :, 0], bw[:, :, 0]], dim=-1)
    return Hout, torch.stack([fw[:, :, 1:], bw[:, :, 1:]])


def valid_lengths(mask):
    """Each row's valid frames (B,) int32 from a (B, N) frame mask whose
    valid frames come first."""
    return (mask > 0).sum(-1).to(torch.int32)


def rvae_encode_mean(model, X2, lengths):
    """The encoder's posterior mean Z (B, N, L) from the power spectrogram
    X2 (B, N, F), in plain PyTorch: the x-BiLSTM over the valid frames,
    then the ordered loop mu_n = W_mu g_n + b_mu with g^z_n = LSTM(mu_{n-1})
    (mu_0's input is 0) over every frame. The first dense layer's g^x part
    is one product over every frame before the loop."""
    B, N, _ = X2.shape
    H = model.rnn
    gx, _ = bilstm_scan(X2, lengths, *stacked(model.enc_x_f, model.enc_x_b))
    lz, first = model.enc_z, model.enc_g[0]
    pre_x = gx @ first.w[:2 * H] + first.b          # (B, N, dense_g[0])
    w_gz = first.w[2 * H:]
    h = X2.new_zeros((B, H))
    c = X2.new_zeros((B, H))
    mu = X2.new_zeros((B, model.z_dim))
    out = []
    for n in range(N):
        pre = torch.addmm(torch.addmm(lz.b, mu, lz.w_ih), h, lz.w_hh)
        *_, c, h = _cell(pre, c, H)
        a = torch.tanh(torch.addmm(pre_x[:, n], h, w_gz))
        for layer in model.enc_g[1:]:
            a = torch.tanh(torch.addmm(layer.b, a, layer.w))
        mu = torch.addmm(model.enc_mu.b, a, model.enc_mu.w)
        out.append(mu)
    return torch.stack(out, dim=1)


def refuse_rvae(model, what):
    """Raise NotImplementedError if `model` is an RVAE: `what` does not run
    one."""
    if isinstance(model, RVAE):
        raise NotImplementedError(
            f"{what} does not run an RVAE: an RVAE runs through "
            "pipeline.enhance_waveform and the offline entry points on it, "
            "with label_mode='none' and noise_model='nmf'")


def rvae_decode(model, Z, lengths):
    """The decoder's log-variances o (B, N, F) at Z (B, N, L): the sweep
    kernels on a card, the plain recurrence on the CPU."""
    from ..mcem.lstm_sweep import forward_sweep

    Hout, _ = forward_sweep(Z, lengths, *model.decoder_weights())
    return model.dec_out(Hout)
