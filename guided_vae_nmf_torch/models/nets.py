"""Frame-wise FFNN families as torch modules (inference forwards).

Counterpart of `guided_vae_nmf_tpu/models/nets.py`: the tanh encoder
(mu / log_var heads), the tanh^depth -> exp decoder, the M1 VAE, the guided
M2 deep generative model (label-concatenated encoder and decoder) and the
sigmoid classifier with optional inference BatchNorm.

Linear weights keep the reference layout (in, out) so a layer is
`x @ w + b`, as in the JAX package; :mod:`.convert` copies parameter trees
across unchanged. Sampling takes an explicit `torch.Generator`.
"""

import torch
from torch import nn


class Linear(nn.Module):
    """`x @ w + b` with w stored (in, out)."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(n_out), requires_grad=False)

    def forward(self, x):
        return x @ self.w + self.b


def linear_apply(layer, x):
    return layer(x)


def _mlp(sizes):
    return nn.ModuleList(
        Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))


class Encoder(nn.Module):
    """tanh MLP -> parallel mu / log_var heads."""

    def __init__(self, x_dim, h_dim, z_dim):
        super().__init__()
        self.hidden = _mlp([x_dim, *h_dim])
        self.mu = Linear(h_dim[-1], z_dim)
        self.log_var = Linear(h_dim[-1], z_dim)

    def forward(self, x, generator=None):
        """Returns (z, mu, log_var); z = mu when no generator is given."""
        h = x
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        mu = self.mu(h)
        log_var = self.log_var(h)
        z = mu if generator is None else reparametrize(generator, mu,
                                                       log_var)
        return z, mu, log_var


def reparametrize(generator, mu, log_var):
    """z = mu + exp(0.5*log_var) * eps."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                      device=mu.device)
    return mu + torch.exp(0.5 * log_var) * eps


class Decoder(nn.Module):
    """tanh MLP -> exp(Linear): a positive variance, not a mean."""

    def __init__(self, z_dim, h_dim, x_dim):
        super().__init__()
        self.hidden = _mlp([z_dim, *h_dim])
        self.out = Linear(h_dim[-1], x_dim)

    def forward(self, z):
        h = z
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        return torch.exp(self.out(h))


def encoder_apply(encoder, x, generator=None):
    return encoder(x, generator)


def decoder_apply(decoder, z):
    return decoder(z)


class VAE(nn.Module):
    """M1: dims = [x_dim, z_dim, h_dim]; the decoder mirrors the encoder."""

    y_dim = 0

    def __init__(self, dims):
        super().__init__()
        x_dim, z_dim, h_dim = dims
        self.encoder = Encoder(x_dim, h_dim, z_dim)
        self.decoder = Decoder(z_dim, list(reversed(h_dim)), x_dim)

    def forward(self, x, generator=None):
        z, mu, log_var = self.encoder(x, generator)
        return self.decoder(z), mu, log_var


class DGM(nn.Module):
    """M2 guided VAE: dims = [x_dim, y_dim, z_dim, h_dim]; the encoder sees
    cat[x, y], the decoder cat[z, y]."""

    def __init__(self, dims):
        super().__init__()
        x_dim, y_dim, z_dim, h_dim = dims
        self.y_dim = y_dim
        self.encoder = Encoder(x_dim + y_dim, h_dim, z_dim)
        self.decoder = Decoder(z_dim + y_dim, list(reversed(h_dim)), x_dim)

    def forward(self, x, y, generator=None):
        z, mu, log_var = self.encoder(torch.cat([x, y], dim=-1), generator)
        r = self.decoder(torch.cat([z, y], dim=-1))
        return r, mu, log_var


def vae_apply(model, x, generator=None):
    return model(x, generator)


def vae_sample(model, z):
    return model.decoder(z)


def dgm_apply(model, x, y, generator=None):
    return model(x, y, generator)


def dgm_sample(model, z, y):
    return model.decoder(torch.cat([z, y.to(z.dtype)], dim=-1))


class Classifier(nn.Module):
    """dims = [x_dim, h_dim, y_dim]: ReLU hidden layers (each optionally
    followed by inference BatchNorm on running stats), sigmoid output."""

    def __init__(self, dims, batch_norm=False):
        super().__init__()
        x_dim, h_dim, y_dim = dims
        self.hidden = _mlp([x_dim, *h_dim])
        self.out = Linear(h_dim[-1], y_dim)
        self.batch_norm = batch_norm
        if batch_norm:
            self.bn = nn.ModuleList(_BatchNorm(h) for h in h_dim)

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.hidden):
            h = layer(h)
            if self.batch_norm:
                h = self.bn[i](h)
            h = torch.relu(h)
        return torch.sigmoid(self.out(h))


class _BatchNorm(nn.Module):
    """Inference BatchNorm: (h - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, h):
        return ((h - self.mean) / torch.sqrt(self.var + self.eps)
                * self.scale + self.bias)


def classifier_apply(model, x):
    return model(x)


FEATURE_MODES = ("power", "log-power")


def classifier_features(x, features="power", eps=1e-10):
    """Classifier input transform applied before standardization: 'power'
    (raw |X|^2, the reference protocol) or 'log-power' (ln(|X|^2 + eps))."""
    if features == "power":
        return x
    if features == "log-power":
        return torch.log(x + eps)
    raise ValueError(
        f"unknown feature mode {features!r}; valid: {FEATURE_MODES}")
