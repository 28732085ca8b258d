"""Frame-wise FFNN families as torch modules.

Counterpart of `guided_vae_nmf_tpu/models/nets.py`: the tanh encoder
(mu / log_var heads), the tanh^depth -> exp decoder, the M1 VAE, the guided
M2 deep generative model (label-concatenated encoder and decoder), the
sigmoid classifier with optional BatchNorm and its two-class softmax
variant, and the initialisers the trainer starts from.

Linear weights keep the reference layout (in, out) so a layer is
`x @ w + b`, as in the JAX package; :mod:`.convert` copies parameter trees
across unchanged. Sampling and initialisation take an explicit
`torch.Generator`. Every module is built frozen (`requires_grad=False`):
inference never records a graph, and the trainer turns gradients on for
the modules it trains.
"""

import math

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


def linear_init(layer, generator):
    """Xavier-normal weights (std sqrt(2 / (in + out)), gain 1) and zero
    bias, in place: the reference's init for every Linear. The draws come
    from `generator`, so their bits differ from the JAX package's."""
    n_in, n_out = layer.w.shape
    std = math.sqrt(2.0 / (n_in + n_out))
    with torch.no_grad():
        layer.w.copy_(std * torch.randn(n_in, n_out, generator=generator,
                                        device=layer.w.device))
        layer.b.zero_()
    return layer


def _init(model, generator):
    """Initialise every Linear of `model` in module order; frozen, eval."""
    for m in model.modules():
        if isinstance(m, Linear):
            linear_init(m, generator)
    return model.eval()


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

    def forward(self, x, generator=None, noise=None):
        """Returns (z, mu, log_var); z = mu when neither a generator nor
        `noise` (reparametrize's) is given."""
        h = x
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        mu = self.mu(h)
        log_var = self.log_var(h)
        if generator is None and noise is None:
            z = mu
        else:
            z = reparametrize(generator, mu, log_var, noise)
        return z, mu, log_var


def reparametrize(generator, mu, log_var, noise=None):
    """z = mu + exp(0.5*log_var) * eps, eps drawn from `generator`, or
    `noise` when given: standard-normal draws of mu's shape (the
    data-parallel trainer draws a whole batch's once and hands each shard
    its rows)."""
    eps = noise if noise is not None else torch.randn(
        mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
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

    def forward(self, x, generator=None, noise=None):
        z, mu, log_var = self.encoder(x, generator, noise)
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

    def forward(self, x, y, generator=None, noise=None):
        z, mu, log_var = self.encoder(torch.cat([x, y], dim=-1), generator,
                                      noise)
        r = self.decoder(torch.cat([z, y], dim=-1))
        return r, mu, log_var


def encoder_init(generator, x_dim, h_dim, z_dim):
    """An :class:`Encoder` with initialised weights (x_dim -> h_dim tanh
    stack -> mu / log_var heads of z_dim), in the JAX package's argument
    order; the draws come from `generator` in module order (the hidden
    layers, mu, log_var)."""
    return _init(Encoder(x_dim, h_dim, z_dim), generator)


def decoder_init(generator, z_dim, h_dim, x_dim):
    """A :class:`Decoder` with initialised weights (z_dim -> h_dim tanh
    stack -> exp of x_dim), in the JAX package's argument order; the draws
    come from `generator` in module order (the hidden layers, out)."""
    return _init(Decoder(z_dim, h_dim, x_dim), generator)


def vae_init(generator, dims):
    """M1 with initialised weights; dims = [x_dim, z_dim, h_dim]."""
    return _init(VAE(dims), generator)


def dgm_init(generator, dims):
    """M2 with initialised weights; dims = [x_dim, y_dim, z_dim, h_dim]."""
    return _init(DGM(dims), generator)


def vae_apply(model, x, generator=None, noise=None):
    return model(x, generator, noise)


def vae_sample(model, z):
    return model.decoder(z)


def dgm_apply(model, x, y, generator=None, noise=None):
    return model(x, y, generator, noise)


def dgm_sample(model, z, y):
    return model.decoder(torch.cat([z, y.to(z.dtype)], dim=-1))


class Classifier(nn.Module):
    """dims = [x_dim, h_dim, y_dim]: ReLU hidden layers (each optionally
    followed by BatchNorm), sigmoid output."""

    def __init__(self, dims, batch_norm=False):
        super().__init__()
        x_dim, h_dim, y_dim = dims
        self.hidden = _mlp([x_dim, *h_dim])
        self.out = Linear(h_dim[-1], y_dim)
        self.batch_norm = batch_norm
        if batch_norm:
            self.bn = nn.ModuleList(_BatchNorm(h) for h in h_dim)

    def logits(self, x, train=False):
        h = x
        for i, layer in enumerate(self.hidden):
            h = layer(h)
            if self.batch_norm:
                h = self.bn[i](h, train)
            h = torch.relu(h)
        return self.out(h)

    def forward(self, x, train=False):
        return torch.sigmoid(self.logits(x, train))


class Classifier2(Classifier):
    """Two-class softmax-per-bin variant: the output layer is 2 y_dim wide,
    reshaped to (batch, 2, y_dim) and softmaxed over the class axis."""

    def __init__(self, dims, batch_norm=False):
        x_dim, h_dim, y_dim = dims
        super().__init__([x_dim, h_dim, 2 * y_dim], batch_norm)
        self.y_dim = y_dim

    def forward(self, x, train=False):
        logits = self.logits(x, train).reshape(-1, 2, self.y_dim)
        return torch.softmax(logits, dim=1)


class _BatchNorm(nn.Module):
    """BatchNorm with scale, bias and the running mean / var as buffers:
    (h - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, h, train=False):
        return _bn_apply(self, h, train)


def _bn_apply(bn, h, train, momentum=0.1):
    """Normalise `h` with the running stats, or, with `train`, with the
    batch's mean and biased variance, updating the running stats in place
    ((1 - momentum) old + momentum batch), as the JAX package's `_bn_apply`
    returns them."""
    if train:
        mean = torch.mean(h, dim=0)
        var = torch.var(h, dim=0, unbiased=False)
        with torch.no_grad():
            bn.mean.copy_((1 - momentum) * bn.mean + momentum * mean)
            bn.var.copy_((1 - momentum) * bn.var + momentum * var)
    else:
        mean, var = bn.mean, bn.var
    return (h - mean) / torch.sqrt(var + bn.eps) * bn.scale + bn.bias


def classifier_init(generator, dims, batch_norm=False):
    """Classifier with initialised weights (BatchNorm: scale 1, bias 0,
    mean 0, var 1); dims = [x_dim, h_dim, y_dim]."""
    return _init(Classifier(dims, batch_norm), generator)


def classifier2_init(generator, dims, batch_norm=False):
    """Two-class softmax classifier with initialised weights."""
    return _init(Classifier2(dims, batch_norm), generator)


def classifier_apply(model, x, train=False):
    """Sigmoid output. With BatchNorm and `train`, normalises with the
    batch's statistics and updates the module's running stats in place
    (JAX returns them in a new tree)."""
    return model(x, train)


def classifier_apply_logits(model, x):
    """Pre-sigmoid logits, BatchNorm on its running stats: the input of
    the trainer's logits-form BCE."""
    return model.logits(x)


def classifier2_apply(model, x, train=False):
    """(batch, 2, y_dim) class probabilities. With `train`, the running
    stats update in place, as in :func:`classifier_apply` (JAX's
    `classifier2_apply` drops them)."""
    return model(x, train)


def count_parameters(model):
    """Total count of the trained values: parameters and BatchNorm
    buffers (the JAX tree's array leaves)."""
    return sum(t.numel() for t in model.state_dict().values())


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
