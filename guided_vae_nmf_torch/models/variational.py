"""Semi-supervised SVI machinery.

Counterpart of `guided_vae_nmf_tpu/models/variational.py` (reference
python/models/variational.py:10-165): the importance-weighted ELBO reducer,
the linear KL warm-up, and the SVI objectives of M1 and M2 over the port's
modules. A `generator` draws the reparametrisation noise (None: z = mu).
"""

import torch

from .distributions import log_standard_categorical
from .losses import (binary_cross_entropy, enumerate_discrete, kl_divergence,
                     log_sum_exp)
from .nets import classifier_apply, dgm_apply, vae_apply


class ImportanceWeightedSampler:
    """Importance-weighted ELBO reducer [Burda 2015]."""

    def __init__(self, mc=1, iw=1):
        self.mc = mc
        self.iw = iw

    def resample(self, x):
        return x.repeat(self.mc * self.iw, 1)

    def __call__(self, elbo):
        elbo = elbo.reshape(self.mc, self.iw, -1)
        elbo = torch.mean(log_sum_exp(elbo, axis=1, sum_op=torch.mean),
                          dim=0)
        return elbo.reshape(-1)


class DeterministicWarmup:
    """Linear KL warm-up [Sønderby 2016]: 1/n, 2/n, ... capped at t_max."""

    def __init__(self, n=100, t_max=1):
        self.t = 0.0
        self.t_max = t_max
        self.inc = 1.0 / n

    def __iter__(self):
        return self

    def __next__(self):
        t = self.t + self.inc
        self.t = self.t_max if t > self.t_max else t
        return self.t


def svi_m1(model, x, generator=None, likelihood=binary_cross_entropy,
           eps=1e-8):
    """SVI objective of M1: [loss, -likelihood, KL] as batch means."""
    r, mu, logvar = vae_apply(model, x, generator)
    lik = -likelihood(r, x, eps)
    kl = kl_divergence(mu, logvar)
    L = lik - kl
    return [-torch.mean(L), -torch.mean(lik), torch.mean(kl)]


def svi(model, x, generator=None, y=None, classifier=None,
        likelihood=binary_cross_entropy, eps=1e-8):
    """Semi-supervised SVI objective of M2. Labelled (`y` given): [loss,
    -lik, -prior, KL]. Unlabelled: every one-hot label is enumerated, each
    label's -L(x, y) weighted by the `classifier`'s posterior, plus its
    entropy; returns the mean U(x)."""
    if y is not None:
        xs, ys = x, y
    else:
        ys = enumerate_discrete(x.shape[0], model.y_dim).to(x)
        xs = x.repeat(model.y_dim, 1)

    r, mu, logvar = dgm_apply(model, xs, ys, generator)
    lik = -likelihood(r, xs, eps)
    prior = -log_standard_categorical(ys, eps)
    kl = kl_divergence(mu, logvar)
    elbo_val = lik + prior - kl

    if y is not None:
        return [-torch.mean(elbo_val), -torch.mean(lik), -torch.mean(prior),
                torch.mean(kl)]

    logits = classifier_apply(classifier, x)
    L = elbo_val.reshape(logits.T.shape).T
    H = -torch.sum(logits * torch.log(logits + 1e-8), dim=-1)
    L = torch.sum(logits * L, dim=-1)
    return torch.mean(L + H)
