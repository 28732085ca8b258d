"""Log-density helpers.

Counterpart of `guided_vae_nmf_tpu/models/distributions.py` (reference
python/models/distributions.py:5-54), on tensors.
"""

import math

import torch


def prior_categorical(batch_size, y_dim):
    """Uniform categorical prior over y."""
    return torch.softmax(torch.ones(batch_size, y_dim), dim=1)


def log_standard_gaussian(x):
    """log N(x | 0, I), summed over the last axis."""
    return torch.sum(-0.5 * math.log(2 * math.pi) - x**2 / 2, dim=-1)


def log_gaussian(x, mu, log_var):
    """log N(x | mu, exp(log_var)), summed over the last axis."""
    log_pdf = (-0.5 * math.log(2 * math.pi) - log_var / 2
               - (x - mu) ** 2 / (2 * torch.exp(log_var)))
    return torch.sum(log_pdf, dim=-1)


def log_standard_categorical(p, eps):
    """Bernoulli-style cross-entropy of labels p against a uniform 0.5
    prior, summed over axis 1."""
    prior = 0.5 * torch.ones_like(p)
    return -torch.sum(p * torch.log(prior + eps)
                      + (1 - p) * torch.log(1 - prior + eps), dim=1)
