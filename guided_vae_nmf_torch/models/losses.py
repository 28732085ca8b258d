"""Losses and classification scores.

Counterpart of `guided_vae_nmf_tpu/models/losses.py` (reference
python/models/utils.py:44-145), on tensors: the Itakura-Saito-divergence
ELBO of M1 / M2 training and its per-sample L / U semi-supervised forms,
BCE (also from logits, with an optional positive-class weight), the
mask-MSE losses, the magnitude-spectrum approximation loss, and the
tp / tn / fp / fn F1 score.
"""

import torch


def ikatura_saito_divergence(r, x, eps):
    """Per-sample IS divergence summed over bins: sum(x/r - log(x+eps)
    + log(r) - 1) (the reference keeps the original author's spelling)."""
    return torch.sum(x / r - torch.log(x + eps) + torch.log(r) - 1.0,
                     dim=-1)


itakura_saito_divergence = ikatura_saito_divergence  # corrected spelling


def kl_divergence(mu, logvar):
    """Analytic KL(q(z|x) || N(0, I)) per sample."""
    return -0.5 * torch.sum(logvar - mu**2 - torch.exp(logvar), dim=-1)


def elbo(x, r, mu, logvar, eps):
    """Negative ELBO = batch-mean IS reconstruction + batch-mean analytic
    KL. Returns (loss, recon, KL)."""
    recon = torch.mean(ikatura_saito_divergence(r, x, eps))
    KL = torch.mean(kl_divergence(mu, logvar))
    return recon + KL, recon, KL


def L_loss(x, r, mu, logvar, eps):
    """Per-sample labelled loss L(x, y). Returns (L, recon, KL)."""
    recon = ikatura_saito_divergence(r, x, eps)
    KL = kl_divergence(mu, logvar)
    return recon + KL, recon, KL


def U_loss(x, r, mu, logvar, y_hat_soft, eps):
    """Unlabelled semi-supervised loss U(x) with the classifier's entropy.
    Returns (U, mean L, mean recon, mean KL)."""
    recon = ikatura_saito_divergence(r, x, eps)
    KL = kl_divergence(mu, logvar)
    L = recon + KL
    L = L.reshape(y_hat_soft.T.shape).T
    H = (-y_hat_soft * torch.log(y_hat_soft + eps)
         - (1 - y_hat_soft) * torch.log(1 - y_hat_soft + eps))
    L_soft = torch.sum(y_hat_soft * L, dim=-1)
    U = torch.mean(L_soft - H[:, 0])
    return U, torch.mean(L), torch.mean(recon), torch.mean(KL)


def binary_cross_entropy(r, x, eps):
    """Sum over bins, mean over batch."""
    return -torch.mean(torch.sum(
        x * torch.log(r + eps) + (1 - x) * torch.log(1 - r + eps), dim=-1))


def binary_cross_entropy_logits(z, x, pos_weight=None):
    """BCE from logits, sum over bins, mean over batch: the objective of
    :func:`binary_cross_entropy` on sigmoid(z) (up to its eps), with
    bounded gradients where sigmoids saturate. `pos_weight` multiplies the
    positive-class term (None: the unweighted objective)."""
    if pos_weight is None:
        per = (torch.clamp(z, min=0.0) - z * x
               + torch.log1p(torch.exp(-torch.abs(z))))
        return torch.mean(torch.sum(per, dim=-1))
    zero = torch.zeros_like(z)
    log_sig = -torch.logaddexp(zero, -z)
    log_1m = -torch.logaddexp(zero, z)
    per = -(pos_weight * x * log_sig + (1.0 - x) * log_1m)
    return torch.mean(torch.sum(per, dim=-1))


def binary_cross_entropy_2classes(r1, r2, x, eps):
    """Two-head BCE of the softmax classifier."""
    return -torch.mean(torch.sum(
        x * torch.log(r1 + eps) + (1 - x) * torch.log(r2 + eps), dim=-1))


def mean_square_error_mask(y, y_hat):
    """Mask-domain MSE, summed over bins, mean over batch: the Wiener-DNN
    baseline's loss."""
    return torch.mean(torch.sum((y - y_hat) ** 2, dim=-1))


def mean_square_error_signal(x, y, y_hat):
    """Signal-weighted mask MSE."""
    return torch.mean(torch.sum(((y - y_hat) * x) ** 2, dim=-1))


def magnitude_spectrum_approximation_loss(x, s, y_hat):
    """MSA loss |s - y_hat x|^2 (complex inputs allowed)."""
    d = s - y_hat * x
    return torch.mean(torch.sum(torch.real(d * torch.conj(d)), dim=-1))


def f1_loss(y_hat_hard, y, epsilon=1e-8):
    """(accuracy, precision, recall, F1) as float32 scalar tensors, from
    tp / tn / fp / fn over flattened binary predictions. Takes tensors or
    numpy arrays and computes in float32, as the JAX package does."""
    y_pred = torch.as_tensor(y_hat_hard).to(torch.float32)
    y_true = torch.as_tensor(y).to(torch.float32)
    tp = torch.sum(y_true * y_pred)
    tn = torch.sum((1 - y_true) * (1 - y_pred))
    fp = torch.sum((1 - y_true) * y_pred)
    fn = torch.sum(y_true * (1 - y_pred))
    accuracy = (tp + tn) / (tp + tn + fp + fn + epsilon)
    precision = tp / (tp + fp + epsilon)
    recall = tp / (tp + fn + epsilon)
    f1 = 2 * precision * recall / (precision + recall + epsilon)
    return accuracy, precision, recall, f1


def log_sum_exp(tensor, axis=-1, sum_op=torch.sum):
    """Numerically stable LSE with a pluggable reduction (`sum_op` takes
    `dim=` and `keepdim=`, as torch.sum and torch.mean do)."""
    m = torch.amax(tensor, dim=axis, keepdim=True)
    return torch.log(sum_op(torch.exp(tensor - m), dim=axis, keepdim=True)
                     + 1e-8) + m


def enumerate_discrete(batch_size, y_dim):
    """All one-hot labels tiled over the batch: (y_dim * batch_size,
    y_dim), label-major."""
    return torch.repeat_interleave(torch.eye(y_dim), batch_size, dim=0)


def onehot(k, label):
    """1-of-k encoding."""
    return (torch.arange(k) == label).to(torch.float32)
