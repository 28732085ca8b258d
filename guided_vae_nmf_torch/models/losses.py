"""Classification scores.

Counterpart of `guided_vae_nmf_tpu/models/losses.py`. Only :func:`f1_loss`
(the mask F1 of the metric sweep, reference python/models/utils.py:106-145)
is here; the training losses (the Itakura-Saito ELBO and its L/U forms,
BCE, the mask-MSE losses) come with the training slice (ROADMAP Queue 1,
item 4).
"""

import torch


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
