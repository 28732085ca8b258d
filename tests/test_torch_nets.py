"""Model forwards: the port against the JAX package on the six shipped
checkpoints, with the weights carried across by the converter.
Tolerance: rtol 1e-5 (float32 products summed in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.models import classifier_init, nets as jnets
from guided_vae_nmf_tpu.train import checkpoints as jckpt
from guided_vae_nmf_torch.models import (
    DGM,
    VAE,
    Classifier,
    classifier_features,
    dgm_sample,
    module_from_params,
    vae_sample,
)
from guided_vae_nmf_torch.train import checkpoints as tckpt

torch.set_num_threads(2)

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "pretrained")
CHECKPOINTS = {
    "M1": "vae", "M2_ibm": "dgm", "M2_vad": "dgm",
    "classifier_ibm": "classifier", "classifier_vad": "classifier",
    "wiener": "classifier",
}
RTOL = dict(rtol=1e-5, atol=1e-6)


def _load_both(name):
    kind = CHECKPOINTS[name]
    y_dim = 1 if name == "M2_vad" else 513
    path = os.path.join(ART, name)
    tree = jckpt.load_model(path, kind=kind, y_dim=y_dim)
    return tree, tckpt.load_model(path, kind=kind, y_dim=y_dim,
                                  device="cpu")


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_checkpoint_forward_matches_jax(name):
    tree, model = _load_both(name)
    rng = np.random.RandomState(0)
    # the converter and the loader build the same module
    via_tree = module_from_params(tree)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              via_tree.state_dict().items()):
        assert torch.equal(a, b), k
    if isinstance(model, Classifier):
        x = rng.randn(64, model.hidden[0].w.shape[0]).astype(np.float32)
        assert_allclose(model(torch.tensor(x)).numpy(),
                        np.asarray(jnets.classifier_apply(tree, x)), **RTOL)
        return
    x_dim = model.decoder.out.w.shape[1]
    x = rng.uniform(0.0, 2.0, (64, x_dim)).astype(np.float32)
    if isinstance(model, DGM):
        y = (rng.uniform(size=(64, model.y_dim)) > 0.5).astype(np.float32)
        xin = np.concatenate([x, y], axis=-1)
    else:
        xin = x
    z, mu, lv = model.encoder(torch.tensor(xin))
    zj, muj, lvj = jnets.encoder_apply(tree["encoder"], jnp.asarray(xin))
    for a, b in ((z, zj), (mu, muj), (lv, lvj)):
        assert_allclose(a.numpy(), np.asarray(b), **RTOL)
    zs = rng.randn(64, mu.shape[1]).astype(np.float32)
    if isinstance(model, DGM):
        got = dgm_sample(model, torch.tensor(zs), torch.tensor(y))
        ref = jnets.dgm_sample(tree, jnp.asarray(zs), jnp.asarray(y))
    else:
        assert isinstance(model, VAE)
        got = vae_sample(model, torch.tensor(zs))
        ref = jnets.vae_sample(tree, jnp.asarray(zs))
    assert_allclose(got.numpy(), np.asarray(ref), **RTOL)


def test_classifier_batch_norm_matches_jax():
    tree = classifier_init(jax.random.PRNGKey(3), [40, [16, 16], 7],
                           batch_norm=True)
    rng = np.random.RandomState(1)
    for bn in tree["bn"]:
        for k in ("scale", "bias", "mean"):
            bn[k] = jnp.asarray(rng.randn(16).astype(np.float32))
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    model = module_from_params(tree)
    assert model.batch_norm
    x = rng.randn(32, 40).astype(np.float32)
    assert_allclose(model(torch.tensor(x)).numpy(),
                    np.asarray(jnets.classifier_apply(tree, x)), **RTOL)


@pytest.mark.parametrize("features", ["power", "log-power"])
def test_classifier_features_match_jax(features):
    x = np.random.RandomState(2).uniform(0, 3, (8, 513)).astype(np.float32)
    assert_allclose(classifier_features(torch.tensor(x), features).numpy(),
                    np.asarray(jnets.classifier_features(jnp.asarray(x),
                                                         features)),
                    **RTOL)


def test_encoder_sample_uses_the_generator():
    _, model = _load_both("M1")
    x = torch.rand(4, 513)
    z1, mu, _ = model.encoder(x, torch.Generator().manual_seed(0))
    z2, _, _ = model.encoder(x, torch.Generator().manual_seed(0))
    assert torch.equal(z1, z2) and not torch.equal(z1, mu)


def test_checkpoint_side_cars_match_jax():
    cdir = os.path.join(ART, "classifier_ibm")
    for a, b in zip(tckpt.load_norm_stats(cdir), jckpt.load_norm_stats(cdir)):
        assert np.array_equal(a, b)
    assert tckpt.load_classifier_meta(cdir) == jckpt.load_classifier_meta(
        cdir)
    assert tckpt.load_norm_stats(os.path.join(ART, "M1")) == (None, None)
    assert tckpt.best_checkpoint(cdir) == jckpt.best_checkpoint(cdir)
