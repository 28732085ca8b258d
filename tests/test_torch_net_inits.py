"""`encoder_init` / `decoder_init`: the port's standalone encoder and
decoder constructors against the JAX package's (`models/nets.py`).

The two draw their weights from different generators, so the bits differ;
the tests hold what the reference's init fixes: the module's shapes (the
parameter tree's, leaf by leaf, with the JAX argument order), Xavier-normal
weights (mean 0, std sqrt(2 / (in + out)), checked on each weight matrix to
within 5 standard errors of the estimate) and zero biases; that
`dgm_init`'s draws are the ones they were before the constructors existed
(its modules built and initialised in the same order); and that JAX-built
parameters carried across by `module_from_params` compute JAX's encode /
decode (rtol 1e-5, float32 products summed in another order)."""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_tpu.models import nets as jnets
from guided_vae_nmf_torch.models import (
    DGM,
    Decoder,
    Encoder,
    decoder_init,
    dgm_init,
    encoder_init,
    module_from_params,
    params_from_module,
)
from guided_vae_nmf_torch.models.nets import _init

torch.set_num_threads(2)

RTOL = dict(rtol=1e-5, atol=1e-6)
# (x_dim, h_dim, z_dim) of an encoder; a decoder takes (z_dim, h_dim, x_dim)
CASES = [(513, [128, 128], 32), (65, [40, 24], 8), (200, [300], 16)]


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _held_to_xavier(tree):
    """Every Linear of a parameter tree: zero bias, weights of mean 0 and
    std sqrt(2 / (in + out)) within 5 standard errors."""
    layers = []

    def walk(node):
        if isinstance(node, dict) and "w" in node:
            layers.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    assert layers
    for layer in layers:
        w, b = np.asarray(layer["w"], np.float64), np.asarray(layer["b"])
        n_in, n_out = w.shape
        std = np.sqrt(2.0 / (n_in + n_out))
        n = w.size
        assert not b.any()
        assert abs(w.mean()) < 5 * std / np.sqrt(n)
        assert abs(w.std() / std - 1) < 5 / np.sqrt(2 * n)


@pytest.mark.parametrize("x_dim,h_dim,z_dim", CASES,
                         ids=[f"x{c[0]}-z{c[2]}" for c in CASES])
def test_encoder_init_matches_jax(x_dim, h_dim, z_dim):
    """The encoder's parameter tree has JAX's shapes leaf by leaf and both
    hold the reference's init statistics."""
    want = jnets.encoder_init(jax.random.PRNGKey(x_dim), x_dim, h_dim, z_dim)
    enc = encoder_init(torch.Generator().manual_seed(x_dim), x_dim, h_dim,
                       z_dim)
    assert isinstance(enc, Encoder) and not enc.training
    assert all(not p.requires_grad for p in enc.parameters())
    got = params_from_module(enc)
    assert _shapes(got) == _shapes(want)
    _held_to_xavier(got)
    _held_to_xavier(want)


@pytest.mark.parametrize("x_dim,h_dim,z_dim", CASES,
                         ids=[f"x{c[0]}-z{c[2]}" for c in CASES])
def test_decoder_init_matches_jax(x_dim, h_dim, z_dim):
    """The decoder (z_dim -> h_dim -> x_dim, JAX's argument order) has
    JAX's shapes leaf by leaf and both hold the reference's init
    statistics."""
    want = jnets.decoder_init(jax.random.PRNGKey(z_dim), z_dim, h_dim, x_dim)
    dec = decoder_init(torch.Generator().manual_seed(z_dim), z_dim, h_dim,
                       x_dim)
    assert isinstance(dec, Decoder) and not dec.training
    got = params_from_module(dec)
    assert _shapes(got) == _shapes(want)
    _held_to_xavier(got)
    _held_to_xavier(want)


def test_dgm_init_draws_are_unchanged():
    """dgm_init draws what it drew before the constructors existed: its
    modules initialised in module order from one generator."""
    dims = [65, 10, 8, [40, 24]]
    got = dgm_init(torch.Generator().manual_seed(3), dims)
    want = _init(DGM(dims), torch.Generator().manual_seed(3))
    for (ka, a), (kb, b) in zip(got.state_dict().items(),
                                want.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


@pytest.mark.parametrize("x_dim,h_dim,z_dim", CASES,
                         ids=[f"x{c[0]}-z{c[2]}" for c in CASES])
def test_jax_built_encoder_and_decoder_compute_jax_outputs(x_dim, h_dim,
                                                           z_dim):
    """JAX's encoder_init / decoder_init trees carried across by
    module_from_params (the decoder's with kind="decoder") encode and
    decode as JAX's encoder_apply / decoder_apply do; the trees go back
    unchanged."""
    k_enc, k_dec = jax.random.split(jax.random.PRNGKey(7 + z_dim))
    etree = jnets.encoder_init(k_enc, x_dim, h_dim, z_dim)
    dtree = jnets.decoder_init(k_dec, z_dim, h_dim[::-1], x_dim)
    enc = module_from_params(etree)
    dec = module_from_params(dtree, kind="decoder")
    assert isinstance(enc, Encoder) and isinstance(dec, Decoder)
    rng = np.random.RandomState(z_dim)
    x = rng.uniform(0.0, 2.0, (16, x_dim)).astype(np.float32)
    z = rng.randn(16, z_dim).astype(np.float32)
    want = jnets.encoder_apply(etree, x)
    got = enc(torch.tensor(x))
    for a, b in zip(got, want):
        assert_allclose(a.numpy(), np.asarray(b), **RTOL)
    assert_allclose(dec(torch.tensor(z)).numpy(),
                    np.asarray(jnets.decoder_apply(dtree, z)), **RTOL)
    for tree, mod in ((etree, enc), (dtree, dec)):
        back = params_from_module(mod)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)))
    with pytest.raises(ValueError, match="kind"):
        module_from_params(dtree, kind="encoder")
