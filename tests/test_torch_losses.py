"""The port's losses, distributions and SVI machinery
(`guided_vae_nmf_torch/models/{losses,distributions,variational}.py`)
against the JAX package's, on the CPU.

Inputs come from a numpy seed at small widths (33 bins, z 4, hidden (16,
16), batch 32); modules carry the JAX initial weights across
(`module_from_params`). Where JAX samples z from a key, the same draws are
fed to the port by monkeypatching `models.nets.reparametrize`. Tolerance:
float32 values within rtol 1e-5 / atol 1e-5 of JAX's (a reduction over 33
bins and 32 rows in another order); the warm-up sequence and the one-hot
helpers are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.models import distributions as td
from guided_vae_nmf_torch.models import losses as tl
from guided_vae_nmf_torch.models import nets as tn
from guided_vae_nmf_torch.models import variational as tv
from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_tpu.models import distributions as jd
from guided_vae_nmf_tpu.models import losses as jl
from guided_vae_nmf_tpu.models import nets as jn
from guided_vae_nmf_tpu.models import variational as jv

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, F, Z, H = 32, 33, 4, (16, 16)


def close(got, ref, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64),
                               **(tol or TOL))


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return {
        "x": rng.gamma(1.0, 1.0, (B, F)).astype(np.float32),
        "r": rng.gamma(1.0, 1.0, (B, F)).astype(np.float32) + 0.05,
        "mu": rng.randn(B, Z).astype(np.float32),
        "logvar": (0.3 * rng.randn(B, Z)).astype(np.float32),
        "z": (3 * rng.randn(B, F)).astype(np.float32),
        "y": (rng.rand(B, F) > 0.6).astype(np.float32),
        "p": rng.uniform(0.01, 0.99, (B, F)).astype(np.float32),
        "s": (rng.randn(B, F) + 1j * rng.randn(B, F)).astype(np.complex64),
        "xc": (rng.randn(B, F) + 1j * rng.randn(B, F)).astype(np.complex64),
    }


def test_is_divergence_kl_and_elbo(data):
    d = data
    eps = 1e-8
    for name in ("ikatura_saito_divergence", "itakura_saito_divergence"):
        close(getattr(tl, name)(t(d["r"]), t(d["x"]), eps),
              getattr(jl, name)(d["r"], d["x"], eps))
    close(tl.kl_divergence(t(d["mu"]), t(d["logvar"])),
          jl.kl_divergence(d["mu"], d["logvar"]))
    for fn in ("elbo", "L_loss"):
        got = getattr(tl, fn)(t(d["x"]), t(d["r"]), t(d["mu"]),
                              t(d["logvar"]), eps)
        ref = getattr(jl, fn)(d["x"], d["r"], d["mu"], d["logvar"], eps)
        for g, r in zip(got, ref):
            close(g, r)


def test_u_loss(data):
    d = data
    y_dim, n = 3, 8
    rng = np.random.RandomState(1)
    x = rng.gamma(1.0, 1.0, (y_dim * n, F)).astype(np.float32)
    r = rng.gamma(1.0, 1.0, (y_dim * n, F)).astype(np.float32) + 0.05
    mu = rng.randn(y_dim * n, Z).astype(np.float32)
    lv = (0.3 * rng.randn(y_dim * n, Z)).astype(np.float32)
    soft = rng.uniform(0.05, 0.95, (n, y_dim)).astype(np.float32)
    got = tl.U_loss(t(x), t(r), t(mu), t(lv), t(soft), 1e-8)
    ref = jl.U_loss(x, r, mu, lv, soft, 1e-8)
    for g, rr in zip(got, ref):
        close(g, rr)


@pytest.mark.parametrize("pos_weight", [None, 3.5])
def test_bce_logits_and_its_gradient(data, pos_weight):
    d = data
    z = t(d["z"]).requires_grad_(True)
    got = tl.binary_cross_entropy_logits(z, t(d["y"]), pos_weight)
    got.backward()
    ref, gref = jax.value_and_grad(
        lambda zz: jl.binary_cross_entropy_logits(zz, d["y"], pos_weight))(
            jnp.asarray(d["z"]))
    close(got, ref)
    close(z.grad, gref)


def test_bce_forms_and_mask_losses(data):
    d = data
    eps = 1e-8
    close(tl.binary_cross_entropy(t(d["p"]), t(d["y"]), eps),
          jl.binary_cross_entropy(d["p"], d["y"], eps))
    close(tl.binary_cross_entropy_2classes(t(d["p"]), t(1 - d["p"]),
                                           t(d["y"]), eps),
          jl.binary_cross_entropy_2classes(d["p"], 1 - d["p"], d["y"], eps))
    close(tl.mean_square_error_mask(t(d["y"]), t(d["p"])),
          jl.mean_square_error_mask(d["y"], d["p"]))
    close(tl.mean_square_error_signal(t(d["x"]), t(d["y"]), t(d["p"])),
          jl.mean_square_error_signal(d["x"], d["y"], d["p"]))
    close(tl.magnitude_spectrum_approximation_loss(
        t(d["xc"]), t(d["s"]), t(d["p"])),
        jl.magnitude_spectrum_approximation_loss(d["xc"], d["s"], d["p"]))


def test_log_sum_exp_enumerate_onehot(data):
    a = data["z"]
    close(tl.log_sum_exp(t(a), axis=1), jl.log_sum_exp(a, axis=1))
    close(tl.log_sum_exp(t(a), axis=0, sum_op=torch.mean),
          jl.log_sum_exp(a, axis=0, sum_op=jnp.mean))
    assert np.array_equal(tl.enumerate_discrete(5, 3).numpy(),
                          np.asarray(jl.enumerate_discrete(5, 3)))
    for k, label in ((4, 0), (4, 3), (7, 5)):
        assert np.array_equal(tl.onehot(k, label).numpy(),
                              np.asarray(jl.onehot(k, label)))


def test_distributions(data):
    d = data
    assert np.array_equal(td.prior_categorical(5, 3).numpy(),
                          np.asarray(jd.prior_categorical(5, 3)))
    close(td.log_standard_gaussian(t(d["mu"])),
          jd.log_standard_gaussian(d["mu"]))
    close(td.log_gaussian(t(d["mu"]), t(d["mu"][::-1].copy()),
                          t(d["logvar"])),
          jd.log_gaussian(d["mu"], d["mu"][::-1], d["logvar"]))
    close(td.log_standard_categorical(t(d["p"]), 1e-8),
          jd.log_standard_categorical(d["p"], 1e-8))


def test_importance_weighted_sampler_and_warmup(data):
    x = data["x"][:5]
    for mc, iw in ((1, 1), (2, 3)):
        jw, tw = jv.ImportanceWeightedSampler(mc, iw), \
            tv.ImportanceWeightedSampler(mc, iw)
        assert np.array_equal(tw.resample(t(x)).numpy(),
                              np.asarray(jw.resample(x)))
        e = np.random.RandomState(mc).randn(mc * iw * 7).astype(np.float32)
        close(tw(t(e)), jw(e))
    jw, tw = jv.DeterministicWarmup(n=7, t_max=0.6), \
        tv.DeterministicWarmup(n=7, t_max=0.6)
    assert [next(tw) for _ in range(10)] == [next(jw) for _ in range(10)]
    assert list(zip(range(3), tv.DeterministicWarmup(n=2))) == \
        list(zip(range(3), jv.DeterministicWarmup(n=2)))


def inject(monkeypatch, draws):
    """Feed `draws` (numpy arrays, in call order) to the port's
    reparametrisation instead of its generator's."""
    queue = list(draws)

    def fake(generator, mu, log_var, noise=None):
        assert noise is None
        eps = torch.from_numpy(np.array(queue.pop(0))).to(mu)
        assert eps.shape == mu.shape
        return mu + torch.exp(0.5 * log_var) * eps

    monkeypatch.setattr(tn, "reparametrize", fake)
    return queue


def test_svi_m1(data, monkeypatch):
    params = jn.vae_init(jax.random.PRNGKey(3), [F, Z, list(H)])
    x = data["p"]
    key = jax.random.PRNGKey(4)
    ref = jv.svi_m1(params, x, key)
    inject(monkeypatch, [jax.random.normal(key, (B, Z))])
    got = tv.svi_m1(module_from_params(params), t(x), torch.Generator())
    for g, r in zip(got, ref):
        close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("labelled", [True, False])
def test_svi_m2_both_branches(data, monkeypatch, labelled):
    y_dim, n = 4, 8
    params = jn.dgm_init(jax.random.PRNGKey(5), [F, y_dim, Z, list(H)])
    cls = jn.classifier_init(jax.random.PRNGKey(6), [F, list(H), y_dim])
    x = data["p"][:n]
    y = data["y"][:n, :y_dim] if labelled else None
    key = jax.random.PRNGKey(7)
    ref = jv.svi(params, x, key, y=y, classifier_params=cls)
    rows = n if labelled else n * y_dim
    inject(monkeypatch, [jax.random.normal(key, (rows, Z))])
    got = tv.svi(module_from_params(params), t(x), torch.Generator(),
                 y=None if y is None else t(y),
                 classifier=module_from_params(cls))
    if labelled:
        for g, r in zip(got, ref):
            close(g, r, rtol=1e-4, atol=1e-4)
    else:
        close(got, ref, rtol=1e-4, atol=1e-4)
