"""Helpers of the training tests (tests/test_torch_train.py,
test_torch_h5io.py, test_torch_cli.py, test_torch_scripts.py,
test_torch_synthesis.py): JAX's reparametrisation draws in the order the
trainer takes them, their injection into the port, the JAX initialisers
behind the port's front doors, the JAX package's test-set synthesis with
its pool made serial, and the comparison of two model directories."""

import os
import re

import jax
import numpy as np
import torch

from guided_vae_nmf_torch.models import module_from_params
from guided_vae_nmf_torch.models import nets as t_nets
from guided_vae_nmf_torch.train import trainer as t_trainer
from guided_vae_nmf_tpu.models import nets as j_nets


def draws_epoch(seed, epochs, nb_tr, bs, nb_va, bs_va, z_dim, first=1):
    """JAX fit's draws on its device-resident path, epochs `first`..
    `epochs` of a fresh run: each epoch splits (key, k_tr, k_va), each
    training batch takes one key of split(k_tr, nb_tr) and each validation
    batch one of split(k_va, nb_va)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for epoch in range(1, epochs + 1):
        key, k_tr, k_va = jax.random.split(key, 3)
        if epoch < first:
            continue
        out += [jax.random.normal(k, (bs, z_dim))
                for k in jax.random.split(k_tr, nb_tr)]
        out += [jax.random.normal(k, (bs_va, z_dim))
                for k in jax.random.split(k_va, nb_va)]
    return out


def draws_small(seed, epochs, nb_va, bs, z_dim):
    """JAX fit's draws on its small-set path (no training batch): one
    `key, sub = split(key)` per validation batch."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs * nb_va):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, (bs, z_dim)))
    return out


def inject(monkeypatch, draws):
    """Feed `draws` (in call order) to the port's reparametrisation in
    place of its generator's; returns the queue (empty once all taken)."""
    queue = [np.array(d) for d in draws]

    def fake(generator, mu, log_var, noise=None):
        assert noise is None
        eps = torch.from_numpy(queue.pop(0)).to(mu)
        assert eps.shape == mu.shape
        return mu + torch.exp(0.5 * log_var) * eps

    monkeypatch.setattr(t_nets, "reparametrize", fake)
    return queue


def jax_init(monkeypatch):
    """The port's front doors start from the JAX package's initial
    weights for `PRNGKey(cfg.seed)`: their initialisers take the seed from
    the generator's `initial_seed()`."""
    def wrap(j_init):
        def init(generator, dims, *a):
            tree = j_init(jax.random.PRNGKey(generator.initial_seed()),
                          dims, *a)
            return module_from_params(tree)
        return init

    for name in ("vae_init", "dgm_init", "classifier_init"):
        monkeypatch.setattr(t_trainer, name, wrap(getattr(j_nets, name)))


def serial_jax_pool(monkeypatch):
    """Make the JAX package's test-mixture pool serial. Its workers draw
    each utterance's noise window from numpy's global RNG, so with more
    than one thread the window an utterance gets follows the scheduling;
    with one thread the draws run in file order, the order the port draws
    them in before its pool."""
    from concurrent.futures import ThreadPoolExecutor

    import guided_vae_nmf_tpu.data.synthesis as j_synthesis

    monkeypatch.setattr(j_synthesis, "ThreadPoolExecutor",
                        lambda max_workers=None: ThreadPoolExecutor(1))


_NUM = re.compile(r"-?\d+\.\d+")


def log_lines(path):
    """(text with numbers blanked and times dropped, numbers) per line."""
    out = []
    with open(path) as f:
        for line in f:
            line = re.sub(r" time: \S+s$", "", line.rstrip("\n"))
            out.append((_NUM.sub("#", line),
                        [float(v) for v in _NUM.findall(line)]))
    return out


_VLOSS = re.compile(r"_vloss_([-\d.]+)\.ckpt\.npz$")


def _by_epoch(d):
    """{file name with the vloss blanked: (file name, vloss or None)}."""
    out = {}
    for name in os.listdir(d):
        m = _VLOSS.search(name)
        out[_VLOSS.sub("_vloss_#.ckpt.npz", name)] = (
            name, float(m.group(1)) if m else None)
    return out


def compare_dirs(jdir, pdir, rtol, atol, arrays=None, moments=True):
    """Two model directories hold the same files, the same log lines (text
    equal, numbers within the tolerance, times dropped) and the same
    arrays within the tolerance (the Adam count exactly). Checkpoint names
    are equal but for the 2-decimal vloss, which may round the other way
    where the two losses straddle a rounding boundary: it agrees within
    0.01 + rtol |vloss|. `arrays` (dict of rtol, atol) overrides the
    tolerance of the checkpoints' and resume states' arrays; with
    `moments=False` the Adam moments are left out (the count stays)."""
    arrays = arrays or dict(rtol=rtol, atol=atol)
    fj, fp = _by_epoch(jdir), _by_epoch(pdir)
    assert sorted(fj) == sorted(fp)
    for key in sorted(fj):
        name, vj = fj[key]
        a, b = os.path.join(jdir, name), os.path.join(pdir, fp[key][0])
        if vj is not None:
            assert abs(vj - fp[key][1]) <= 0.01 + rtol * abs(vj) + 1e-9, \
                (name, fp[key][0])
        if name.endswith(".log"):
            la, lb = log_lines(a), log_lines(b)
            assert [t for t, _ in la] == [t for t, _ in lb], name
            for (_, va), (_, vb) in zip(la, lb):
                np.testing.assert_allclose(vb, va, rtol=rtol, atol=atol)
        elif name.endswith(".npz"):
            with np.load(a) as fa, np.load(b) as fb:
                assert sorted(fa.files) == sorted(fb.files), name
                for k in fa.files:
                    assert fa[k].shape == fb[k].shape, (name, k)
                    if k.startswith("o.") and k != "o.0" and not moments:
                        continue
                    if k in ("o.0", "__epoch"):
                        assert int(fa[k]) == int(fb[k]), (name, k)
                        assert fa[k].dtype == fb[k].dtype, (name, k)
                    else:
                        np.testing.assert_allclose(
                            fb[k], fa[k], err_msg=f"{name}:{k}", **arrays)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        elif name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
