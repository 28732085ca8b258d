"""The port's training slice (`guided_vae_nmf_torch/train/trainer.py`,
`train/checkpoints.py`'s writing half, `models/nets.py`'s training side,
`models/convert.py::params_from_module`) against the JAX package's, on the
CPU.

Small widths: 33 bins, hidden (16, 16), z 4, batch 32, 320 training and
100 validation frames (10 and 3 batches), from a numpy seed. Every fit
starts from the JAX package's initial tree (carried across, or the JAX
initialiser behind the port's front doors); M1 / M2 fits take JAX's
reparametrisation draws, reproduced from its key chain and injected into
`models.nets.reparametrize`. Tolerances, measured and stated:

- a loss, one Adam step: rtol 1e-5, atol 1e-6; gradients: rtol 1e-4,
  atol 1e-5;
- whole fits over 3 epochs, all four families (log numbers, checkpoints,
  resume state): rtol 1e-4, atol 1e-5 (measured: losses at most 6e-7
  apart relative, arrays 7.8e-7 (classifier), 3.0e-7 (Wiener), 1.1e-6
  (M1) and 1.8e-6 (M2) absolute; the small-set path's arrays equal).

Names of files, log text and the Adam step count are equal."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from guided_vae_nmf_torch import models as tm
from guided_vae_nmf_torch.models import nets as tn
from guided_vae_nmf_torch.train import checkpoints as tc
from guided_vae_nmf_torch.train import trainer as tt
from guided_vae_nmf_tpu import models as jm
from guided_vae_nmf_tpu.train import checkpoints as jc
from guided_vae_nmf_tpu.train import trainer as jt
from test_torch_train_helpers import (compare_dirs, draws_epoch, draws_small,
                                 inject, jax_init)

torch.set_num_threads(2)

F, Z, H, BS = 33, 4, (16, 16), 32
N_TR, N_VA = 320, 100
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)


def jcfg(epochs=3, **kw):
    return jt.TrainConfig(batch_size=BS, end_epoch=epochs, **kw)


def pcfg(epochs=3, **kw):
    return tt.TrainConfig(batch_size=BS, end_epoch=epochs, **kw)


def host(tree):
    """A JAX tree with numpy leaves (static leaves kept)."""
    return jax.tree.map(lambda v: np.asarray(v) if hasattr(v, "shape")
                        else v, tree)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)

    def power(n):
        return (rng.gamma(0.7, 1.0, (n, F)) + 1e-3).astype(np.float32)

    Xtr, Xva = power(N_TR), power(N_VA)
    return {
        "Xtr": Xtr, "Xva": Xva,
        "Ytr": (Xtr > 0.8).astype(np.float32),
        "Yva": (Xva > 0.8).astype(np.float32),
        "Mtr": rng.uniform(0, 1, (N_TR, F)).astype(np.float32),
        "Mva": rng.uniform(0, 1, (N_VA, F)).astype(np.float32),
        "Str": ((Xtr - Xtr.mean(0)) / Xtr.std(0)).astype(np.float32),
        "Sva": ((Xva - Xtr.mean(0)) / Xtr.std(0)).astype(np.float32),
    }


def family_data(frames, family, small=False):
    f = frames
    n_tr = 20 if small else N_TR
    if family == "m1":
        tr, va = (f["Xtr"], None), (f["Xva"], None)
    elif family == "m2":
        tr, va = (f["Xtr"], f["Ytr"]), (f["Xva"], f["Yva"])
    elif family == "classifier":
        tr, va = (f["Str"], f["Ytr"]), (f["Sva"], f["Yva"])
    else:
        tr, va = (f["Str"], f["Mtr"]), (f["Sva"], f["Mva"])
    tr = (tr[0][:n_tr], None if tr[1] is None else tr[1][:n_tr])
    return tr, va


def jax_tree(family, seed=1, batch_norm=False):
    key = jax.random.PRNGKey(seed)
    if family == "m1":
        return jm.vae_init(key, [F, Z, list(H)])
    if family == "m2":
        return jm.dgm_init(key, [F, F, Z, list(H)])
    if family == "classifier":
        return jm.classifier_init(key, [F, list(H), F], batch_norm)
    return jm.classifier_init(key, [F, [16, 16, 16], F])


# ---------------------------------------------------------------------------
# nets, convert
# ---------------------------------------------------------------------------

def test_initialisers_are_xavier_normal_frozen_and_seeded():
    g = torch.Generator().manual_seed(0)
    m = tm.dgm_init(g, [513, 513, 32, [128, 128]])
    w = m.encoder.hidden[0].w
    assert w.shape == (1026, 128) and not w.requires_grad
    np.testing.assert_allclose(float(w.std()), np.sqrt(2 / (1026 + 128)),
                               rtol=0.02)
    assert all(float(lin.b.abs().max()) == 0 for lin in m.modules()
               if isinstance(lin, tn.Linear))
    again = tm.dgm_init(torch.Generator().manual_seed(0),
                        [513, 513, 32, [128, 128]])
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))
    assert not m.training
    for init, dims in ((tm.vae_init, [33, 4, [16]]),
                       (tm.classifier_init, [33, [16, 16], 33]),
                       (tm.classifier2_init, [33, [16], 5])):
        mod = init(torch.Generator().manual_seed(1), dims)
        assert not any(p.requires_grad for p in mod.parameters())


@pytest.mark.parametrize("batch_norm", [False, True])
def test_params_round_trip_and_count(batch_norm):
    for tree in (jax_tree("m1"), jax_tree("m2"),
                 jax_tree("classifier", batch_norm=batch_norm),
                 jm.classifier2_init(jax.random.PRNGKey(2), [F, list(H), 5],
                                     batch_norm)):
        back = tm.params_from_module(tm.module_from_params(host(tree)))
        flat_j = jc._flatten(jc._strip_static(tree))
        flat_p = jc._flatten(jc._strip_static(back))
        assert sorted(flat_j) == sorted(flat_p)
        for k in flat_j:
            assert np.array_equal(flat_j[k], flat_p[k]), k
        assert {k: v for k, v in back.items()
                if k in ("y_dim", "batch_norm")} == \
            {k: v for k, v in tree.items() if k in ("y_dim", "batch_norm")}
        assert tm.count_parameters(tm.module_from_params(host(tree))) == \
            jm.count_parameters(tree)


def test_classifier_logits_batch_norm_and_classifier2(frames):
    x = frames["Sva"]
    tree = jax_tree("classifier", batch_norm=True)
    rng = np.random.RandomState(3)
    for bn in tree["bn"]:   # running stats away from (0, 1)
        bn["mean"] = jnp.asarray(0.1 * rng.randn(*bn["mean"].shape),
                                 jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2, bn["var"].shape),
                                jnp.float32)
    m = tm.module_from_params(host(tree))
    np.testing.assert_allclose(
        tm.classifier_apply_logits(m, torch.from_numpy(x)).numpy(),
        jm.classifier_apply_logits(tree, x), **STEP_TOL)
    y, new = jm.classifier_apply(tree, x, train=True)
    got = tm.classifier_apply(m, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), y, **STEP_TOL)
    for i, bn in enumerate(new["bn"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(m.bn[i], k).numpy(), bn[k],
                                       **STEP_TOL)
    t2 = jm.classifier2_init(jax.random.PRNGKey(4), [F, list(H), 5])
    np.testing.assert_allclose(
        tm.classifier2_apply(tm.module_from_params(host(t2)),
                             torch.from_numpy(x)).numpy(),
        jm.classifier2_apply(t2, x), **STEP_TOL)


# ---------------------------------------------------------------------------
# losses and gradients, one Adam step
# ---------------------------------------------------------------------------

def _grads(family, tree, batch, draw, pos_weight=None, monkeypatch=None):
    """(loss, {path: grad}) of the port and of JAX for one batch."""
    key = jax.random.PRNGKey(9)
    j_loss = jt.LOSSES[family]
    t_loss = tt.LOSSES[family]
    if pos_weight is not None:
        j_loss = lambda p, b, k, e: jt.classifier_loss(p, b, k, e,  # noqa
                                                       pos_weight)
        t_loss = lambda m, b, g, e: tt.classifier_loss(m, b, g, e,  # noqa
                                                       pos_weight)
    (jl, _), jg = jax.value_and_grad(
        lambda p: j_loss(jt._merge(tree, p), batch, key, 1e-8),
        has_aux=True)(jt._trainable(tree))
    if draw:
        inject(monkeypatch, [jax.random.normal(key, (BS, Z))])
    m = tm.module_from_params(host(tree))
    leaves = tt._trainable(m)
    for _, t in leaves:
        t.requires_grad_(True)
    tb = tuple(None if b is None else torch.from_numpy(np.asarray(b))
               for b in batch)
    loss, _ = t_loss(m, tb, torch.Generator() if draw else None, 1e-8)
    loss.backward()
    return (float(loss.detach()), {k: t.grad.numpy() for k, t in leaves},
            float(jl), jc._flatten(jg))


@pytest.mark.parametrize("family,variant", [
    ("m1", None), ("m2", None), ("classifier", None),
    ("classifier", "pos_weight"), ("classifier", "batch_norm"),
    ("wiener", None)])
def test_family_loss_and_gradients(frames, monkeypatch, family, variant):
    tree = jax_tree(family, batch_norm=variant == "batch_norm")
    (xtr, ytr), _ = family_data(frames, family)
    batch = (xtr[:BS], None if ytr is None else ytr[:BS])
    loss, grads, jloss, jgrads = _grads(
        family, tree, batch, family in ("m1", "m2"),
        pos_weight=2.5 if variant == "pos_weight" else None,
        monkeypatch=monkeypatch)
    np.testing.assert_allclose(loss, jloss, **STEP_TOL)
    assert sorted(grads) == sorted(jgrads)
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if variant == "batch_norm":   # JAX trains the running stats too
        assert {"bn.0.mean", "bn.0.var", "bn.1.scale"} <= set(grads)


def test_one_adam_step_matches_optax(frames, tmp_path):
    tree = jax_tree("wiener")
    (xtr, ytr), _ = family_data(frames, "wiener")
    batch = (xtr[:BS], ytr[:BS])
    opt = optax.adam(1e-3, b1=0.9, b2=0.999)
    tp = jt._trainable(tree)
    state = opt.init(tp)
    for _ in range(2):
        g = jax.grad(lambda p: jt.wiener_loss(p, batch, None, 1e-8)[0])(tp)
        upd, state = opt.update(g, state, tp)
        tp = optax.apply_updates(tp, upd)
    jc.save_resume_state(str(tmp_path / "j"), 2, tp, state)

    m = tm.module_from_params(host(tree))
    leaves = tt._trainable(m)
    for _, t in leaves:
        t.requires_grad_(True)
    topt = tt.make_optimizer(pcfg(), [t for _, t in leaves])
    step = tt.make_train_step(tt.wiener_loss, topt, 1e-8)
    tb = tuple(torch.from_numpy(b) for b in batch)
    for _ in range(2):
        step(m, tb)
    vals, params, mu, nu = tt._snapshot(torch.zeros(2), leaves, topt)
    tc.save_resume_state(str(tmp_path / "p"), 2, tc.unflatten(params),
                         {"count": 2, "mu": mu, "nu": nu})
    compare_dirs(str(tmp_path / "j"), str(tmp_path / "p"), **STEP_TOL)


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------

def _fit_pair(tmp_path, monkeypatch, family, small=False, epochs=3,
              frames=None):
    tree = jax_tree(family)
    tr, va = family_data(frames, family, small)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jp, jh = jt.fit(tree, family, tr, va, jcfg(epochs), jdir, "Net")
    queue = None
    if family in ("m1", "m2"):
        if small:
            draws = draws_small(0, epochs, N_VA // BS, BS, Z)
        else:
            draws = draws_epoch(0, epochs, N_TR // BS, BS, N_VA // BS, BS, Z)
        queue = inject(monkeypatch, draws)
    pm, ph = tt.fit(host(tree), family, tr, va, pcfg(epochs), pdir, "Net",
                    device="cpu")
    assert not queue
    return jp, jh, pm, ph, jdir, pdir


@pytest.mark.parametrize("family,small", [
    ("classifier", False), ("wiener", False), ("m1", False), ("m2", False),
    ("classifier", True), ("m2", True)])
def test_fit_matches_jax(frames, tmp_path, monkeypatch, family, small):
    jp, jh, pm, ph, jdir, pdir = _fit_pair(tmp_path, monkeypatch, family,
                                           small, frames=frames)
    tol = FIT_TOL
    assert [h["epoch"] for h in ph] == [1, 2, 3]
    for a, b in zip(jh, ph):
        np.testing.assert_allclose([b["train"], b["valid"]],
                                   [a["train"], a["valid"]], **tol)
    compare_dirs(jdir, pdir, **tol)
    if small:   # the small-set path drops the remainder: no update
        assert all(h["train"] == 0.0 for h in ph)
    got = tm.params_from_module(pm)
    for k, v in jc._flatten(jc._strip_static(jp)).items():
        np.testing.assert_allclose(tc._flat_arrays(got)[k], v, **tol)
    assert not any(p.requires_grad for p in pm.parameters())


def test_fit_with_batch_norm_trains_its_four_leaves(frames, tmp_path,
                                                    monkeypatch):
    tree = jax_tree("classifier", batch_norm=True)
    tr, va = family_data(frames, "classifier")
    jt.fit(tree, "classifier", tr, va, jcfg(2), str(tmp_path / "j"), "C")
    pm, _ = tt.fit(tm.module_from_params(host(tree)), "classifier", tr, va,
                   pcfg(2), str(tmp_path / "p"), "C", device="cpu")
    compare_dirs(str(tmp_path / "j"), str(tmp_path / "p"), **FIT_TOL)
    assert float(pm.bn[0].var.sub(1).abs().max()) > 0  # moved by Adam
    assert not pm.bn[0].var.requires_grad


def test_empty_validation_set_gives_zero(frames, tmp_path):
    tr, _ = family_data(frames, "wiener")
    _, hist = tt.fit(host(jax_tree("wiener")), "wiener", tr,
                     (tr[0][:0], tr[1][:0]), pcfg(1), str(tmp_path), "W",
                     device="cpu")
    assert hist[0]["valid"] == 0.0 and hist[0]["train"] > 0
    assert os.path.exists(tmp_path / "W_epoch_001_vloss_0.00.ckpt.npz")


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(frames, tmp_path, first):
    """2 epochs in one package, the 3rd resumed in the other, equal to
    the same run in JAX alone."""
    tree = jax_tree("classifier")
    tr, va = family_data(frames, "classifier")
    ref = str(tmp_path / "ref")
    jt.fit(tree, "classifier", tr, va, jcfg(2), ref, "C")
    jt.fit(tree, "classifier", tr, va, jcfg(3), ref, "C", resume=True)
    run = str(tmp_path / "run")
    if first == "jax":
        jt.fit(tree, "classifier", tr, va, jcfg(2), run, "C")
        _, hist = tt.fit(host(tree), "classifier", tr, va, pcfg(3), run,
                         "C", resume=True, device="cpu")
        assert [h["epoch"] for h in hist] == [3]
    else:
        tt.fit(host(tree), "classifier", tr, va, pcfg(2), run, "C",
               device="cpu")
        _, hist = jt.fit(tree, "classifier", tr, va, jcfg(3), run, "C",
                         resume=True)
        assert [h["epoch"] for h in hist] == [3]
    compare_dirs(ref, run, **FIT_TOL)


def test_checkpoint_holds_its_epochs_weights(frames, tmp_path, monkeypatch):
    """Epoch N's checkpoint equals the weights of a run that stops at N,
    also when the saver runs behind the training loop."""
    tree = host(jax_tree("wiener"))
    tr, va = family_data(frames, "wiener")
    short, _ = tt.fit(tree, "wiener", tr, va, pcfg(2), str(tmp_path / "a"),
                      "W", device="cpu")
    orig = tt.save_params

    def slow(*a, **kw):
        time.sleep(0.3)
        return orig(*a, **kw)

    monkeypatch.setattr(tt, "save_params", slow)
    tt.fit(tree, "wiener", tr, va, pcfg(3), str(tmp_path / "b"), "W",
           device="cpu")
    ckpt = [p for p in os.listdir(tmp_path / "b")
            if p.startswith("W_epoch_002")]
    assert len(ckpt) == 1
    with np.load(tmp_path / "b" / ckpt[0]) as f:
        saved = {k: f[k] for k in f.files}
    want = tc._flat_arrays(short)
    assert sorted(saved) == sorted(want)
    for k in want:
        assert np.array_equal(saved[k], want[k]), k


def test_train_classifier_calibrates_like_jax(frames, tmp_path, monkeypatch):
    tr, va = family_data(frames, "classifier")
    dims = (F, H, F)
    mean, std = frames["Xtr"].mean(0), frames["Xtr"].std(0)
    kw = dict(dims=dims, mean=mean, std=std, pos_weight=2.0, calibrate=True,
              meta_extra={"labels": "noisy_labels"})
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jt.train_classifier(tr, va, cfg=jcfg(2), model_dir=jdir, **kw)
    jax_init(monkeypatch)
    tt.train_classifier(tr, va, cfg=pcfg(2), model_dir=pdir, device="cpu",
                        **kw)
    compare_dirs(jdir, pdir, **FIT_TOL)
    with open(os.path.join(pdir, "classifier_meta.json")) as f:
        meta = json.load(f)
    assert meta["threshold"] != 0.5 or meta["valid_f1"] > 0
    best = tc.best_checkpoint(pdir)
    m = tc.load_model(best, kind="classifier", device="cpu")
    j_thr = jt.calibrate_threshold(jc.load_params(best), va[0], va[1])
    assert tt.calibrate_threshold(m, va[0], va[1]) == pytest.approx(
        j_thr, abs=1e-6)


def test_front_doors_match_jax(frames, tmp_path, monkeypatch):
    """train_m1 / train_m2 / train_wiener from the JAX initial weights."""
    jax_init(monkeypatch)
    for family, fn, dims, data in (
            ("m1", "train_m1", (F, Z, H), None),
            ("m2", "train_m2", (F, F, Z, H), None),
            ("wiener", "train_wiener", (F, H, F), None)):
        tr, va = family_data(frames, family)
        if family == "m1":
            tr, va = tr[0], va[0]
        jdir = str(tmp_path / f"{family}_j")
        pdir = str(tmp_path / f"{family}_p")
        getattr(jt, fn)(tr, va, dims=dims, cfg=jcfg(1), model_dir=jdir)
        if family in ("m1", "m2"):
            inject(monkeypatch, draws_epoch(0, 1, N_TR // BS, BS,
                                            N_VA // BS, BS, Z))
        getattr(tt, fn)(tr, va, dims=dims, cfg=pcfg(1), model_dir=pdir,
                        device="cpu")
        compare_dirs(jdir, pdir, **FIT_TOL)


def test_each_package_loads_the_others_checkpoints(tmp_path):
    """load_model / load_params of each package on the other's files."""
    for kind, family in (("vae", "m1"), ("dgm", "m2"),
                         ("classifier", "classifier")):
        tree = jax_tree(family)
        jdir, pdir = str(tmp_path / f"j{family}"), str(tmp_path / f"p{family}")
        jc.save_params(jdir, "N", 1, 1.5, tree)
        m = tm.module_from_params(host(tree))
        tc.save_params(pdir, "N", 1, 1.5, m)
        from_j = tc.load_model(jdir, kind=kind, y_dim=F, device="cpu")
        from_p = jc.load_model(pdir, kind=kind, y_dim=F)
        for k, v in jc._flatten(jc._strip_static(tree)).items():
            assert np.array_equal(tc._flat_arrays(from_j)[k], v), k
            assert np.array_equal(
                jc._flatten(jc._strip_static(from_p))[k], v), k
        assert tc.checkpoint_name("N", 1, 1.5) == jc.checkpoint_name(
            "N", 1, 1.5)
    assert not any(p.requires_grad for p in from_j.parameters())


def test_mesh_raises():
    # a mesh= that is not a parallel.Mesh
    with pytest.raises(TypeError, match="Mesh"):
        tt.fit(host(jax_tree("wiener")), "wiener", (None, None),
               (None, None), pcfg(1), "unused", "W", mesh=object(),
               device="cpu")
