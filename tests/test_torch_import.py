"""The port's reference `.pt` import (`models/torch_import.py`) against
the JAX package's, on the CPU: state dicts in the reference key naming,
built in the test and `torch.save`d to `tmp_path`, import to the same
trees (from a path and from a dict); `export_vae` is their inverse and
equals JAX's; `load_model` on a `.pt` gives the module that the same
weights' `.ckpt.npz` gives (a small M2's forward, rtol 1e-6, and the
shipped M2-IBM and classifier at full width); and
`record_reference_stream` equals JAX's bit for bit."""

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.models import (
    dgm_init,
    export_vae,
    import_classifier,
    import_dgm,
    import_vae,
    module_from_params,
    params_from_module,
    record_reference_stream,
)
from guided_vae_nmf_torch.models.convert import _flatten
from guided_vae_nmf_torch.train import load_model, save_params
from guided_vae_nmf_tpu.mcem.engine import MCEMConfig as JMCEMConfig
from guided_vae_nmf_tpu.models import torch_import as j_import
from guided_vae_nmf_tpu.train.checkpoints import load_model as j_load_model

torch.set_num_threads(2)

ART = "artifacts/pretrained"


def linear(rng, prefix, n_in, n_out):
    return {f"{prefix}.weight": rng.randn(n_out, n_in).astype(np.float32),
            f"{prefix}.bias": rng.randn(n_out).astype(np.float32)}


def vae_state_dict(seed, x_dim=9, y_dim=0, z_dim=3, h_dim=(7, 5)):
    """A VariationalAutoencoder / DeepGenerativeModel state dict in the
    reference's naming and (out, in) layout; an M2's layers take the label
    too."""
    rng = np.random.RandomState(seed)
    sd = {}
    dims = [x_dim + y_dim, *h_dim]
    for i in range(len(h_dim)):
        sd.update(linear(rng, f"encoder.hidden.{i}", dims[i], dims[i + 1]))
    sd.update(linear(rng, "encoder.sample.mu", h_dim[-1], z_dim))
    sd.update(linear(rng, "encoder.sample.log_var", h_dim[-1], z_dim))
    dims = [z_dim + y_dim, *h_dim[::-1]]
    for i in range(len(h_dim)):
        sd.update(linear(rng, f"decoder.hidden.{i}", dims[i], dims[i + 1]))
    sd.update(linear(rng, "decoder.reconstruction", h_dim[0], x_dim))
    return sd


def classifier_state_dict(tree):
    """A classifier tree in the reference's naming (hidden.N.*,
    output_layer.*), as torch tensors."""
    sd = {}
    for i, layer in enumerate(tree["hidden"]):
        sd[f"hidden.{i}.weight"] = torch.tensor(np.asarray(layer["w"]).T)
        sd[f"hidden.{i}.bias"] = torch.tensor(np.asarray(layer["b"]))
    sd["output_layer.weight"] = torch.tensor(np.asarray(tree["out"]["w"]).T)
    sd["output_layer.bias"] = torch.tensor(np.asarray(tree["out"]["b"]))
    return sd


def save_pt(path, sd):
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    return str(path)


def same_tree(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k
    assert {k: v for k, v in a.items() if not isinstance(v, (dict, list))} \
        == {k: v for k, v in b.items() if not isinstance(v, (dict, list))}


@pytest.mark.parametrize("source", ["path", "dict"])
def test_imports_match_jax(tmp_path, source):
    vae_sd = vae_state_dict(0)
    dgm_sd = vae_state_dict(1, y_dim=4)
    rng = np.random.RandomState(2)
    cls_sd = {**linear(rng, "hidden.0", 9, 6), **linear(rng, "hidden.1", 6, 5),
              **linear(rng, "output_layer", 5, 9)}
    if source == "path":
        args = [save_pt(tmp_path / f"{n}.pt", sd) for n, sd in
                (("vae", vae_sd), ("dgm", dgm_sd), ("cls", cls_sd))]
    else:
        args = [{k: torch.as_tensor(v) for k, v in sd.items()}
                for sd in (vae_sd, dgm_sd, cls_sd)]
    same_tree(import_vae(args[0]), j_import.import_vae(args[0]))
    same_tree(import_dgm(args[1], 4), j_import.import_dgm(args[1], 4))
    same_tree(import_classifier(args[2]), j_import.import_classifier(args[2]))
    tree = import_vae(args[0])
    assert np.shape(tree["encoder"]["hidden"][0]["w"]) == (9, 7)
    assert len(tree["decoder"]["hidden"]) == 2


def test_export_vae_inverts_import_and_matches_jax():
    sd = vae_state_dict(3, y_dim=2)
    tree = import_dgm(sd, 2)
    got, ref = export_vae(tree), j_import.export_vae(tree)
    assert sorted(got) == sorted(sd) == sorted(ref)
    for k in sd:
        assert np.array_equal(got[k], sd[k]) and np.array_equal(got[k], ref[k])
    for k, v in export_vae(module_from_params(tree)).items():
        assert np.array_equal(v, sd[k]), k


def test_load_model_pt_equals_npz_on_a_small_m2(tmp_path):
    gen = torch.Generator().manual_seed(0)
    m2 = dgm_init(gen, [65, 65, 4, [16, 16]])
    npz = save_params(str(tmp_path), "M2", 1, 1.0, m2)
    pt = save_pt(tmp_path / "M2_epoch_001_vloss_1.00.pt", export_vae(m2))
    a = load_model(npz, kind="dgm", y_dim=65, device="cpu")
    b = load_model(pt, kind="dgm", y_dim=65, device="cpu")
    same_tree(params_from_module(b), params_from_module(a))
    same_tree(params_from_module(b), j_load_model(pt, kind="dgm", y_dim=65))
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.rand(12, 65).astype(np.float32) * 10)
    y = torch.tensor((rng.rand(12, 65) > 0.5).astype(np.float32))
    ra = a(x, y, torch.Generator().manual_seed(5))
    rb = b(x, y, torch.Generator().manual_seed(5))
    for u, v in zip(ra, rb):
        torch.testing.assert_close(v, u, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,kind", [("M2_ibm", "dgm"), ("M1", "vae"),
                                       ("classifier_ibm", "classifier")])
def test_load_model_pt_of_the_shipped_weights(tmp_path, name, kind):
    npz_model = load_model(f"{ART}/{name}", kind=kind, device="cpu")
    tree = params_from_module(npz_model)
    sd = (classifier_state_dict(tree) if kind == "classifier"
          else export_vae(tree))
    pt = save_pt(tmp_path / f"{name}.pt", sd)
    pt_model = load_model(pt, kind=kind, device="cpu")
    assert type(pt_model) is type(npz_model)
    same_tree(params_from_module(pt_model), tree)


def test_record_reference_stream_matches_jax():
    small = dict(niter=2, nsamples_E_step=3, burnin_E_step=2,
                 nsamples_WF=2, burnin_WF=1)
    with torch.random.fork_rng():
        got = record_reference_stream(7, 9, 5, 3, MCEMConfig(**small))
    with torch.random.fork_rng():
        ref = j_import.record_reference_stream(7, 9, 5, 3,
                                               JMCEMConfig(**small))
    flat = lambda r: [*r[:3], *r[3]]   # noqa: E731
    for g, w in zip(flat(got), flat(ref)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert got[3][0].shape == (2, 5, 3, 5) and got[3][2].shape == (3, 3, 5)
