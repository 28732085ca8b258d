"""The port's scripts (`python -m guided_vae_nmf_torch.scripts.<name>`) on
the CPU, against a synthetic data root in the reference layout
(`<data_root>/subset/{raw,processed}/CSR-1-WSJ-0/WAV/wsj0/si_et_05/...`,
three speech-like utterances of 1-2 s and the SNR pickle): every script's
`--help` exits 0; each `evaluate_*` writes what the port's `enhance_files`
/ `enhance_files_wiener` write for the same arguments (full width, shipped
weights, `--niter 2`, `--device cpu`); each `run_metrics_*` gives the JAX
package's `run_metrics` rows and statistics on the same tree;
`--data_parallel 1` raises without a card (its mesh takes every card;
the sharded runs are in tests/test_torch_parallel.py); the doctor fails
without a card; and the
streaming scripts run at a tiny size. The metric scripts run their sweep
on a thread pool here (`thread_pool`): the spawn pool itself, which costs
seconds a worker to start on the CPU, is held against JAX in
tests/test_torch_metrics_runner.py.

The dataset and training scripts run on a second root with train and
validation splits (`si_tr_s`, `si_dt_05`) and a short synthetic noise
bank in place of the 60 s one: each `create_*` script writes what the
JAX package's script writes (bit for bit), and each `training_*` script
(`--end_epoch 1 --device cpu`) writes the reference's model directory
with its checkpoint, logs and side-cars."""

import importlib
import os

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.data import speech_list, write_dataset, write_wav
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.pipeline import enhance_files, enhance_files_wiener
from guided_vae_nmf_torch.train import load_model, load_norm_stats
from guided_vae_nmf_tpu.metrics import run_metrics as jax_run_metrics

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "pretrained")
FS = 16000
SCRIPTS = ("evaluate_M2_ibm", "evaluate_M2_vad", "evaluate_M1",
           "evaluate_wiener_filter", "run_metrics_M1", "run_metrics_M2",
           "run_metrics_mixture", "run_metrics_wiener", "serve_http",
           "doctor", "eval_streaming_m2", "bench_multistream",
           "create_train_set", "create_noisy_train_set", "create_test_set",
           "training_M1", "training_M2", "training_classifier",
           "training_wiener_filter", "reconstruct_M1",
           "reconstruct_dnn_classif", "reconstruct_timo_classif",
           "visualization")
UTTS = (("440", "440c0201", 1.2, 5.0), ("440", "440c0202", 1.7, 0.0),
        ("441", "441c0203", 1.4, 5.0))


def script(name):
    return importlib.import_module(f"guided_vae_nmf_torch.scripts.{name}")


def speech_like(seed, seconds, snr_db):
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
    noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    scale = 0.5 / np.max(np.abs(s + noise))
    return s * scale, noise * scale


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """`<root>/subset/{raw,processed,models}` with the test split."""
    base = str(tmp_path_factory.mktemp("scripts_root"))
    sub = os.path.join(base, "subset")
    rel = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05")
    for i, (spk, utt, sec, snr) in enumerate(UTTS):
        s, n = speech_like(30 + i, sec, snr)
        for d in ("raw", "processed"):
            os.makedirs(os.path.join(sub, d, rel, spk), exist_ok=True)
        write_wav(os.path.join(sub, "raw", rel, spk, utt + ".wav"), s, FS)
        for tag, sig in (("s", s), ("n", n), ("x", s + n)):
            write_wav(os.path.join(sub, "processed", rel, spk,
                                   f"{utt}_{tag}.wav"), sig, FS)
    write_dataset([u[3] for u in UTTS], os.path.join(sub, "processed"),
                  "test", "snr_db")
    os.makedirs(os.path.join(sub, "models"))
    return base


def dirs(root):
    sub = os.path.join(root, "subset")
    return (os.path.join(sub, "raw") + "/",
            os.path.join(sub, "processed") + "/",
            os.path.join(sub, "models") + "/")


def same_tree(a, b):
    """Every file under `a` equals its namesake under `b`, and neither has
    a file the other lacks; returns the file count."""
    names = []
    for d in (a, b):
        names.append(sorted(os.path.relpath(os.path.join(r, f), d)
                            for r, _, fs in os.walk(d) for f in fs))
    assert names[0] == names[1] and names[0]
    for rel in names[0]:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel
    return len(names[0])


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_exits_zero(name, capsys):
    with pytest.raises(SystemExit) as e:
        script(name).main(["--help"])
    assert e.value.code in (0, None)
    assert capsys.readouterr().out.strip()


@pytest.mark.parametrize("name,argv", [
    ("evaluate_M2_ibm", ["--classifier", "c", "--data_root", "d"]),
    ("evaluate_M2_vad", ["--data_root", "d"]),
    ("evaluate_M1", ["--data_root", "d"]),
    ("bench_multistream", []),
    ("serve_http", ["--models", ART]),
    ("training_M2", ["--data_root", "d"]),
])
def test_data_parallel_raises(name, argv, monkeypatch):
    # `--data_parallel 1` builds a mesh of every card: without one it
    # raises, with no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script(name).main(["--data_parallel", "1", *argv])


def test_doctor_fails_without_a_card(capsys):
    assert script("doctor").main(["--probe_s", "60"]) != 0
    assert "REQUIRED CHECKS FAILED" in capsys.readouterr().out


@pytest.fixture(scope="module")
def m2_outputs(root):
    """evaluate_M2_ibm's output directory (dnn labels, --niter 2)."""
    out = os.path.join(root, "m2_script")
    script("evaluate_M2_ibm").main([
        "--data_root", root, "--model", os.path.join(ART, "M2_ibm"),
        "--classifier", os.path.join(ART, "classifier_ibm"), "--niter", "2",
        "--output", out, "--device", "cpu"])
    return out


def test_evaluate_m2_ibm_writes_what_enhance_files_writes(root, m2_outputs,
                                                          tmp_path):
    raw, proc, _ = dirs(root)
    cdir = os.path.join(ART, "classifier_ibm")
    mean, std = load_norm_stats(cdir)
    enhance_files(speech_list(raw, "test"), proc, str(tmp_path),
                  load_model(os.path.join(ART, "M2_ibm"), kind="dgm",
                             device="cpu"),
                  classifier=load_model(cdir, kind="classifier",
                                        device="cpu"),
                  mean=mean, std=std, cfg=MCEMConfig(niter=2), device="cpu")
    assert same_tree(m2_outputs, str(tmp_path)) == 4 * len(UTTS)


def test_evaluate_m2_vad_oracle_and_m1(root, tmp_path):
    raw, proc, _ = dirs(root)
    files = speech_list(raw, "test")
    for name, model, kind, kw in (
            ("evaluate_M2_vad", "M2_vad", "dgm",
             dict(model_type="m2", classif_type="oracle", target="vad")),
            ("evaluate_M1", "M1", "vae", dict(model_type="m1"))):
        out = str(tmp_path / name)
        script(name).main(["--data_root", root, "--model",
                           os.path.join(ART, model), "--classif_type",
                           "oracle", "--niter", "2", "--algorithm", "mcem",
                           "--output", out, "--device", "cpu"])
        ref = str(tmp_path / (name + "_ref"))
        enhance_files(files, proc, ref,
                      load_model(os.path.join(ART, model), kind=kind,
                                 y_dim=1, device="cpu"),
                      cfg=MCEMConfig(niter=2), device="cpu", **kw)
        assert same_tree(out, ref) >= 2 * len(UTTS)


def test_evaluate_wiener_and_its_metrics(root, tmp_path, capsys):
    raw, proc, _ = dirs(root)
    out, ref = str(tmp_path / "w"), str(tmp_path / "w_ref")
    wdir = os.path.join(ART, "wiener")
    script("evaluate_wiener_filter").main([
        "--data_root", root, "--model", wdir, "--output", out,
        "--device", "cpu"])
    mean, std = load_norm_stats(wdir)
    enhance_files_wiener(speech_list(raw, "test"), proc, ref,
                         load_model(wdir, kind="classifier", device="cpu"),
                         mean=mean, std=std, device="cpu")
    assert same_tree(out, ref) == 2 * len(UTTS)
    got = script("run_metrics_wiener").main(["--data_root", root,
                                             "--est_dir", out])
    jax = jax_run_metrics(raw, proc, ref, with_f1=False, serial=True)
    assert got[:3] == jax[:3]
    np.testing.assert_equal(got[3], jax[3])
    assert os.path.exists(os.path.join(out, "stats.json"))


@pytest.fixture
def thread_pool(monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    from guided_vae_nmf_torch.metrics import runner

    monkeypatch.setattr(runner, "metrics_pool",
                        lambda max_workers=8: ThreadPoolExecutor(2))


def test_run_metrics_m2_matches_jax(root, m2_outputs, capsys, thread_pool):
    raw, proc, _ = dirs(root)
    got = script("run_metrics_M2").main(["--data_root", root, "--est_dir",
                                         m2_outputs])
    out = capsys.readouterr().out
    ref = jax_run_metrics(raw, proc, m2_outputs, with_f1=True, serial=True)
    assert got[0] == ref[0] and got[1] == ref[1] and got[2] == ref[2]
    np.testing.assert_equal(got[3], ref[3])
    assert got[0][-1] == "F1" and out == capsys.readouterr().out


def test_run_metrics_m1_and_mixture_match_jax(root, m2_outputs,
                                              thread_pool):
    raw, proc, _ = dirs(root)
    got = script("run_metrics_M1").main(["--data_root", root, "--est_dir",
                                         m2_outputs])
    ref = jax_run_metrics(raw, proc, m2_outputs, serial=True)
    assert got[:3] == ref[:3] and len(got[0]) == 5
    got = script("run_metrics_mixture").main(["--data_root", root])
    ref = jax_run_metrics(raw, proc, None, mixture_floor=True, serial=True)
    assert got[:3] == ref[:3]
    np.testing.assert_equal(got[3], ref[3])


def test_streaming_scripts_run_small(root, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    script("eval_streaming_m2").main([
        "--data_root", root, "--chunks", "8", "--label_mode", "timo",
        "--skip_offline", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mixture floor" in out and "stream chunk=8" in out
    rows = script("bench_multistream").main([
        "--streams", "2", "--seconds", "0.4", "--device", "cpu"])
    assert [r["streams"] for r in rows] == [2]
    assert rows[0]["pooled_wall_s"] > 0 and rows[0]["serial_wall_s"] > 0


# ---------------------------------------------------------------------------
# dataset and training scripts
# ---------------------------------------------------------------------------

TRAIN_UTTS = {"si_tr_s": [("011", "011a0101", 1.3), ("011", "011a0102", 1.0),
                          ("012", "012a0103", 1.1), ("012", "012a0104", 0.9)],
              "si_dt_05": [("021", "021a0201", 1.0), ("022", "022a0202", 0.9)],
              "si_et_05": [("031", "031a0301", 1.0), ("032", "032a0302", 1.2)]}


@pytest.fixture(scope="module")
def bank():
    from guided_vae_nmf_torch.data import synthetic_noise_bank

    return synthetic_noise_bank(duration_sec=4)


@pytest.fixture
def short_bank(monkeypatch, bank):
    """The scripts' `--synthetic_noise 1` bank, 4 s a family (both
    packages)."""
    import guided_vae_nmf_tpu.data as j_data

    for mod in (script("create_noisy_train_set"), script("create_test_set"),
                j_data):
        monkeypatch.setattr(mod, "synthetic_noise_bank",
                            lambda *a, **kw: dict(bank))


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """`<root>/subset/raw/CSR-1-WSJ-0/WAV/wsj0/{si_tr_s,si_dt_05,si_et_05}`
    with speech-like utterances."""
    base = str(tmp_path_factory.mktemp("train_root"))
    rel = os.path.join(base, "subset", "raw", "CSR-1-WSJ-0", "WAV", "wsj0")
    seed = 50
    for split, utts in TRAIN_UTTS.items():
        for spk, utt, sec in utts:
            os.makedirs(os.path.join(rel, split, spk), exist_ok=True)
            write_wav(os.path.join(rel, split, spk, utt + ".wav"),
                      speech_like(seed, sec, 5.0)[0], FS)
            seed += 1
    return base


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("create_train_set", []),
    ("create_noisy_train_set", ["--synthetic_noise", "1"]),
    ("create_noisy_train_set", ["--synthetic_noise", "1", "--labels",
                                "noisy_wiener_labels"]),
    ("create_test_set", ["--synthetic_noise", "1"]),
])
def test_create_scripts_write_what_jax_writes(train_root, tmp_path,
                                              short_bank, name, argv,
                                              capsys, monkeypatch):
    """JAX's test-set pool runs serially (`serial_jax_pool`); the port
    runs at its default workers and must write the same bytes."""
    import shutil

    from test_torch_train_helpers import serial_jax_pool

    serial_jax_pool(monkeypatch)
    roots = {}
    for tag in ("jax", "port"):
        roots[tag] = str(tmp_path / tag)
        shutil.copytree(train_root, roots[tag])
    jax_script(name).main(["--data_root", roots["jax"], *argv])
    script(name).main(["--data_root", roots["port"], *argv])
    assert "Finished" in capsys.readouterr().out or name != \
        "create_test_set"
    sub = {t: os.path.join(r, "subset") for t, r in roots.items()}
    n = 0
    for d in ("export", "processed"):
        if os.path.isdir(os.path.join(sub["jax"], d)):
            n += same_h5_tree(os.path.join(sub["jax"], d),
                              os.path.join(sub["port"], d))
    assert n


def same_h5_tree(a, b):
    """same_tree, with HDF5 files compared by their datasets and attrs
    (the files' bytes hold creation times)."""
    import h5py

    names = [sorted(os.path.relpath(os.path.join(r, f), d)
                    for r, _, fs in os.walk(d) for f in fs) for d in (a, b)]
    assert names[0] == names[1] and names[0]
    for rel in names[0]:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".h5"):
            with h5py.File(pa, "r") as fa, h5py.File(pb, "r") as fb:
                assert sorted(fa) == sorted(fb), rel
                for k in fa:
                    assert np.array_equal(fa[k][...], fb[k][...]), (rel, k)
                assert {k: np.asarray(v).tolist()
                        for k, v in fa.attrs.items()} == \
                    {k: np.asarray(v).tolist() for k, v in fb.attrs.items()}
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return len(names[0])


@pytest.fixture(scope="module")
def stores(train_root, bank):
    """The clean, noisy and Wiener stores of `train_root`."""
    import unittest.mock as mock

    with mock.patch.object(script("create_noisy_train_set"),
                           "synthetic_noise_bank", lambda: dict(bank)):
        script("create_train_set").main(["--data_root", train_root])
        for labels in ("noisy_labels", "noisy_wiener_labels"):
            script("create_noisy_train_set").main([
                "--data_root", train_root, "--synthetic_noise", "1",
                "--labels", labels])
    return train_root


@pytest.mark.parametrize("name,model_dir,argv", [
    ("training_M1", "M1_hdim_016_zdim_004_end_epoch_001",
     ["--z_dim", "4", "--h_dim", "16"]),
    ("training_M2", "M2_hdim_016_016_zdim_004_end_epoch_001",
     ["--z_dim", "4", "--h_dim", "16,16"]),
    ("training_classifier", "Classifier_hdim_016_016_end_epoch_001",
     ["--h_dim", "16,16"]),
    ("training_wiener_filter", "Wiener_hdim_5x128_end_epoch_001", []),
])
def test_training_scripts_run_small(stores, capsys, name, model_dir, argv):
    script(name).main(["--data_root", stores, "--end_epoch", "1",
                       "--batch_size", "32", "--device", "cpu", *argv])
    assert "done; best valid" in capsys.readouterr().out
    d = os.path.join(stores, "subset", "models", model_dir)
    files = sorted(os.listdir(d))
    assert any(f.endswith(".ckpt.npz") and "_epoch_001_" in f
               for f in files)
    assert {"output_batch.log", "output_epoch.log",
            "resume_state.npz"} <= set(files)
    if name in ("training_classifier", "training_wiener_filter"):
        assert {"trainset_mean.npy", "trainset_std.npy"} <= set(files)
    if name == "training_classifier":
        assert "classifier_meta.json" in files
