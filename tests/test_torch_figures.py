"""The port's figures (`guided_vae_nmf_torch/viz`) and the four figure
scripts, on the CPU. `power_to_db` and `_broadcast_mask` equal the JAX
package's exactly; the magma table and the grid layout equal
matplotlib's (the JAX package draws with matplotlib, the port rasterises
with Pillow); every builder writes a PNG of the expected size; and
`reconstruct_M1`, `reconstruct_dnn_classif` (its F1 scores against the
JAX script's), `reconstruct_timo_classif` and `visualization` run on a
test set made by `create_test_set --synthetic_noise 1` (a 4 s noise bank)
with the shipped M1 and classifier, `--device cpu`."""

import importlib
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from guided_vae_nmf_torch import viz
from guided_vae_nmf_torch.data import write_wav
from guided_vae_nmf_torch.dsp import stft
from guided_vae_nmf_torch.viz import figures as tf
from guided_vae_nmf_tpu.viz import figures as jf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "pretrained")
FS = 16000


def sig(n=16000):
    t = np.arange(n) / FS
    return np.sin(2 * np.pi * 440 * t) * np.exp(-t)


@pytest.mark.parametrize("kw", [{}, dict(ref=3.0), dict(amin=1e-3),
                                dict(top_db=None), dict(top_db=20.0)])
def test_power_to_db_matches_jax(kw):
    S = np.abs(stft(sig())) ** 2
    S[0, :5] = 0.0
    got, ref = tf.power_to_db(S, **kw), jf.power_to_db(S, **kw)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 37), (513, 37), (4, 9)])
def test_broadcast_mask_matches_jax(shape):
    m = (np.random.RandomState(0).rand(*shape) > 0.5).astype(np.float32)
    got, ref = tf._broadcast_mask(m), jf._broadcast_mask(m)
    assert got.shape == ref.shape and np.array_equal(got, ref)


def test_magma_and_grid_match_matplotlib():
    import matplotlib

    matplotlib.use("pdf")
    import matplotlib.gridspec as grd
    import matplotlib.pyplot as plt
    from matplotlib import colormaps

    want = (np.asarray(colormaps["magma"](np.arange(256)))[:, :3]
            * 255).round().astype(np.uint8)
    assert np.array_equal(tf.MAGMA, want)
    fig = plt.figure()
    for kw in (dict(nrows=3, ncols=2, height_ratios=[3, 10, 10],
                    width_ratios=[10, 0.5], wspace=0.1, hspace=0.3),
               dict(nrows=3, ncols=4, hspace=0.3, wspace=0.2)):
        bottoms, tops, lefts, rights = grd.GridSpec(
            figure=fig, **kw).get_grid_positions(fig)
        cells = tf.grid(**kw)
        for r in range(kw["nrows"]):
            for c in range(kw["ncols"]):
                np.testing.assert_allclose(
                    cells[r][c], (lefts[c], 1 - tops[r], rights[c],
                                  1 - bottoms[r]), rtol=0, atol=1e-12)
    plt.close(fig)


def builders():
    x = sig()
    X = stft(x)
    ibm = (np.abs(X) ** 2 > 0.01).astype(np.float32)
    return {
        "waveplot": (lambda: viz.display_waveplot(x), (640, 480)),
        "spectrogram": (lambda: viz.display_spectrogram(X, True),
                        (640, 480)),
        "power_spectro": (lambda: viz.display_power_spectro(
            np.abs(X) ** 2, True), (640, 480)),
        "wav_spectro_mask": (lambda: viz.display_wav_spectro_mask(
            x, X, ibm), (2000, 2500)),
        "wav_spectro_vad": (lambda: viz.display_wav_spectro_mask(
            x, X, ibm.max(axis=0, keepdims=True)), (2000, 2500)),
        "multiple_signals": (lambda: viz.display_multiple_signals(
            [[x, X, ibm], [x, X, None]], titles=["a", "b"]), (2000, 1500)),
        "multiple_spectro": (lambda: viz.display_multiple_spectro(
            [[x, X], [x, X]], titles=["a", "b"]), (2000, 1000)),
    }


@pytest.mark.parametrize("name", list(builders()))
def test_each_builder_writes_a_figure(name, tmp_path):
    build, size = builders()[name]
    fig = build()
    fig.suptitle("title")
    path = tmp_path / f"{name}.png"
    fig.savefig(path)
    with Image.open(path) as im:
        assert im.size == size
        px = np.asarray(im.convert("RGB")).reshape(-1, 3)
    # the panels hold more than the white page and black text
    assert len(np.unique(px, axis=0)) > 16


def test_colorize_clips_to_the_map():
    out = tf.colorize(np.array([[-1.0, 0.0, 0.5, 1.0, 2.0, np.nan]]), 0, 1)
    assert np.array_equal(out[0, [0, 1, 5]], tf.MAGMA[[0, 0, 0]])
    assert np.array_equal(out[0, [3, 4]], tf.MAGMA[[255, 255]])
    assert np.array_equal(out[0, 2], tf.MAGMA[128])


# -- the four scripts ----------------------------------------------------

UTTS = (("031", "031a0301", 1.1), ("032", "032a0302", 1.4))


def speech_like(seed, seconds):
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    s = sum(np.sin(k * phase) / k for k in range(1, 20))
    s *= 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
    return 0.5 * s / np.max(np.abs(s))


def script(name):
    return importlib.import_module(f"guided_vae_nmf_torch.scripts.{name}")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A test set made by the port's `create_test_set --synthetic_noise 1`
    (a 4 s bank in place of the 60 s one) over two speech-like
    utterances."""
    from guided_vae_nmf_torch.data import synthetic_noise_bank

    base = str(tmp_path_factory.mktemp("fig_root"))
    rel = os.path.join(base, "subset", "raw", "CSR-1-WSJ-0", "WAV", "wsj0",
                       "si_et_05")
    for i, (spk, utt, sec) in enumerate(UTTS):
        os.makedirs(os.path.join(rel, spk), exist_ok=True)
        write_wav(os.path.join(rel, spk, utt + ".wav"),
                  speech_like(60 + i, sec), FS)
    mod = script("create_test_set")
    bank = synthetic_noise_bank(duration_sec=4)
    saved = mod.synthetic_noise_bank
    mod.synthetic_noise_bank = lambda *a, **kw: dict(bank)
    try:
        mod.main(["--data_root", base, "--synthetic_noise", "1"])
    finally:
        mod.synthetic_noise_bank = saved
    return base


def pngs(paths):
    for p in paths:
        with Image.open(p) as im:
            assert im.size[0] > 100 and im.size[1] > 100
    return len(paths)


def test_reconstruct_m1_writes_its_figures(data_root, tmp_path, capsys):
    out = script("reconstruct_M1").main([
        "--data_root", data_root, "--model", os.path.join(ART, "M1"),
        "--output", str(tmp_path) + "/", "--device", "cpu"])
    assert pngs(out) == len(UTTS)
    assert all(p.endswith("_recon.png") for p in out)
    with Image.open(out[0]) as im:
        assert im.size == (720, 720)


def test_reconstruct_dnn_classif_matches_the_jax_script(
        data_root, tmp_path, capsys, monkeypatch):
    cdir = os.path.join(ART, "classifier_ibm")
    scores = script("reconstruct_dnn_classif").main([
        "--data_root", data_root, "--classifier", cdir, "--output",
        str(tmp_path / "p") + "/", "--device", "cpu"])
    assert pngs(list(scores)) == len(UTTS)
    capsys.readouterr()
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "jax_reconstruct_dnn_classif",
        os.path.join(ROOT, "scripts", "reconstruct_dnn_classif.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_script.main(["--data_root", data_root, "--classifier", cdir,
                     "--output", str(tmp_path / "j") + "/"])
    want = [float(v) for v in re.findall(r"F1 ([\d.]+) ->",
                                         capsys.readouterr().out)]
    got = [v[3] for v in scores.values()]
    assert len(want) == len(UTTS)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("target", ["ibm", "vad"])
def test_reconstruct_timo_classif_writes_soft_and_hard(data_root, tmp_path,
                                                       capsys, target):
    out = script("reconstruct_timo_classif").main([
        "--data_root", data_root, "--target", target, "--output",
        str(tmp_path) + "/", "--device", "cpu"])
    assert pngs(out) == 2 * len(UTTS)
    assert sorted(p.rsplit("_", 1)[1] for p in out) == \
        ["hard.png"] * len(UTTS) + ["soft.png"] * len(UTTS)


@pytest.mark.parametrize("labels", ["ibm", "vad"])
def test_visualization_writes_a_figure_an_utterance(data_root, tmp_path,
                                                    capsys, labels):
    out = script("visualization").main([
        "--data_root", data_root, "--dataset_type", "test", "--labels",
        labels, "--output", str(tmp_path) + "/"])
    assert pngs(out) == len(UTTS)
    assert all(p.endswith(f"_{labels}.png") for p in out)
