"""The demos (`guided_vae_nmf_torch/examples/`) on the CPU: each one's
`--help`; each one's `main` end to end on a tiny synthetic subset-layout
root (three speech-like utterances of 1.0-1.4 s from
`chip_smoke.write_demo_root`, niter 2), printing the JAX demos' lines;
and, where a demo is deterministic, its output held against the JAX demo
run on the same root: the streaming Wiener-DNN's enhanced signal within
1 LSB of 16-bit PCM (two packages' float32 forward passes), the
visualization tour's IBM equal, and the training tour's SVI loss from the
JAX initial weights under JAX's reparametrisation draws (injected as
tests/test_torch_losses.py does) within rtol 1e-4, that file's tolerance
for an SVI loss.

The JAX demos run from their files (`examples/*.py`) with their data-root
constants (`SUB`, `OUT`) monkeypatched at run time; no file of `examples/`
changes.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from chip_smoke import write_demo_root
from guided_vae_nmf_torch.examples import (
    demo_enhancement,
    demo_serving,
    demo_streaming,
    demo_streaming_http,
    notebook_tours,
)
from guided_vae_nmf_torch.models import module_from_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = {"demo_enhancement": demo_enhancement, "demo_serving": demo_serving,
         "demo_streaming": demo_streaming,
         "demo_streaming_http": demo_streaming_http,
         "notebook_tours": notebook_tours}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_demo_root(str(tmp_path_factory.mktemp("demo_root")), 0)


def jax_demo(monkeypatch, name, **constants):
    """The JAX package's examples/<name>.py as a module, its constants
    replaced (its import puts "." on sys.path: restored after the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in constants.items():
        monkeypatch.setattr(mod, key, value)
    return mod


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        DEMOS[name].main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "usage:" in out and "--data_root" in out and "--device" in out


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_needs_the_card_unless_told(name, root, tmp_path, monkeypatch):
    """Without --device a demo runs on the card: on a machine without one
    it raises before it writes or serves anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data_root", root]
    if name == "notebook_tours":
        argv = ["training", "--out", str(tmp_path / "tours")] + argv
    elif name == "demo_enhancement":
        argv += ["--out", str(tmp_path / "demo")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DEMOS[name].main(argv)
    assert not (tmp_path / "demo").exists()


def test_demo_enhancement_runs(root, tmp_path, capsys):
    res = demo_enhancement.main(["--data_root", root, "--out",
                                 str(tmp_path), "--niter", "2",
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("1) synthesizing test mixtures (0 dB SNR, 2 noise types)",
                "2) MCEM enhancement (oracle IBM guidance, 2 EM iterations)",
                "3) PEEM enhancement (gradient E-step, 2 EM iterations)",
                "4) inspection figure", "   wrote "):
        assert tag in out, tag
    assert out.count("  [MCEM] ") == out.count("  [PEEM] ") == 3
    assert np.all(np.isfinite(res["MCEM"])) and np.all(
        np.isfinite(res["PEEM"]))
    assert os.path.getsize(res["figure"]) > 0


def test_demo_serving_runs(root, capsys):
    res = demo_serving.main(["--data_root", root, "--niter", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(" SI-SDR ") == 3 and out.count("  (batch of ") == 3
    assert "service stats: {" in out
    assert res["stats"]["requests"] == 3
    assert all(np.isfinite(r[:3]).all() for r in res["results"].values())


def test_demo_streaming_matches_jax(root, monkeypatch, capsys):
    """The streaming Wiener-DNN demo: its lines, and its enhanced signal
    within 1 LSB of the JAX demo's on the same root."""
    res = demo_streaming.main(["--data_root", root, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "chunks: 9 x 100 ms | per-chunk compute p50 " in out
    assert "(budget 100 ms) | algorithmic latency 64 ms" in out
    assert "dB (440c0200.wav, streaming Wiener-DNN)" in out
    jd = jax_demo(monkeypatch, "demo_streaming", SUB=root)
    calls = []
    real = jd.energy_ratios

    def record(est, s, n):
        calls.append(np.asarray(est))
        return real(est, s, n)

    monkeypatch.setattr(jd, "energy_ratios", record)
    jd.main()
    s_jax = calls[1]                       # energy_ratios(s_hat[:L], ...)
    s_port = res["s_hat"][:len(s_jax)]
    assert s_port.shape == s_jax.shape
    assert np.max(np.abs(s_port - s_jax)) * 32768 <= 1.0
    # the printed SI-SDRs agree to their one decimal
    assert capsys.readouterr().out.splitlines()[-1] == out.splitlines()[-1]


def test_demo_streaming_http_runs(root, capsys):
    res = demo_streaming_http.main([
        "--data_root", root, "--device", "cpu", "--chunk_frames", "4",
        "--context", "8", "--block_iters", "2", "--e_steps", "2"])
    out = capsys.readouterr().out
    assert "s of audio in " in out and "x realtime pacing), first " \
        "enhanced bytes after " in out
    assert "SI-SDR: mixture " in out and " dB -> enhanced " in out
    assert res["status"] == "HTTP/1.1 200 OK"
    assert len(res["y"]) == len(res["x"]) and np.all(np.isfinite(res["y"]))


def test_notebook_tours_run(root, tmp_path, capsys):
    res = notebook_tours.main(["--data_root", root, "--out", str(tmp_path),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[inspection] frames (513, " in out and "inspection.png" in out
    assert "[training] SVI labelled loss on a 16-frame batch: " in out
    assert "(notebook flow: DGM z=128 h=[256,128])" in out
    assert "[visualization] 440c0200.wav: spectro+IBM -> " in out
    for tour in ("inspection", "visualization"):
        with open(res[tour]["path"], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert np.isfinite(res["training"]["loss"])
    with pytest.raises(SystemExit):
        notebook_tours.main(["nosuchtour", "--data_root", root])


def test_tours_visualization_ibm_equals_jax(root, tmp_path, monkeypatch):
    res = notebook_tours.main(["visualization", "--data_root", root,
                               "--out", str(tmp_path), "--device", "cpu"])
    import guided_vae_nmf_tpu.viz as jviz

    seen = []

    class NoFigure:
        def savefig(self, path):
            pass

    def record(x, x_tf, ibm):
        seen.append(np.asarray(ibm))
        return NoFigure()

    monkeypatch.setattr(jviz, "display_wav_spectro_mask", record)
    jd = jax_demo(monkeypatch, "notebook_tours", SUB=root,
                  OUT=str(tmp_path / "jax"))
    jd.main(["visualization"])
    ibm = res["visualization"]["ibm"]
    assert ibm.shape == seen[0].shape and 0 < ibm.mean() < 1
    assert np.array_equal(ibm, seen[0])


def test_tours_training_loss_matches_jax(root, tmp_path, monkeypatch):
    """The training tour's SVI loss: the port from the JAX tour's initial
    weights (`dgm_init` at PRNGKey(0)) with JAX's reparametrisation draws
    at PRNGKey(1) injected, against the JAX tour's loss."""
    import guided_vae_nmf_tpu.models.variational as jvar
    import guided_vae_nmf_torch.models as tmodels
    from guided_vae_nmf_torch.models import nets as tnets
    from guided_vae_nmf_tpu.models import dgm_init as jax_dgm_init

    losses = []
    real = jvar.svi

    def record(*a, **kw):
        out = real(*a, **kw)
        losses.append(float(out[0]))
        return out

    monkeypatch.setattr(jvar, "svi", record)
    jd = jax_demo(monkeypatch, "notebook_tours", SUB=root,
                  OUT=str(tmp_path / "jax"))
    jd.main(["training"])

    monkeypatch.setattr(tmodels, "dgm_init", lambda gen, dims: (
        module_from_params(jax_dgm_init(jax.random.PRNGKey(0), dims))))
    draws = [np.array(jax.random.normal(jax.random.PRNGKey(1), (16, 128)))]

    def inject(generator, mu, log_var, noise=None):
        assert noise is None
        eps = torch.from_numpy(draws.pop(0)).to(mu)
        assert eps.shape == mu.shape
        return mu + torch.exp(0.5 * log_var) * eps

    monkeypatch.setattr(tnets, "reparametrize", inject)
    res = notebook_tours.main(["training", "--data_root", root, "--out",
                               str(tmp_path), "--device", "cpu"])
    assert not draws
    np.testing.assert_allclose(res["training"]["loss"], losses[0],
                               rtol=1e-4)
