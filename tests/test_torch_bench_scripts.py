"""The port's bench, evaluation and validation scripts on the CPU
(`python -m guided_vae_nmf_torch.scripts.<name>`, `--device cpu`), on a
synthetic data root in the reference layout (`chip_smoke.write_eval_root`:
three speech-like test mixtures of 1.0-1.6 s at 5 dB):

- every script of this slice answers `--help` with exit 0;
- bench_long's looped mixture is the JAX script's, wav bytes at 1 minute
  (JAX's sweep patched out), and the script runs end to end at 0.25
  minutes, its warm run's output equal to its cold run's;
- eval_real_noise (`--niter 2`) writes, for each default system, what
  `enhance_files` / `enhance_files_wiener` write with the same arguments;
- bench_niter500 at a tiny B / N / niter prints the harness's keys, and its
  quality gate runs on the root;
- bench_serving, warm_cache and bench_vpu run tiny;
- pesq_battery passes its committed expectations with the first-party
  engine and gives the JAX package's MOS on 3 cases (atol 1e-6);
- validate_pesq / validate_stoi print the JAX scripts' line and exit 0
  without the `pesq` / `pystoi` wheels."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import speech_like_mixtures, write_eval_root
from test_torch_campaign import jax_script, script
from test_torch_scripts import same_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "pretrained")
SCRIPTS = ("bench_long", "bench_niter500", "bench_serving", "bench_vpu",
           "warm_cache", "eval_real_noise", "eval_campaign",
           "eval_classifier_context", "campaign_tables", "pretrain_subset",
           "bench_train", "pesq_battery", "validate_pesq", "validate_stoi",
           "validate_parity")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """`<root>/subset/{raw,processed}` with three test mixtures."""
    base = str(tmp_path_factory.mktemp("bench_root"))
    write_eval_root(speech_like_mixtures(3, (1.0, 1.6, 1.3)), base)
    return base


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_exits_zero(name, capsys):
    try:
        rc = script(name).main(["--help"])
    except SystemExit as e:
        rc = e.code
    assert rc in (0, None)
    assert capsys.readouterr().out.strip()


def test_bench_long_mixture_is_jax(root, tmp_path, monkeypatch, capsys):
    jbl = jax_script("bench_long")
    monkeypatch.setattr(jbl, "SUBSET", os.path.join(root, "subset"))
    monkeypatch.setattr(jbl, "enhance_files", lambda *a, **kw: None)
    jbl.main(["--minutes", "1", "--niter", "2", "--work",
              str(tmp_path / "jax")])
    bl = script("bench_long")
    x, s = bl.long_mixture(os.path.join(root, "subset"), 1)
    assert len(x) == 60 * 16000 and x.dtype == s.dtype == np.float32
    from guided_vae_nmf_torch.data import write_wav

    bp = str(tmp_path / "jax" / "proc" / os.path.splitext(bl.REL)[0])
    for tag, sig in (("x", x), ("s", s)):
        write_wav(str(tmp_path / f"port_{tag}.wav"), sig, 16000)
        assert (tmp_path / f"port_{tag}.wav").read_bytes() == \
            open(f"{bp}_{tag}.wav", "rb").read()
    capsys.readouterr()


def test_bench_long_runs_and_repeats_itself(root, tmp_path, capsys):
    work = str(tmp_path / "work")
    row = script("bench_long").main(
        ["--minutes", "0.25", "--niter", "2", "--work", work,
         "--data_root", root, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row
    assert row["frames"] == 15 * 16000 // 256 + 1 and row["niter"] == 2
    assert row["sample_buffer_gb"] == round(10 * row["frames"] * 513 * 2
                                            / 1e9, 2)
    assert set(row) >= {"cold_s", "warm_s", "rtf_warm", "backend"}
    assert same_tree(os.path.join(work, "est"),
                     os.path.join(work, "est2")) >= 2
    assert os.path.exists(os.path.join(
        work, "est", os.path.splitext(script("bench_long").REL)[0]
        + "_s_est.wav"))


def test_eval_real_noise_writes_what_enhance_files_writes(root, tmp_path,
                                                          capsys):
    from guided_vae_nmf_torch.data import speech_list
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.pipeline import (enhance_files,
                                               enhance_files_wiener)
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    work = str(tmp_path / "work")
    res = script("eval_real_noise").main(
        ["--niter", "2", "--work", work, "--data_root", root, "--device",
         "cpu"])
    out = capsys.readouterr().out
    assert "Real-noise QUT table" in out
    assert list(res) == ["m2dnn_spp", "m2oracle_spp", "wiener", "m1_spp"]
    sub = os.path.join(root, "subset")
    files = speech_list(os.path.join(sub, "raw") + "/", "test")
    proc = os.path.join(sub, "processed") + "/"
    assert all(np.shape(r) == (1, len(files), 4) for r in res.values())
    cpu = torch.device("cpu")
    cfg = MCEMConfig(niter=2)
    m2 = load_model(os.path.join(ART, "M2_ibm"), kind="dgm", device=cpu)
    kw = dict(cfg=cfg, batch_size=4, noise_model="spp", seed=0, device=cpu)
    ref = str(tmp_path / "ref")
    cdir = os.path.join(ART, "classifier_ibm")
    mean, std = load_norm_stats(cdir)
    enhance_files(files, proc, os.path.join(ref, "m2dnn_spp"), m2,
                  model_type="m2", classif_type="dnn",
                  classifier=load_model(cdir, kind="classifier", device=cpu),
                  mean=mean, std=std, soft_guidance=False, **kw)
    enhance_files(files, proc, os.path.join(ref, "m2oracle_spp"), m2,
                  model_type="m2", classif_type="oracle", **kw)
    enhance_files(files, proc, os.path.join(ref, "m1_spp"),
                  load_model(os.path.join(ART, "M1"), kind="vae",
                             device=cpu), model_type="m1", **kw)
    wdir = os.path.join(ART, "wiener")
    enhance_files_wiener(files, proc, os.path.join(ref, "wiener"),
                         load_model(wdir, kind="classifier", device=cpu),
                         *load_norm_stats(wdir), device=cpu)
    for name in res:
        got = os.path.join(work, "artifacts_pretrained", f"{name}_seed0")
        assert same_tree(got, os.path.join(ref, name)) >= len(files)


def test_bench_niter500_prints_the_harness_keys_and_its_gate(root, capsys):
    out = script("bench_niter500").main(
        ["--batch", "2", "--n", "32", "--niter", "2", "--quality", "1",
         "--seeds", "1", "--data_root", root, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == out
    harness = json.loads(next(ln for ln in lines if ln.startswith("{")))
    assert set(out) == set(harness) | {"quality"}
    for v in ("exact_f32", "fast_r2", "fast_bf16mm", "fast_trans_r3"):
        assert out[f"{v}_s"] > 0 and out[f"{v}_rtf"] > 0
    q = out["quality"]
    assert q["seeds"] == 1 and q["mode"] == "fast_bf16mm"
    assert all(np.isfinite(q[k]) for k in (
        "mean_abs_dSISDR", "mean_abs_dESTOI", "mean_abs_dPESQ"))
    assert sum(ln.startswith("  utt ") for ln in lines) == 3


def test_bench_serving_answers_every_request(capsys):
    out = script("bench_serving").main(
        ["--rates", "50", "--n", "3", "--niter", "2", "--seconds", "0.5",
         "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    (load,) = out["loads"]
    assert load["offered_req_s"] == 50 and load["achieved_req_s"] > 0
    assert 0 < load["p50_ms"] <= load["p95_ms"]
    assert 1 <= load["mean_batch"] <= 3


def test_warm_cache_counts_its_programs(capsys, monkeypatch):
    """On the CPU there is nothing to build: no nvcc is called, the JAX
    script's shape-grid flags are accepted, and its last line names the
    build directory."""
    from guided_vae_nmf_torch import _build

    def no_build():
        raise AssertionError("warm_cache built kernels for the CPU")

    monkeypatch.setattr(_build, "build_all", no_build)
    n = script("warm_cache").main(
        ["--buckets", "128", "--batch_size", "1", "--labels", "oracle,dnn",
         "--serving", "1", "--stream", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert n == 0
    assert out.splitlines()[-1] == (
        f"warmed 0 programs into {_build.build_dir()}")


def test_bench_vpu_runs_tiny(capsys):
    out = script("bench_vpu").main(
        ["--m", "4096", "--iters", "4", "--inner", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    ops = ["add", "exp", "log", "tanh", "recip"]
    for key in ("streamed_gelem_s", "fused_gelem_s", "hbm_share"):
        assert list(out[key]) == ops
    assert out["hbm_peak_gb_s"] == 3350.0 and out["backend"] == "cpu"


def test_pesq_battery_passes_its_expectations(capsys):
    rc = script("pesq_battery").main(["--engine", "first-party"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and summary["pass"] and summary["n_cases"] == 18
    assert summary["engines"] == {"first_party": True, "itu": False}
    assert summary["max_abs_delta"] <= summary["threshold"]


@pytest.mark.parametrize("case", [0, 6, 12])
def test_pesq_battery_first_party_is_jax(case):
    name, s, d = script("pesq_battery").battery()[case]
    got = script("pesq_battery").first_party_pesq()(16000, s, d, "wb")
    want = jax_script("pesq_battery").first_party_pesq()(16000, s, d, "wb")
    assert abs(got - want) <= 1e-6, name


@pytest.mark.parametrize("name,wheel", [("validate_pesq", "pesq"),
                                        ("validate_stoi", "pystoi")])
def test_validators_without_their_wheel(name, wheel, root, monkeypatch,
                                        capsys):
    monkeypatch.setitem(sys.modules, wheel, None)   # not importable
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    assert jax_script(name).main() == 0
    want = capsys.readouterr().out
    assert script(name).main(["--data_root",
                              os.path.join(root, "subset")]) == 0
    assert capsys.readouterr().out == want and "not importable" in want
