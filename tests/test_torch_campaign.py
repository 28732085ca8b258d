"""The port's campaign and training scripts (eval_campaign,
eval_classifier_context, campaign_tables, pretrain_subset, bench_train,
validate_parity) on the CPU, against the JAX package's scripts on a tiny
synthetic root in the campaign's layout (`chip_smoke.write_campaign_root`:
21 speech-like clean utterances of 1.5-1.8 s, 7 speakers):

- the splits, the test corpus (every wav and the manifest),
  `pretrain_subset`'s `load_subset_clean` / `build` /
  `clean_labeled_frames` and `eval_classifier_context`'s
  `build_utt_frames` / `stack_context` / `assemble` are JAX's bit for bit
  (numpy's global RNG drawn in the same order);
- `run_system` gives `enhance_files` / `enhance_files_wiener` JAX's
  keyword arguments for each of the 12 systems (both packages' sweeps
  monkeypatched; the port's `classifier=` is JAX's `classifier_params=`,
  and it adds `device=`);
- `campaign_tables` prints JAX's bytes on the committed records;
- `eval_campaign --smoke 1` (metrics on a thread pool), its record through
  `campaign_tables`, `eval_classifier_context` over its work,
  `pretrain_subset`, `bench_train` (with `--stream`) and `validate_parity`
  (`--engine ours` and the replayed-stream `--engine paired`, the port's
  half only) run end to end at `--device cpu`."""

import dataclasses
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import write_campaign_root

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = ("mixture", "m2dnn_reference", "m2dnn_real-noise",
           "m2dnn_impulse-noise", "wiener", "m1_spp", "m1spp_real-noise",
           "m1spp_impulse-noise", "m2oracle_reference",
           "m2oracle_real-noise", "m2vaddnn_real-noise",
           "m2vadoracle_real-noise")


def script(name):
    return importlib.import_module(f"guided_vae_nmf_torch.scripts.{name}")


def jax_script(name):
    """The JAX package's scripts/<name>.py as a module of its own (they
    import `_common` and each other by bare name from scripts/)."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(scripts, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def subset(tmp_path_factory):
    # 1.5 s at least: the babble family tiles 40 utterances over its
    # 60 s, and shorter ones leave silent stretches a window can land on
    return write_campaign_root(str(tmp_path_factory.mktemp("campaign")), 0,
                               (1.5, 1.8))


@pytest.fixture
def jax_ec(subset, monkeypatch):
    mod = jax_script("eval_campaign")
    monkeypatch.setattr(mod, "SUB", subset)
    return mod


def test_campaign_splits_match_jax(subset, jax_ec):
    got = script("eval_campaign").campaign_splits(subset)
    assert got == jax_ec.campaign_splits()
    assert [len(p) for p in got] == [9, 3, 9]


def test_campaign_splits_refuse_a_wrong_root(tmp_path):
    with pytest.raises(ValueError, match="9 / 3 / 9"):
        script("eval_campaign").campaign_splits(str(tmp_path))


def test_build_test_corpus_matches_jax(subset, jax_ec, tmp_path):
    ec = script("eval_campaign")
    tr, _, _ = ec.campaign_splits(subset)
    clean = [ec._load_clean(p) for p in tr]
    for c, j in zip(clean, (jax_ec._load_clean(p) for p in tr)):
        assert np.array_equal(c, j)
    want = jax_ec.build_test_corpus(str(tmp_path / "jax"), 2, (0.0, 5.0),
                                    clean)
    got = ec.build_test_corpus(str(tmp_path / "port"), 2, (0.0, 5.0), clean,
                               subset)
    assert got == want and len(got["entries"]) == 9 * 2 * 2
    names = sorted(os.listdir(tmp_path / "jax" / "corpus"))
    assert names == sorted(os.listdir(tmp_path / "port" / "corpus"))
    for name in names:
        assert (tmp_path / "jax" / "corpus" / name).read_bytes() == \
            (tmp_path / "port" / "corpus" / name).read_bytes(), name


@pytest.mark.parametrize("fn", ["load_subset_clean", "build",
                                "clean_labeled_frames"])
def test_pretrain_subset_frames_match_jax(subset, monkeypatch, fn):
    ps = script("pretrain_subset")
    jps = jax_script("pretrain_subset")
    monkeypatch.setattr(jps, "SUB", subset)
    got_tr, got_va = ps.load_subset_clean(subset)
    want_tr, want_va = jps.load_subset_clean()
    if fn == "load_subset_clean":
        got, want = got_tr + got_va, want_tr + want_va
        assert len(got) == 18
    elif fn == "build":
        noise = ps.synthetic_noise_bank(got_tr[:3], duration_sec=4)
        kw = dict(n_mix=2, snrs=(-5, 0, 5), include_clean=True,
                  label_quantile=0.98)
        got = ps.build(got_tr[:4], noise, 3, **kw)
        want = jps.build(want_tr[:4], noise, 3, **kw)
    else:
        got = ps.clean_labeled_frames(got_tr[:4], 0.98)
        want = jps.clean_labeled_frames(want_tr[:4], 0.98)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.fixture(scope="module")
def utt_frames(subset):
    ps = script("pretrain_subset")
    clean, _ = ps.load_subset_clean(subset)
    noise = ps.synthetic_noise_bank(clean[:3], duration_sec=4)
    kw = dict(n_mix=2, snrs=(-5, 0, 5), include_clean=True)
    got = script("eval_classifier_context").build_utt_frames(
        clean[:4], noise, 1, **kw)
    want = jax_script("eval_classifier_context").build_utt_frames(
        clean[:4], noise, 1, **kw)
    return got, want


def test_build_utt_frames_matches_jax(utt_frames):
    got, want = utt_frames
    assert len(got) == len(want) == 4 * 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_stack_context_and_assemble_match_jax(utt_frames, k):
    ctx = script("eval_classifier_context")
    jctx = jax_script("eval_classifier_context")
    utts, _ = utt_frames
    X = utts[0][0]
    assert np.array_equal(ctx.stack_context(X, k), jctx.stack_context(X, k))
    assert ctx.stack_context(X, k).shape == (X.shape[0], 513 * (2 * k + 1))
    mean, std = X.mean(0), X.std(0)
    for g, w in zip(ctx.assemble(utts, mean, std, k),
                    jctx.assemble(utts, mean, std, k)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _dispatch(mod, pipeline, sysname, tmp_path, monkeypatch, **extra):
    """run_system's call of the sweep with every loader faked: (the sweep's
    name, its positional arguments relative to the work dir, its keyword
    arguments, the model directories loaded)."""
    calls, loaded = [], []

    def sweep(fn):
        def fake(names, corpus, est, model, **kw):
            calls.append((fn, names, os.path.relpath(corpus, tmp_path),
                          os.path.relpath(est, tmp_path), model, kw))
        return fake

    def fake_load_model(path, kind=None, **kw):
        loaded.append((os.path.basename(path), kind, kw.get("y_dim", 513)))
        return "model"

    def fake_dnn_kw(models, cdir, *dev):
        return {("classifier" if dev else "classifier_params"): cdir,
                "mean": "mean", "std": "std", "features": "log-power",
                "dnn_threshold": 0.85}

    monkeypatch.setattr(pipeline, "enhance_files", sweep("enhance_files"))
    monkeypatch.setattr(pipeline, "enhance_files_wiener",
                        sweep("enhance_files_wiener"))
    monkeypatch.setattr(mod, "load_model", fake_load_model)
    monkeypatch.setattr(mod, "load_norm_stats", lambda d: ("mean", "std"))
    monkeypatch.setattr(mod, "_dnn_kw", fake_dnn_kw)
    mod.run_system(sysname, str(tmp_path), str(tmp_path / "models"),
                   ["a.wav", "b.wav"], 3, 2, 1, **extra)
    (call,) = calls
    return call, loaded


@pytest.mark.parametrize("sysname", SYSTEMS[1:] + ("m3_fancy",))
def test_run_system_gives_jax_arguments(sysname, jax_ec, tmp_path,
                                        monkeypatch):
    import guided_vae_nmf_torch.pipeline as pl
    import guided_vae_nmf_tpu.pipeline as jpl

    if sysname == "m3_fancy":
        with pytest.raises(SystemExit, match="unknown system"):
            script("eval_campaign").run_system(sysname, str(tmp_path), "m",
                                               [], 1, 1, 0, "cpu")
        return
    dev = torch.device("cpu")
    got, got_loaded = _dispatch(script("eval_campaign"), pl, sysname,
                                tmp_path, monkeypatch, dev=dev)
    want, want_loaded = _dispatch(jax_ec, jpl, sysname, tmp_path,
                                  monkeypatch)
    assert got_loaded == want_loaded
    kw, want_kw = dict(got[5]), dict(want[5])
    assert kw.pop("device") == dev
    if "classifier" in kw:
        kw["classifier_params"] = kw.pop("classifier")
    if "cfg" in kw:   # the two packages' MCEMConfig classes, field by field
        kw["cfg"] = dataclasses.asdict(kw["cfg"])
        want_kw["cfg"] = dataclasses.asdict(want_kw["cfg"])
    assert got[:5] == want[:5] and kw == want_kw
    assert got[3].endswith(f"{sysname}@s1")


@pytest.mark.parametrize("record", ["CAMPAIGN_r04.json", "CAMPAIGN_r05.json"])
@pytest.mark.parametrize("extra", [[], ["--by_family", "SI-SDR"]])
def test_campaign_tables_prints_jax_bytes(record, extra, capsys):
    argv = ["--json", os.path.join(ROOT, record), *extra]
    jax_script("campaign_tables").main(argv)
    want = capsys.readouterr().out
    script("campaign_tables").main(argv)
    got = capsys.readouterr().out
    assert got == want and "| system |" in got


@pytest.fixture
def thread_pool(monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    from guided_vae_nmf_torch.metrics import runner

    monkeypatch.setattr(runner, "metrics_pool",
                        lambda max_workers=8: ThreadPoolExecutor(2))


def test_eval_campaign_smoke_tables_and_context(subset, tmp_path, capsys,
                                                thread_pool):
    work = str(tmp_path / "work")
    base = ["--data_root", os.path.dirname(subset), "--device", "cpu",
            "--work", work]
    res = script("eval_campaign").main(
        ["--smoke", "1", "--epochs", "1", "--voices", "1", *base])
    out = capsys.readouterr().out
    assert '"campaign": "done"' in out.splitlines()[-1]
    for name in ("M1", "M2_ibm", "M2_vad", "classifier_ibm",
                 "classifier_vad", "wiener"):
        assert os.listdir(os.path.join(work, "models", name))
    assert set(res) >= {"config", "mixture", "m2dnn_reference"}
    assert len(res["m2dnn_reference"]["rows"]) == 9
    assert set(res["m2dnn_reference"]["f1_by_family"]) <= {
        "cafe", "car", "clatter", "babble"}
    record = os.path.join(work, "campaign_results.json")
    with open(record) as f:
        assert json.load(f)["config"]["systems"] == ["mixture",
                                                     "m2dnn_reference"]
    script("campaign_tables").main(["--json", record])
    tables = capsys.readouterr().out
    assert "M2 + DNN (reference parity)" in tables and "+0 dB" in tables
    ctx = script("eval_classifier_context").main(
        ["--contexts", "0,1", "--epochs", "1", "--train_voices", "1",
         *base])
    assert set(ctx) == {"config", "k0", "k1"}
    assert 0.0 <= ctx["k1"]["0.5"]["all"]["F1"] <= 1.0
    assert os.path.exists(os.path.join(work, "ctx", "context_f1.json"))


def test_pretrain_subset_writes_every_family(subset, tmp_path, capsys):
    out = str(tmp_path / "pretrained")
    script("pretrain_subset").main(
        ["--data_root", os.path.dirname(subset), "--epochs", "1", "--out",
         out, "--device", "cpu"])
    assert "frames: train" in capsys.readouterr().out
    for name in ("M1", "M2_ibm", "M2_vad", "classifier_ibm",
                 "classifier_vad", "wiener"):
        files = os.listdir(os.path.join(out, name))
        assert any(f.endswith(".ckpt.npz") for f in files), name
        if name in ("classifier_ibm", "classifier_vad", "wiener"):
            assert "trainset_mean.npy" in files


def test_bench_train_runs_small(subset, capsys):
    row = script("bench_train").main(
        ["--data_root", os.path.dirname(subset), "--epochs", "2",
         "--stream", "2", "--torch_baseline", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "skipping the torch baseline" in out
    assert json.loads(out.splitlines()[-1]) == row
    assert row["epochs"] == 2 and row["train_frames"] > 256
    assert row["steady_frames_per_s"] > 0
    assert row["stream_frames"] >= row["train_frames"]
    assert row["backend"] == "cpu"


@pytest.mark.parametrize("engine", ["ours", "paired"])
def test_validate_parity_ours_runs_small(subset, tmp_path, capsys, engine):
    argv = ["--data_root", os.path.dirname(subset), "--epochs", "1",
            "--niter", "2", "--engine", engine, "--work", str(tmp_path),
            "--device", "cpu"]
    if engine == "paired":
        argv += ["--seeds", "1"]
    script("validate_parity").main(argv)
    out = capsys.readouterr().out
    if engine == "ours":
        assert out.count(" OURS: SI-SDR ") == 3
    else:
        assert "the port's half only" in out and out.count("[paired]") == 3
        with open(tmp_path / "gate_paired_niter2.json") as f:
            rec = json.load(f)["0"]
        assert len(rec) == 3 and all(np.isfinite(r["ours"]).all()
                                     for r in rec.values())
