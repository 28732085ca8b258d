"""The port's multi-device layer (guided_vae_nmf_torch/parallel/ and the
`mesh=` / `data_parallel` paths) on the CPU, on meshes of 1, 2 and 4 CPU
devices (`make_mesh(devices=[cpu] * n)`: the split, the shard threads and
the in-process sums run for real on the host), held against the JAX
package's `parallel` on the root conftest's 8-way virtual CPU mesh and
against the port's unsharded paths:

- `shard_file_list` and the mesh-aware `plan_batches` give JAX's
  partitions and plans;
- the batch-sharded eager engine (`sharded_mcem_m1` / `_m2`, ragged B=5)
  equals the unsharded batch bit for bit; a fused shard equals the
  unsharded run of its rows with its generator bit for bit;
- `frame_sharded_mcem` / `grid_sharded_mcem` at var_RW=0 against the
  port's single-device `mcem_run` from the same global init (rtol 2e-4 /
  atol 1e-6, JAX's own tolerance for its psum reassociation) and against
  JAX's (the port's `_global_nmf_init` patched to return JAX's W0 / H0;
  the port's EM runs in float64, JAX's in float32: rtol 1e-3 / atol
  1e-5), with JAX's shape errors;
- `enhance_files(mesh=)` and `EnhancementService(mesh=)` on a mesh of one
  device equal the unsharded PCM bit for bit, and on the eager engine at
  2 and 4 devices within 1 LSB; the sharded pool tick equals dedicated
  streams;
  a data-parallel `fit` equals the single-device fit (bit for bit on one
  device, within 1e-6 on 2 and 4); `--data_parallel` through
  `gvnmf-torch` and the scripts;
- no fallback: a shard that raises makes the sharded call raise
  `ShardError` (a group's other members do not hang).
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from guided_vae_nmf_torch import _launches
from guided_vae_nmf_torch.data import read_wav_int16, write_wav
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.mcem.engine import (
    mcem_m1_batch,
    mcem_m2_batch,
    mcem_run,
)
from guided_vae_nmf_torch.mcem.fused_engine import mcem_batch_fused
from guided_vae_nmf_torch.models import dgm_init, module_from_params, vae_init
from guided_vae_nmf_torch.parallel import (
    LocalGroup,
    ShardError,
    frame_sharded_mcem,
    grid_sharded_mcem,
    make_mesh,
    pad_to_multiple,
    row_slices,
    run_shards,
    shard_batch,
    shard_file_list,
    sharded_mcem_fused,
    sharded_mcem_m1,
    sharded_mcem_m2,
)
from guided_vae_nmf_torch.parallel import sweep as t_sweep
from guided_vae_nmf_torch.pipeline import enhance_files, plan_batches

CPU = torch.device("cpu")
VAR0 = dict(rtol=2e-4, atol=1e-6)
JAX_VAR0 = dict(rtol=1e-3, atol=1e-5)
SMALL = dict(niter=2, nsamples_E_step=2, burnin_E_step=2, nsamples_WF=2,
             burnin_WF=2, nmf_rank=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Shard threads run on top of the test workers: one intra-op thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n, **kw):
    return make_mesh(devices=[CPU] * n, **kw)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def rand(seed, *shape, lo=0.05):
    return torch.as_tensor(np.random.RandomState(seed).rand(*shape)
                           .astype(np.float32) + lo)


def labels(seed, *shape):
    return torch.as_tensor((np.random.RandomState(seed).rand(*shape) > 0.5)
                           .astype(np.float32))


# ---------------------------------------------------------------------------
# Mesh, file lists, plans
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_axes():
    m = cpu_mesh(4)
    assert m.shape == {"data": 4} and m.devices.size == 4
    g = cpu_mesh(4, axis_names=("data", "frame"), shape=(2, 2))
    assert g.shape == {"data": 2, "frame": 2}
    assert len(g.axis_devices("frame")) == 2
    assert pad_to_multiple(5, 4) == 8 and pad_to_multiple(8, 4) == 8
    assert row_slices(5, 2) == [slice(0, 3), slice(3, 5)]
    parts = shard_batch(m, {"x": torch.arange(8.0)[:, None], "y": None})
    assert [p["x"].ravel().tolist() for p in parts] == [[0, 1], [2, 3],
                                                        [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divide"):
        shard_batch(m, torch.zeros(5, 1))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


@pytest.mark.parametrize("n_files,count", [(10, 4), (5, 2), (3, 4),
                                           (7, 1)])
def test_shard_file_list_matches_jax(n_files, count):
    from guided_vae_nmf_tpu.parallel import shard_file_list as j_shard

    files = [f"u{i}.wav" for i in range(n_files)]
    shards = [shard_file_list(files, i, count) for i in range(count)]
    assert shards == [j_shard(files, i, count) for i in range(count)]
    assert [f for s in shards for f in s] == files
    assert shard_file_list(files) == files        # one process


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_plan_batches_matches_jax(n_dev):
    from guided_vae_nmf_tpu.pipeline import plan_batches as j_plan

    rng = np.random.RandomState(3)
    frames = [int(v) for v in rng.randint(40, 1400, size=23)]
    files = [f"u{i:02d}.wav" for i in range(23)]
    got = plan_batches(files, frames, 16, 128, n_dev, 0)
    want = j_plan(files, frames, 16, 128, n_dev, 0)
    assert [(p, n) for p, n, _ in got] == [(list(p), n) for p, n, _ in want]
    if n_dev > 1:
        # every batch but the last pooled one divides the mesh
        assert all(len(p) % n_dev == 0 for p, _, _ in got[:-1])
    # seeds follow the list index, whatever the plan
    by_file = {f: s for p, _, sd in got for f, s in zip(p, sd)}
    single = {f: s for p, _, sd in plan_batches(files, frames, 16, 128)
              for f, s in zip(p, sd)}
    assert by_file == single


# ---------------------------------------------------------------------------
# The shard runner and the in-process sum
# ---------------------------------------------------------------------------


def test_local_group_sums_in_shard_order():
    mesh = cpu_mesh(3)
    group = LocalGroup(3, CPU)
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, 2.0]),
             torch.tensor([-1e8, 3.0])]

    def shard(i, d):
        m = group.member(i)
        return m.all_sum(parts[i]), m.all_sum(parts[i] * 2)

    out = run_shards(mesh, shard, groups=(group,))
    want = (parts[0] + parts[1]) + parts[2]
    for a, b in out:
        assert torch.equal(a, want) and torch.equal(b, 2 * want)
    assert out[0][0] is not out[1][0]      # each shard gets its own copy


def test_a_failing_shard_raises_and_releases_its_group():
    mesh = cpu_mesh(4)
    group = LocalGroup(4, CPU)

    def shard(i, d):
        if i == 2:
            raise FloatingPointError("shard 2 broke")
        return group.member(i).all_sum(torch.ones(1))

    with pytest.raises(ShardError, match="shard 2") as info:
        run_shards(mesh, shard, groups=(group,))
    assert isinstance(info.value.__cause__, FloatingPointError)


def test_launch_counts_are_thread_safe_and_per_thread():
    """16 threads (more than this machine's cores) counting at a shortened
    switch interval: no increment is lost, and each thread's own count is
    its own."""
    import sys

    class W:
        launches = {"a": 0}

    n_threads, n = 16, 2000
    per = [None] * n_threads

    def worker(i):
        with _launches.per_thread() as c:
            for _ in range(n):
                _launches.count(W, "w", "a")
        per[i] = c

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert W.launches == {"a": n_threads * n}
    assert per == [{"w": {"a": n}}] * n_threads


# ---------------------------------------------------------------------------
# Batch-sharded engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("family", ["m1", "m2"])
def test_sharded_eager_equals_unsharded(family, n_dev):
    """Ragged B=5: padded with row 0 inside, trimmed on return; the eager
    engine's rows do not depend on their batch, so bit for bit."""
    B, F, N, y_dim = 5, 33, 16, 6
    X, mask = rand(0, B, F, N), torch.ones(B, N)
    seeds = [11 * b + 1 for b in range(B)]
    cfg = MCEMConfig(**SMALL)
    if family == "m1":
        model = vae_init(gen(0), [F, 4, [16]])
        ref = mcem_m1_batch(model, X, mask, seeds, cfg)
        out = sharded_mcem_m1(cpu_mesh(n_dev), model, X, mask, seeds, cfg)
    else:
        model = dgm_init(gen(0), [F, y_dim, 4, [16]])
        y = labels(1, B, y_dim, N)
        ref = mcem_m2_batch(model, X, mask, y, seeds, cfg)
        out = sharded_mcem_m2(cpu_mesh(n_dev), model, X, mask, y, seeds, cfg)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_fused_shards_equal_their_rows(n_dev):
    """Each shard is the fused engine on its rows with a generator seeded
    from its first row's seed; on one device that is the unsharded batch.
    WFs + WFn = 1."""
    B, F, N, y_dim = 4, 65, 32, 10
    model = dgm_init(gen(1), [F, y_dim, 8, [16, 16]])
    X, mask, y = rand(2, B, F, N), torch.ones(B, N), labels(3, B, y_dim, N)
    seeds = [101, 202, 303, 404]
    cfg = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1,
                     nsamples_WF=2, burnin_WF=1, nmf_rank=3)
    out = sharded_mcem_fused(cpu_mesh(n_dev), model, X, mask, y, seeds, cfg)
    for s in row_slices(B, n_dev):
        ref = mcem_batch_fused(model, X[s], mask[s], y[s],
                               gen(seeds[s.start]), cfg)
        for k in ("WFs", "WFn", "W", "H", "g", "Z"):
            assert torch.equal(out[k][s], ref[k]), k
    assert_allclose((out["WFs"] + out["WFn"]).numpy(), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# Frame- and grid-sharded MCEM
# ---------------------------------------------------------------------------


def _long(F=129, N=256, y_dim=16, seed=0):
    model = dgm_init(gen(seed), [F, y_dim, 8, [32]])
    return (model, rand(seed, F, N), torch.ones(N),
            labels(seed + 1, y_dim, N))


VAR0_CFG = MCEMConfig(niter=5, nsamples_E_step=3, burnin_E_step=3,
                      nsamples_WF=3, burnin_WF=3, nmf_rank=4, var_RW=0.0)
KEYS = ("WFs", "WFn", "g", "cost", "W", "H")


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_frame_sharded_matches_single_device(n_dev):
    """var_RW=0: the chain is deterministic, so the sharded run equals
    single-device mcem_run from the same global init (`mcem_run` draws
    the init `_global_nmf_init` slices)."""
    model, X, mask, y = _long()
    out = frame_sharded_mcem(cpu_mesh(n_dev), model, X, mask, y, 42,
                             VAR0_CFG)
    ref = mcem_run(model, X[None], mask[None], y[None], [42], VAR0_CFG)
    for k in KEYS + ("Z",):
        assert out[k].shape == ref[k][0].shape, k
        assert_allclose(out[k].numpy(), ref[k][0].numpy(), **VAR0,
                        err_msg=k)


def _jax_dgm(F, y_dim, L, h):
    from guided_vae_nmf_tpu.models import dgm_init as j_dgm_init

    tree = j_dgm_init(jax.random.PRNGKey(0), [F, y_dim, L, h])
    return tree, module_from_params(tree)


def _patch_jax_init(monkeypatch):
    """The port's global NMF init replaced by JAX's draw for the same
    key (`seed` is the key's index into `KEY_TABLE`)."""
    from guided_vae_nmf_tpu.parallel.sweep import _global_nmf_init as j_init

    table = {}

    def init(seed, F, N, cfg, update_nmf, dtype, device):
        _, W0, H0, g0 = j_init(table[seed], F, N, cfg, update_nmf,
                               np.float32)
        return tuple(torch.tensor(np.asarray(a), dtype=dtype)
                     for a in (W0, H0, g0))

    monkeypatch.setattr(t_sweep, "_global_nmf_init", init)
    return table


def test_frame_sharded_matches_jax(monkeypatch):
    from guided_vae_nmf_tpu.mcem import MCEMConfig as JCfg
    from guided_vae_nmf_tpu.parallel import frame_sharded_mcem as j_frame
    from guided_vae_nmf_tpu.parallel import make_mesh as j_mesh

    F, N, y_dim = 129, 256, 16
    tree, model = _jax_dgm(F, y_dim, 8, [32])
    X, mask, y = rand(0, F, N), torch.ones(N), labels(1, y_dim, N)
    key = jax.random.PRNGKey(42)
    table = _patch_jax_init(monkeypatch)
    table[42] = key
    jcfg = JCfg(**{k: getattr(VAR0_CFG, k) for k in (
        "niter", "nsamples_E_step", "burnin_E_step", "nsamples_WF",
        "burnin_WF", "nmf_rank", "var_RW")})
    want = j_frame(j_mesh(), tree, X.numpy(), mask.numpy(), y.numpy(), key,
                   jcfg)
    got = frame_sharded_mcem(cpu_mesh(4), model, X, mask, y, 42, VAR0_CFG)
    for k in KEYS:
        assert_allclose(got[k].numpy(), np.asarray(want[k]), **JAX_VAR0,
                        err_msg=k)


def test_grid_sharded_matches_single_device_and_jax(monkeypatch):
    """(data, frame) = (2, 2): B=4 utterances, each against single-device
    mcem_run from its own init, and the whole against JAX's grid run on
    its (2, 4) mesh."""
    from guided_vae_nmf_tpu.mcem import MCEMConfig as JCfg
    from guided_vae_nmf_tpu.parallel import grid_sharded_mcem as j_grid
    from guided_vae_nmf_tpu.parallel import make_mesh as j_mesh

    B, F, N, y_dim = 4, 65, 128, 8
    tree, model = _jax_dgm(F, y_dim, 8, [32])
    X, mask, y = rand(5, B, F, N), torch.ones(B, N), labels(6, B, y_dim, N)
    cfg = MCEMConfig(niter=4, nsamples_E_step=3, burnin_E_step=3,
                     nsamples_WF=3, burnin_WF=3, nmf_rank=4, var_RW=0.0)
    mesh = cpu_mesh(4, axis_names=("data", "frame"), shape=(2, 2))
    seeds = [7, 8, 9, 10]
    out = grid_sharded_mcem(mesh, model, X, mask, y, seeds, cfg)
    assert out["WFs"].shape == (B, F, N)
    for b in range(B):
        ref = mcem_run(model, X[b:b + 1], mask[b:b + 1], y[b:b + 1],
                       [seeds[b]], cfg)
        for k in KEYS:
            assert_allclose(out[k][b].numpy(), ref[k][0].numpy(), **VAR0,
                            err_msg=f"utt {b}: {k}")

    keys = jax.random.split(jax.random.PRNGKey(11), B)
    table = _patch_jax_init(monkeypatch)
    # JAX's grid draws each utterance's init from the key its run splits
    for b in range(B):
        table[seeds[b]] = keys[b]
    jcfg = JCfg(niter=4, nsamples_E_step=3, burnin_E_step=3, nsamples_WF=3,
                burnin_WF=3, nmf_rank=4, var_RW=0.0)
    want = j_grid(j_mesh(axis_names=("data", "frame"), shape=(2, 4)), tree,
                  X.numpy(), mask.numpy(), y.numpy(), keys, jcfg)
    got = grid_sharded_mcem(mesh, model, X, mask, y, seeds, cfg)
    for k in KEYS:
        assert_allclose(got[k].numpy(), np.asarray(want[k]), **JAX_VAR0,
                        err_msg=k)


def test_grid_b1_reproduces_frame_sharded():
    model, X, mask, y = _long(F=33, N=512, y_dim=4, seed=3)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=2,
                     nsamples_WF=2, burnin_WF=2, nmf_rank=3, var_RW=0.0)
    out_f = frame_sharded_mcem(cpu_mesh(4), model, X, mask, y, 77, cfg)
    out_g = grid_sharded_mcem(
        cpu_mesh(4, axis_names=("data", "frame"), shape=(1, 4)), model,
        X[None], mask[None], y[None], [77], cfg)
    for k in KEYS:
        assert torch.equal(out_g[k][0], out_f[k]), k


@pytest.mark.parametrize("gain", [dict(), dict(noise_gain=True),
                                  dict(noise_gain=True,
                                       noise_gain_bands=4)],
                         ids=["spp", "gain", "gain_bands"])
def test_grid_sharded_fixed_noise(gain):
    """update_nmf=False with Vb_fixed (and the noise gain b, frame-local,
    per frame or per band) through the grid: each utterance equals its
    single-device run; b comes back with its bands intact."""
    B, F, N = 2, 33, 128
    model = vae_init(gen(4), [F, 4, [16]])
    X, Vb = rand(9, B, F, N), rand(10, B, F, N, lo=0.01) * 0.1
    X[:, :, 40:44] *= 60.0                   # impulsive frames
    mask = torch.ones(B, N)
    cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=2,
                     nsamples_WF=2, burnin_WF=2, var_RW=0.0, **gain)
    mesh = cpu_mesh(4, axis_names=("data", "frame"), shape=(2, 2))
    out = grid_sharded_mcem(mesh, model, X, mask, None, [1, 2], cfg,
                            update_nmf=False, Vb_fixed=Vb)
    for b in range(B):
        ref = mcem_run(model, X[b:b + 1], mask[b:b + 1], None, [b + 1],
                       cfg, update_nmf=False, Vb_fixed=Vb[b:b + 1])
        for k in ("WFs", "g") + (("b",) if "noise_gain" in gain else ()):
            assert out[k][b].shape == ref[k][0].shape, k
            assert_allclose(out[k][b].numpy(), ref[k][0].numpy(), **VAR0,
                            err_msg=k)
    if gain.get("noise_gain_bands"):
        assert out["b"].shape == (B, 4, N)


@pytest.mark.parametrize("case", ["frame_ragged", "grid_batch",
                                  "grid_frames", "frame_2d_axis"])
def test_shape_errors_match_jax(case):
    from guided_vae_nmf_tpu.mcem import MCEMConfig as JCfg
    from guided_vae_nmf_tpu.models import vae_init as j_vae_init
    from guided_vae_nmf_tpu.parallel import frame_sharded_mcem as j_frame
    from guided_vae_nmf_tpu.parallel import grid_sharded_mcem as j_grid
    from guided_vae_nmf_tpu.parallel import make_mesh as j_mesh

    tree = j_vae_init(jax.random.PRNGKey(0), [33, 4, [16]])
    model = module_from_params(tree)
    X = np.random.RandomState(1).rand(3, 33, 128).astype(np.float32) + 0.05
    jcfg, cfg = JCfg(**SMALL), MCEMConfig(**SMALL)
    if case == "frame_ragged":        # 102 frames on 8 (4) shards
        calls = [lambda: j_frame(j_mesh(), tree, X[0, :, :102],
                                 np.ones(102, np.float32), None,
                                 jax.random.PRNGKey(3), jcfg),
                 lambda: frame_sharded_mcem(cpu_mesh(4), model,
                                            X[0, :, :102], np.ones(102),
                                            None, 3, cfg)]
    elif case == "frame_2d_axis":     # 102 frames on the frame axis
        calls = [lambda: j_frame(j_mesh(axis_names=("data", "frame"),
                                        shape=(2, 4)), tree, X[0, :, :102],
                                 np.ones(102, np.float32), None,
                                 jax.random.PRNGKey(3), jcfg, axis="frame"),
                 lambda: frame_sharded_mcem(
                     cpu_mesh(4, axis_names=("data", "frame"), shape=(1, 4)),
                     model, X[0, :, :102], np.ones(102), None, 3, cfg,
                     axis="frame")]
    else:
        Xb = X if case == "grid_batch" else X[:2, :, :101]
        B, N = Xb.shape[0], Xb.shape[2]
        calls = [lambda: j_grid(j_mesh(axis_names=("data", "frame"),
                                       shape=(2, 4)), tree, Xb,
                                np.ones((B, N), np.float32), None,
                                jax.random.split(jax.random.PRNGKey(0), B),
                                jcfg),
                 lambda: grid_sharded_mcem(
                     cpu_mesh(4, axis_names=("data", "frame"), shape=(2, 2)),
                     model, torch.as_tensor(Xb), torch.ones(B, N), None,
                     list(range(B)), cfg)]
    for call in calls:
        with pytest.raises(ValueError, match="must divide"):
            call()


# ---------------------------------------------------------------------------
# enhance_files, the service, the stream pool
# ---------------------------------------------------------------------------


def _speech(seed, seconds):
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    s = 0.2 * np.sin(2 * np.pi * np.cumsum(
        150 + 40 * np.sin(2 * np.pi * 0.5 * t + seed)) / 16000)
    s *= np.clip(np.sin(2 * np.pi * 1.7 * t + seed), 0, None)
    x = s + 0.05 * rng.randn(n)
    return (np.clip(s, -1, 1) * 32767).astype(np.int16), \
        (np.clip(x, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def wav_set(tmp_path_factory):
    """Five mixtures of 0.9-1.6 s (one 128-frame bucket) and one of 3 s
    in another bucket."""
    root = tmp_path_factory.mktemp("in")
    files = []
    for i, sec in enumerate((0.9, 1.2, 1.6, 1.0, 1.4, 3.0)):
        s, x = _speech(i, sec)
        write_wav(str(root / f"u{i}_x.wav"), x, 16000)
        write_wav(str(root / f"u{i}_s.wav"), s, 16000)
        files.append(f"u{i}.wav")
    return str(root), files


@pytest.fixture(scope="module")
def m2_small():
    return dgm_init(gen(0), [513, 513, 8, [16]])


SWEEP_CFG = MCEMConfig(niter=2, nsamples_E_step=2, burnin_E_step=1,
                       nsamples_WF=2, burnin_WF=1, nmf_rank=3)


def _sweep(wav_set, model, out, files=None, **kw):
    root, all_files = wav_set
    files = all_files if files is None else files
    enhance_files(files, root, out, model, classif_type="oracle",
                  cfg=SWEEP_CFG, batch_size=4, **kw)
    return {f: read_wav_int16(os.path.join(out, f[:-4] + "_s_est.wav"))[0]
            for f in files}


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_enhance_files_mesh_of_one_equals_unsharded(wav_set, m2_small,
                                                    tmp_path, engine):
    a = _sweep(wav_set, m2_small, str(tmp_path / "a"), engine=engine,
               device="cpu")
    b = _sweep(wav_set, m2_small, str(tmp_path / "b"), engine=engine,
               mesh=cpu_mesh(1))
    for f in a:
        assert np.array_equal(a[f], b[f]), f


@pytest.mark.parametrize("n_dev", [2, 4])
def test_enhance_files_eager_sharded_equals_unsharded(wav_set, m2_small,
                                                      tmp_path, n_dev):
    """The eager engine's rows draw from their own seeds: one bucket's
    utterances (plans that differ only in their cuts) come out within the
    1 LSB the port allows a row alone against the row in a batch (its
    float64 EM; on the CPU the float64 label projection's products are
    blocked by the batch's shape, so a row alone, as on 4 shards, can
    move a sample by 1 LSB), the duplicate pad rows unwritten."""
    files = wav_set[1][:5]
    a = _sweep(wav_set, m2_small, str(tmp_path / "a"), files=files,
               engine="xla", device="cpu")
    b = _sweep(wav_set, m2_small, str(tmp_path / "b"), files=files,
               engine="xla", mesh=cpu_mesh(n_dev))
    for f in files:
        assert np.abs(a[f].astype(np.int32) - b[f]).max() <= 1, f
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        os.listdir(tmp_path / "a"))


def test_enhance_files_fused_mesh2_runs_each_shard(wav_set, m2_small,
                                                   tmp_path):
    """On the fused engine a mesh-aware plan seeds its shards from their
    first rows: outputs are finite, mixture-consistent and not the
    passthrough."""
    root, files = wav_set
    out = _sweep(wav_set, m2_small, str(tmp_path / "m"), engine="fused",
                 mesh=cpu_mesh(2))
    for i, f in enumerate(files):
        x, _ = read_wav_int16(os.path.join(root, f"u{i}_x.wav"))
        n, _ = read_wav_int16(str(tmp_path / "m" / f"u{i}_n_est.wav"))
        assert len(out[f]) == len(x) and np.any(out[f] != x)
        assert np.array_equal(np.clip(x.astype(np.int32) - out[f], -32768,
                                      32767), n)


def test_enhance_files_shard_failure_raises(wav_set, m2_small, tmp_path,
                                            monkeypatch):
    """No fallback: a shard that raises fails the sweep with ShardError;
    no utterance is retried alone or written as passthrough."""
    import guided_vae_nmf_torch.pipeline as pl

    real = pl.enhance_waveform

    def flaky(model, x_pad, mask, *a, **kw):
        if kw["seeds"][0] == kw_first[0]:
            raise RuntimeError("injected shard fault")
        return real(model, x_pad, mask, *a, **kw)

    root, files = wav_set
    plan = plan_batches(files[:4], [64] * 4, 4, 128, 2, 0)
    kw_first = [int(plan[0][2][2])]        # the second shard's first row
    monkeypatch.setattr(pl, "enhance_waveform", flaky)
    with pytest.raises(ShardError, match="injected") as info:
        _sweep(wav_set, m2_small, str(tmp_path / "f"), files=files[:4],
               engine="xla", mesh=cpu_mesh(2))
    assert isinstance(info.value.__cause__, RuntimeError)
    assert not (tmp_path / "f").exists() or not any(
        n.endswith("_s_est.wav") for n in os.listdir(tmp_path / "f"))


def test_enhance_waveform_sharded_needs_a_divisible_batch(m2_small):
    from guided_vae_nmf_torch.pipeline import enhance_waveform_sharded

    with pytest.raises(ValueError, match="must divide"):
        enhance_waveform_sharded(cpu_mesh(2), m2_small,
                                 np.zeros((3, 2048), np.int16),
                                 np.ones((3, 5), np.float32), SWEEP_CFG,
                                 seeds=[1, 2, 3], label_mode="ones")


@pytest.mark.parametrize("n_dev,engine", [(1, "fused"), (2, "xla")])
def test_service_mesh_equals_unsharded(n_dev, engine):
    """A request through the sharded service against the unsharded one:
    bit for bit on one device (the same batches and generators); on two,
    on the eager engine, within 1 LSB (its rows are their own)."""
    import dataclasses

    from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig

    model = vae_init(gen(2), [513, 8, [16]])
    sv = ServeConfig(label_mode="none", noise_model="nmf", max_wait_ms=1.0,
                     engine=engine)
    x = _speech(5, 1.1)[1].astype(np.float32) / 32768.0
    outs = []
    for mesh in (None, cpu_mesh(n_dev)):
        with EnhancementService(model, cfg=SWEEP_CFG,
                                serve=dataclasses.replace(sv),
                                mesh=mesh, device=None if mesh else "cpu") \
                as svc:
            outs.append(svc.enhance(x))
    a, b = (np.round(o["s"] * 32768) for o in outs)
    lsb = 0 if n_dev == 1 else 1
    assert np.abs(a - b).max() <= lsb
    assert outs[1]["batch_size"] == 1


@pytest.mark.parametrize("n_dev", [1, 2])
def test_pool_sharded_tick_equals_dedicated_streams(n_dev):
    """Full-lane sharded ticks (idle rows at k=0 keep their state): each
    lane equals its dedicated stream pushed the same pieces, through a
    recycled slot too."""
    from guided_vae_nmf_torch.streaming import (
        MultiStreamM2Enhancer, StreamingM2Enhancer)

    m2 = dgm_init(gen(3), [513, 513, 8, [32]])
    kw = dict(label_mode="timo", chunk_frames=4, context_frames=12,
              block_iters=2, e_steps=2)
    pool = MultiStreamM2Enhancer(m2, max_streams=4, mesh=cpu_mesh(n_dev),
                                 **kw)
    sigs = [_speech(10 + i, sec)[1].astype(np.float32) / 32768.0
            for i, sec in enumerate((0.5, 0.8, 0.3))]
    first = pool.open()
    pool.close(first)                        # recycled below
    sids = [pool.open() for _ in sigs]
    outs = {s: [] for s in sids}
    piece = 1100
    for lo in range(0, max(len(x) for x in sigs), piece):
        for s, x in zip(sids, sigs):
            if lo < len(x):
                pool.feed(s, x[lo:lo + piece])
        for s, o in pool.step().items():
            outs[s].append(o)
    for s in sids:
        outs[s].append(pool.flush(s))
    for s, x in zip(sids, sigs):
        enh = StreamingM2Enhancer(m2, device="cpu", **kw)
        ref = [enh.push(x[lo:lo + piece]) for lo in range(0, len(x), piece)]
        ref.append(enh.flush())
        got, want = np.concatenate(outs[s]), np.concatenate(ref)
        assert len(got) == len(want) == len(x)
        assert_allclose(got, want, atol=2e-5, rtol=1e-4)
        assert pool._slot(s)._ctx_b.shape == enh._ctx_b.shape


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    X = (rng.rand(384, 33) * 2).astype(np.float32)
    Y = (rng.rand(384, 6) > 0.5).astype(np.float32)
    return (X, Y), (X[:128], Y[:128])


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_fit_data_parallel_equals_single_device(frames, tmp_path, n_dev):
    """The batch's draws are taken once and split by rows; the shards'
    gradients are weighted by their share and summed in order: bit for
    bit on one device, within 1e-6 (float sums' order) on 2 and 4."""
    from guided_vae_nmf_torch.train import TrainConfig, train_m2

    cfg = TrainConfig(batch_size=64, end_epoch=2)
    (tr, va) = frames
    base, h0 = train_m2(tr, va, dims=(33, 6, 4, (16,)), cfg=cfg,
                        model_dir=str(tmp_path / "a"), device="cpu")
    dp, h1 = train_m2(tr, va, dims=(33, 6, 4, (16,)), cfg=cfg,
                      model_dir=str(tmp_path / "b"), mesh=cpu_mesh(n_dev))
    want = dict(base.named_parameters())
    for k, p in dp.named_parameters():
        if n_dev == 1:
            assert torch.equal(p, want[k]), k
        else:
            assert_allclose(p.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    for a, b in zip(h0, h1):
        assert a["train"] == pytest.approx(b["train"], rel=1e-6)
        assert a["valid"] == pytest.approx(b["valid"], rel=1e-6)


def test_fit_data_parallel_classifier_counts_add(frames, tmp_path,
                                                monkeypatch):
    """Classifier aux counts (tp / tn / fp / fn) add over shards, so the
    validation F1 is the single-device one. A batch that does not divide
    the mesh (50 on 4 shards) takes JAX's small-set loop, with uneven
    shards."""
    from guided_vae_nmf_torch.train import TrainConfig, train_classifier
    from guided_vae_nmf_torch.train import trainer as tt

    (X, Y), (Xv, Yv) = frames
    logs = []
    for sub, mesh in (("a", None), ("b", cpu_mesh(4))):
        train_classifier((X[:120], Y[:120]), (Xv, Yv),
                         dims=(33, (16,), 6),
                         cfg=TrainConfig(batch_size=60, end_epoch=1),
                         model_dir=str(tmp_path / sub), mesh=mesh,
                         device=None if mesh else "cpu")
        logs.append(open(tmp_path / sub / "output_epoch.log").read())
    f1 = [float(s.split("F1: ")[1]) for s in logs]
    assert f1[0] == pytest.approx(f1[1], abs=1e-4)

    calls = []
    real = tt.frame_batches

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(tt, "frame_batches", counted)
    _, hist = train_classifier((X[:120], Y[:120]), (Xv, Yv),
                               dims=(33, (16,), 6),
                               cfg=TrainConfig(batch_size=50, end_epoch=1),
                               model_dir=str(tmp_path / "c"),
                               mesh=cpu_mesh(4))
    assert calls and set(calls) == {50}
    assert np.isfinite(hist[0]["train"]) and hist[0]["train"] > 0


# ---------------------------------------------------------------------------
# --data_parallel through the command line and the scripts
# ---------------------------------------------------------------------------


def test_cli_train_data_parallel_on_the_cpu(tmp_path):
    """`gvnmf-torch train --data_parallel --device cpu` trains over a
    mesh of the one named device: the same checkpoints as without."""
    from guided_vae_nmf_torch import cli
    from guided_vae_nmf_torch.data.h5io import H5FrameWriter

    rng = np.random.RandomState(1)
    h5 = str(tmp_path / "x.h5")
    for split, n in (("train", 300), ("validation", 60)):
        with H5FrameWriter(h5, split) as w:
            w.append((rng.rand(513, n) * 2).astype(np.float32),
                     (rng.rand(513, n) > 0.5).astype(np.float32))
    logs = []
    for sub, extra in (("a", []), ("b", ["--data_parallel"])):
        cli.main(["train", "wiener", "--h5", h5, "--out",
                  str(tmp_path / sub), "--epochs", "1", "--h_dim", "16",
                  "--device", "cpu", *extra])
        logs.append(open(tmp_path / sub / "output_epoch.log").read())
    assert logs[0] == logs[1]


def test_build_server_data_parallel_on_the_cpu():
    from guided_vae_nmf_torch.http_serving import build_server

    srv = build_server("artifacts/pretrained", port=0, niter=1,
                       data_parallel=True, pooled_streams=True,
                       max_streams=3, device="cpu")
    try:
        assert srv._service._mesh.shape == {"data": 1}
        assert srv._stream_driver._pool.mesh.shape == {"data": 1}
    finally:
        srv.close_all()


def test_scripts_shard_balance_and_multistream_on_cpu_meshes():
    from guided_vae_nmf_torch.scripts import bench_multistream
    from guided_vae_nmf_torch.scripts import bench_shard_balance

    res = bench_shard_balance.main(["--utts", "22", "--niter", "1",
                                   "--cpu", "1"])
    assert res["n_dev"] == 8 and res["dup_share"] < 0.10
    assert res["lsb"] <= 4
    rows = bench_multistream.main(["--streams", "2", "--seconds", "0.3",
                                   "--block_iters", "1", "--e_steps", "1",
                                   "--data_parallel", "1", "--device",
                                   "cpu"])
    assert rows[0]["pool_size"] == 2


def test_shard_balance_defaults_to_the_cards(monkeypatch):
    # with no `--cpu` the script builds a mesh of every card: without one
    # it raises before any work, with no fallback to the CPU
    from guided_vae_nmf_torch.scripts import bench_shard_balance

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_shard_balance.main(["--utts", "2", "--niter", "1"])


def test_bench_sweep_on_a_synthetic_data_root(tmp_path, capsys):
    """bench_sweep over a set in the reference layout: oracle labels,
    cold then warm, one JSON line."""
    import json

    from guided_vae_nmf_torch.scripts import bench_sweep

    raw = tmp_path / "subset" / "raw" / "CSR-1-WSJ-0" / "WAV" / "wsj0" / \
        "si_et_05" / "440"
    proc = tmp_path / "subset" / "processed" / "CSR-1-WSJ-0" / "WAV" / \
        "wsj0" / "si_et_05" / "440"
    raw.mkdir(parents=True)
    proc.mkdir(parents=True)
    for i, sec in enumerate((0.6, 0.9)):
        s, x = _speech(20 + i, sec)
        write_wav(str(raw / f"a{i}.wav"), s, 16000)
        for suf, sig in (("_s", s), ("_x", x), ("_n", x - s)):
            write_wav(str(proc / f"a{i}{suf}.wav"), sig, 16000)
    row = bench_sweep.main(["--data_root", str(tmp_path), "--n", "3",
                            "--batch_size", "4", "--niter", "1",
                            "--nsamples_E_step", "1", "--burnin_E_step",
                            "1", "--nsamples_WF", "1", "--burnin_WF", "1",
                            "--fast", "0", "--device", "cpu"])
    assert row["utterances"] == 3 and row["rtf_warm"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == row
