"""The port's multi-process runtime (guided_vae_nmf_torch/parallel/
multihost.py) on the CPU: `initialize` is a no-op without an address, and
a real 2-process `torch.distributed` gloo group (two spawned processes
joined through MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as JAX's
tests/parallel/test_multihost.py joins two processes through its
coordinator) splits a file list into disjoint, complete shards
(`shard_file_list`, against the JAX package's partition), sums 1.0 + 2.0
= 3.0 across the processes (`DistGroup.all_sum`), and runs one recording's
EM with its frames split over the two processes (`mcem_run(group=
DistGroup())`, each process its half from the global NMF init) equal to
the single-device run at var_RW=0 (rtol 2e-4 / atol 1e-6). The cluster
has a time limit of its own (120 s)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from guided_vae_nmf_torch.parallel import multihost, shard_file_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from guided_vae_nmf_torch.parallel import multihost, shard_file_list
from guided_vae_nmf_torch.parallel.sweep import _global_nmf_init
from guided_vae_nmf_torch.mcem import MCEMConfig
from guided_vae_nmf_torch.mcem.engine import fold_seed, mcem_run
from guided_vae_nmf_torch.models import dgm_init
multihost.initialize(timeout_s=60)
rank, world = multihost.process_index(), multihost.process_count()
assert world == 2 and multihost.is_multihost()
files = [f"u{{i}}" for i in range(5)]
print("SHARD", rank, ",".join(shard_file_list(files)), flush=True)
g = multihost.DistGroup()
print("ALL_SUM", rank, float(g.all_sum(torch.tensor([rank + 1.0]))[0]),
      flush=True)
F, N, y_dim = 65, 128, 8
model = dgm_init(torch.Generator().manual_seed(0), [F, y_dim, 8, [16]])
rng = np.random.RandomState(0)
X = torch.tensor(rng.rand(F, N).astype(np.float32) + 0.05)
y = torch.tensor((rng.rand(y_dim, N) > 0.5).astype(np.float32))
mask = torch.ones(N)
cfg = MCEMConfig(niter=3, nsamples_E_step=2, burnin_E_step=2,
                 nsamples_WF=2, burnin_WF=2, nmf_rank=3, var_RW=0.0)
W0, H0, g0 = _global_nmf_init(5, F, N, cfg, True, X.dtype, X.device)
s = slice(rank * N // 2, (rank + 1) * N // 2)
out = mcem_run(model, X[None, :, s], mask[None, s], y[None, :, s],
               [fold_seed(5, rank)], cfg, init_nmf=(W0[None], H0[None, :, s],
                                                   g0[None, s]), group=g)
ref = mcem_run(model, X[None], mask[None], y[None], [5], cfg)
for k in ("WFs", "H", "g"):
    np.testing.assert_allclose(out[k].numpy(), ref[k][..., s].numpy(),
                               rtol=2e-4, atol=1e-6, err_msg=k)
for k in ("W", "cost"):
    np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=2e-4,
                               atol=1e-6, err_msg=k)
print("FRAME_SPLIT_OK", rank, flush=True)
multihost.shutdown()
""".format(repo=REPO)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_is_a_noop_without_an_address(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert not multihost.is_multihost()
    files = [f"u{i}" for i in range(5)]
    assert shard_file_list(files) == files


def test_two_process_gloo_cluster():
    from guided_vae_nmf_tpu.parallel import shard_file_list as j_shard

    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"

    shards = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SHARD"):
                _, rank, files = line.split(" ", 2)
                shards[int(rank)] = files.split(",")
    files = [f"u{i}" for i in range(5)]
    assert sorted(shards[0] + shards[1]) == files
    assert not set(shards[0]) & set(shards[1])
    assert [shards[r] for r in (0, 1)] == [
        [str(f) for f in j_shard(files, r, 2)] for r in (0, 1)]
    for rank, out in enumerate(outs):
        assert f"ALL_SUM {rank} 3.0" in out, out[-2000:]
        assert f"FRAME_SPLIT_OK {rank}" in out, out[-2000:]


@pytest.mark.parametrize("rank,count", [(0, 3), (2, 3)])
def test_shard_file_list_takes_the_process_index(rank, count):
    files = list(np.arange(8).astype(str))
    got = shard_file_list(files, rank, count)
    assert got == list(np.array_split(np.asarray(files), count)[rank])
