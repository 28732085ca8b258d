"""The port's HDF5 frame stores and frame datasets
(`guided_vae_nmf_torch/data/{h5io,datasets}.py`) against the JAX
package's, on the CPU: each package's writer read by the other's reader,
the two writers' files equal bit for bit (datasets, chunk shapes,
compression, attrs, train mean / std), `frame_batches` in the same order,
`H5StreamSource` chunks with a full-size tail, the stream `fit` against
JAX's (rtol 1e-4, atol 1e-5) and against the port's in-memory `fit` on a
one-chunk store (equal), the item-wise datasets, and the port importing
without h5py."""

import os
import pickle
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from guided_vae_nmf_torch.data import datasets as td
from guided_vae_nmf_torch.data import h5io as th
from guided_vae_nmf_torch.train import trainer as tt
from guided_vae_nmf_tpu.data import datasets as jd
from guided_vae_nmf_tpu.data import h5io as jh
from guided_vae_nmf_tpu.models import classifier_init
from guided_vae_nmf_tpu.train import trainer as jt
from test_torch_train_helpers import compare_dirs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, BS = 33, 32


def columns(seed, n, bins=F):
    rng = np.random.RandomState(seed)
    return (rng.gamma(0.7, 1.0, (bins, n)).astype(np.float32),
            (rng.rand(bins, n) > 0.7).astype(np.float32))


def write(mod, path, split, pieces, **kw):
    with mod.H5FrameWriter(path, split, F, F, attrs={"fs": 16000},
                           **kw) as w:
        for x, y in pieces:
            w.append(x, y)


def h5_contents(path):
    """{name: (data, chunks, compression, dtype)} and attrs of a store."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, d in f.items():
            out[name] = (d[...], d.chunks, d.compression, d.dtype)
        attrs = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
    return out, attrs


@pytest.mark.parametrize("chunk_frames", [1, 16])
def test_writers_write_the_same_file_and_read_across(tmp_path,
                                                     chunk_frames):
    pieces = [columns(i, n) for i, n in enumerate((40, 7, 25))]
    paths = {}
    for tag, mod in (("jax", jh), ("port", th)):
        paths[tag] = str(tmp_path / f"{tag}.h5")
        write(mod, paths[tag], "train", pieces, chunk_frames=chunk_frames)
        write(mod, paths[tag], "validation", pieces[:1],
              chunk_frames=chunk_frames, track_stats=False)
    cj, aj = h5_contents(paths["jax"])
    cp, ap = h5_contents(paths["port"])
    assert aj == ap
    assert sorted(cj) == sorted(cp) == [
        "X_train", "X_train_mean", "X_train_std", "X_validation",
        "Y_train", "Y_validation"]
    for name in cj:
        assert cj[name][1:] == cp[name][1:], name
        assert np.array_equal(cj[name][0], cp[name][0]), name
    X = np.concatenate([x for x, _ in pieces], 1)
    for reader, path in ((jh.H5FrameReader, paths["port"]),
                         (th.H5FrameReader, paths["jax"])):
        r = reader(path, "train")
        Xr, Yr = r.load_all()
        assert np.array_equal(Xr, X.T) and r.n_frames == X.shape[1]
        np.testing.assert_allclose(r.mean[:, 0], X.mean(1), rtol=1e-6)
        assert r.attrs["X_chunks"].tolist() == [F, chunk_frames]
        r.close()


def test_frame_batches_same_order():
    X = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    Y = -X
    for kw in ({}, {"drop_remainder": False}):
        got = list(th.frame_batches(X, Y, 10,
                                    key=np.random.RandomState(4), **kw))
        ref = list(jh.frame_batches(X, Y, 10,
                                    key=np.random.RandomState(4), **kw))
        assert len(got) == len(ref) == (10 if not kw else 11)
        for (a, b), (c, d) in zip(got, ref):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    assert [x[0, 0] for x, _ in th.frame_batches(X, None, 50)] == [0, 150]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store of 200 train frames (33 bins, classifier-like labels) and
    64 validation frames, lzf, chunks of 16 frames."""
    path = str(tmp_path_factory.mktemp("store") / "s.h5")
    x, y = columns(10, 200)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    write(th, path, "train", [(x, y)], chunk_frames=16)
    xv, yv = columns(11, 64)
    write(th, path, "validation", [(xv, yv)], chunk_frames=16,
          track_stats=False)
    return path


def test_stream_source_chunks_with_full_size_tail(store):
    src = th.H5StreamSource(store, "train", chunk_frames=64, seed=3)
    ref = jh.H5StreamSource(store, "train", chunk_frames=64, seed=3)
    assert src._starts == ref._starts == [0, 64, 128, 136]
    for epoch in (1, 2):
        got = list(src.epoch_chunks(epoch))
        want = list(ref.epoch_chunks(epoch))
        assert len(got) == len(want) == 4
        for (a, b), (c, d) in zip(got, want):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    small = th.H5StreamSource(store, "train", chunk_frames=1024)
    assert small.chunk_frames == 200 and small.n_chunks == 1
    for s in (src, ref, small):
        s.close()


def test_stream_fit_matches_jax(store, tmp_path):
    tree = classifier_init(jax.random.PRNGKey(2), [F, [16, 16], F])
    host = jax.tree.map(np.asarray, tree)
    r = th.H5FrameReader(store, "validation")
    va = r.load_all()
    r.close()
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    cfg = dict(batch_size=BS, end_epoch=2, seed=5)
    jsrc = jh.H5StreamSource(store, "train", chunk_frames=64, seed=3)
    jt.fit(tree, "classifier", jsrc, va, jt.TrainConfig(**cfg), jdir, "C")
    psrc = th.H5StreamSource(store, "train", chunk_frames=64, seed=3)
    tt.fit(host, "classifier", psrc, va, tt.TrainConfig(**cfg), pdir, "C",
           device="cpu")
    jsrc.close()
    psrc.close()
    compare_dirs(jdir, pdir, rtol=1e-4, atol=1e-5)
    ragged = th.H5StreamSource(store, "train", 48)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        tt.fit(host, "classifier", ragged, va, tt.TrainConfig(**cfg), pdir,
               "C", device="cpu")
    ragged.close()


def test_stream_fit_of_one_chunk_equals_in_memory_fit(tmp_path):
    """One 192-frame chunk (6 batches) is the whole store in order: the
    stream path draws the in-memory path's permutation."""
    path = str(tmp_path / "one.h5")
    x, y = columns(12, 192)
    write(th, path, "train", [(x, y)], chunk_frames=64)
    tree = jax.tree.map(np.asarray, classifier_init(jax.random.PRNGKey(6),
                                                    [F, [16], F]))
    va = (x.T[:40].copy(), y.T[:40].copy())
    cfg = tt.TrainConfig(batch_size=BS, end_epoch=2)
    src = th.H5StreamSource(path, "train", chunk_frames=192)
    _, hs = tt.fit(tree, "classifier", src, va, cfg, str(tmp_path / "s"),
                   "C", device="cpu")
    src.close()
    _, hm = tt.fit(tree, "classifier", (x.T.copy(), y.T.copy()), va, cfg,
                   str(tmp_path / "m"), "C", device="cpu")
    assert [(h["train"], h["valid"]) for h in hs] == \
        [(h["train"], h["valid"]) for h in hm]
    compare_dirs(str(tmp_path / "s"), str(tmp_path / "m"), rtol=0, atol=0)


def test_frame_datasets_match_jax(store):
    rng = np.random.RandomState(0)
    specs = [rng.randn(4, n).astype(np.float32) for n in (3, 7, 5)]
    assert np.array_equal(td.collate_fn(specs), jd.collate_fn(specs))
    data, labels = columns(1, 9)
    for a, b in ((td.SpectrogramFrames(data), jd.SpectrogramFrames(data)),
                 (td.SpectrogramLabeledFrames(data, labels),
                  jd.SpectrogramLabeledFrames(data, labels))):
        assert len(a) == len(b) == 9
        assert np.array_equal(np.asarray(a[4]), np.asarray(b[4]))
    ds = td.HDF5SpectrogramLabeledFrames(store, "train")
    ref = jd.HDF5SpectrogramLabeledFrames(store, "train")
    assert len(ds) == len(ref) == 200
    again = pickle.loads(pickle.dumps(ds))
    for i in (0, 57, 199):
        for got in (ds[i], again[i]):
            assert all(np.array_equal(g, r) for g, r in zip(got, ref[i]))


def test_port_imports_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import guided_vae_nmf_torch.cli, guided_vae_nmf_torch.train\n"
            "from guided_vae_nmf_torch.data import H5FrameReader\n"
            "try:\n"
            "    H5FrameReader('x.h5', 'train')\n"
            "except ImportError:\n"
            "    print('needs h5py')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs h5py"
