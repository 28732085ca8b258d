"""Package rules of the PyTorch port: no module of `guided_vae_nmf_torch`
and not `chip_smoke.py` imports JAX or the JAX package, and the entry
points raise on a machine without a GPU unless the caller names the CPU."""

import ast
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from guided_vae_nmf_torch._device import resolve_device
from guided_vae_nmf_torch.http_serving import build_server
from guided_vae_nmf_torch.models import DGM, Classifier
from guided_vae_nmf_torch.pipeline import enhance_waveform
from guided_vae_nmf_torch.streaming import (
    MultiStreamM2Enhancer,
    StreamingM2Enhancer,
    StreamingSPPEnhancer,
    StreamingWienerEnhancer,
)
from guided_vae_nmf_torch.train import load_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "guided_vae_nmf_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "guided_vae_nmf_tpu")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_sources_do_not_name_the_jax_package_in_code():
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
                for arg in node.args:
                    if isinstance(arg, ast.Constant):
                        assert not str(arg.value).startswith(FORBIDDEN)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        load_model(ROOT / "artifacts" / "pretrained" / "M1")
    with pytest.raises(RuntimeError):
        enhance_waveform(None, np.zeros((1, 33536), np.int16),
                         np.ones((1, 128), np.float32))
    m2 = DGM([513, 513, 8, [16]])
    for make in (lambda: StreamingM2Enhancer(m2, label_mode="timo"),
                 lambda: StreamingWienerEnhancer(
                     Classifier([513, [16], 513])),
                 lambda: StreamingSPPEnhancer(),
                 lambda: MultiStreamM2Enhancer(m2, label_mode="timo"),
                 lambda: build_server(ROOT / "artifacts" / "pretrained",
                                      port=0, stream=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_meshes_take_the_cards_or_raise(no_gpu):
    """The multi-device package is guarded like the rest, and its default
    mesh takes the cards: without one it raises, never a CPU mesh."""
    from guided_vae_nmf_torch.parallel import data_parallel_mesh, make_mesh

    guarded = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"guided_vae_nmf_torch/parallel/mesh.py",
            "guided_vae_nmf_torch/parallel/sweep.py",
            "guided_vae_nmf_torch/parallel/multihost.py"} <= guarded
    for make in (make_mesh, data_parallel_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert data_parallel_mesh("cpu").shape == {"data": 1}


def _load_smoke(path):
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_a_gpu(no_gpu, capsys):
    assert _load_smoke(ROOT / "chip_smoke.py").main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_fails_alone_in_a_directory(tmp_path, monkeypatch,
                                               capsys):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _load_smoke(tmp_path / "chip_smoke.py").main([]) != 0
    assert capsys.readouterr().out == ""
