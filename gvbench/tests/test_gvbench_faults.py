"""A whole run with the timed path broken underneath, past the harness's
look for a chip: each fault a cell can have makes `correct` false. The
faults: a chain that returns its state unchanged; the M-step's sums over
half of the samples, the mean taken over the rest; an answer altered
where it is produced (PCM16). (One card: no exchange between chips.)"""

import pytest
import tiny

UNCHANGED = """
from guided_vae_nmf_torch.mcem import fused_engine
_real = fused_engine.mh_chain
def _stuck(dec_w, X2, WH, g, ypre, Z, Vs, seed=0, **kw):
    Z1, Vs1, extra = _real(dec_w, X2, WH, g, ypre, Z, Vs, seed, **kw)
    if kw.get('mode', 'e') == 'e':
        extra = (Vs[:, None].expand_as(extra[0]).contiguous(),) + extra[1:]
    return Z, Vs, extra
fused_engine.mh_chain = _stuck
"""

HALF = """
from guided_vae_nmf_torch.mcem import fused_engine
_real = fused_engine.nmf_sums
def _half(samples, *a, **kw):
    R = samples.shape[1]
    out = _real(samples[:, : R // 2].contiguous(), *a, **kw)
    return tuple(o * R / (R // 2) for o in out)
fused_engine.nmf_sums = _half
"""

ALTERED = """
from guided_vae_nmf_torch import pipeline
_real = pipeline._to_pcm16
def _off(w):
    out = _real(w).clone()
    out[0, 600:700] = out[0, 600:700] + 9
    return out
pipeline._to_pcm16 = _off
"""


@pytest.mark.parametrize("cell", ["tiny_m2.sweep", "tiny_m1.serve"])
@pytest.mark.parametrize("fault", ["none", "unchanged", "half", "altered"])
def test_fault_makes_correct_false(tmp_path, cell, fault):
    root = tiny.make_root(tmp_path)
    patch = {"none": "", "unchanged": UNCHANGED, "half": HALF,
             "altered": ALTERED}[fault]
    rc, line, err = tiny.run_cell(root, cell, seed=9, patch=patch)
    assert rc == 0, err[-3000:]
    assert line["correct"] is (fault == "none"), err[-3000:]
    assert list(line)[-1] == "checks"
