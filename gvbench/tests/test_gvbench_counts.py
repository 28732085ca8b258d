"""The benchmark's frozen copies and its arithmetic, on the CPU: work
counts by hand at small shapes, the batching rule, the union of intervals,
the traffic's dependence on the seed, the reference's Philox and TF32
rounding."""

import numpy as np
import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
import torch

from gvbench.harness import bounds, signals
from gvbench.harness.trace import union_length
from gvbench.reference.philox import philox4x32_10, streams
from gvbench.reference.precision import round_tf32

MCEM = {"niter": 3, "nsamples_E_step": 2, "burnin_E_step": 1,
        "nsamples_WF": 1, "burnin_WF": 1, "nmf_rank": 2}


def test_chain_work_by_hand():
    # V=3 valid frames of U=1 utterance, F=4, L=2, one hidden layer of 3,
    # K=2, R=2, 3 steps, E-mode with the NMF factors
    V, U, F, L, ws, K, R, steps = 3, 1, 4, 2, [3], 2, 2, 3
    per_step = 2 * (2 * 3 + 3 * 4) + 3 + 4 + 8 * 4 + 6 * 2     # 87
    flops = V * steps * per_step + V * 2 * K * F + 4 * K * V * F
    in_b = 4 * (2 * V * F + (U * K * F + K * V + V) + V + V * 3 + V * L
                + L * 3 + 0 + 0 + 3 * F + F)
    out_b = 4 * (V * L + V * F + 2 * U * K * F) + 4 * R * V * F
    assert bounds.chain_work(V, U, F, L, ws, K, R, steps, "e", False) == (
        flops, in_b + out_b)
    # the Vb form in WF mode: no K terms, Vb read, three (V, F) outputs
    flops = V * steps * per_step
    in_b = 4 * (2 * V * F + V * F + V + V * 3 + V * L + L * 3 + 3 * F + F)
    out_b = 4 * (V * L + 3 * V * F)
    assert bounds.chain_work(V, U, F, L, ws, 0, 0, steps, "wf", True) == (
        flops, in_b + out_b)


def test_sums_work_by_hand():
    V, U, R, F, K = 5, 2, 3, 4, 2
    assert bounds.sums_work(V, U, R, F, K, "h", False) == (
        V * F * (2 * K + 6 * R + 4 * K),
        4 * R * V * F + 4 * (V * F + U * K * F + K * V + V) + 8 * V * K)
    assert bounds.sums_work(V, U, R, F, 0, "g", True) == (
        V * F * (6 * R + 2),
        4 * R * V * F + 4 * (V * F + V + V * F) + 8 * V)


def test_batch_work_counts_valid_frames_only():
    shapes = {"F": 4, "L": 2, "ws": [3], "enc": [4, 3], "cls": None}
    a = bounds.batch_work(10, 2, shapes, MCEM, False, False)
    b = bounds.batch_work(20, 2, shapes, MCEM, False, False)
    # every term but the per-utterance W terms grows with the frames
    k1 = [bounds.chain_work(v, 2, 4, 2, [3], 2, 2, 3, "e", False)
          for v in (10, 20)]
    wf = [bounds.chain_work(v, 2, 4, 2, [3], 2, 0, 2, "wf", False)
          for v in (10, 20)]
    assert a["k1"][0] == 3 * k1[0][0] + wf[0][0]
    assert b["k1"][0] == 3 * k1[1][0] + wf[1][0]
    assert b["k1"][0] == 2 * a["k1"][0]
    assert a["flops"] > a["k1"][0] + a["k2"][0]


def test_bound_seconds():
    assert bounds.seconds(67e12, 0) == pytest.approx(1.0)
    assert bounds.seconds(0, 3.35e12) == pytest.approx(1.0)
    assert bounds.seconds(67e12, 6.7e12) == pytest.approx(2.0)


def test_union_length():
    assert union_length([]) == 0.0
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert union_length([(5, 6), (0, 10)]) == 10.0
    assert union_length([(0, 1), (1, 2)]) == 2.0


def test_plan_batches_rule():
    frames = [100, 300, 130, 600, 90, 520, 250, 1000] * 3
    plan = signals.plan_batches(frames, batch_size=16, seed=3)
    seen = sorted(i for idxs, _, _ in plan for i in idxs)
    assert seen == list(range(len(frames)))
    for idxs, n_pad, seeds in plan:
        assert all(signals.bucket(frames[i]) == n_pad for i in idxs)
        assert len(idxs) <= max(1, 16 * 512 // max(n_pad, 512))
        assert len(seeds) == len(idxs)
    assert [p[1] for p in plan] == sorted(p[1] for p in plan)
    # 1024 frames: 16 * 512 / 1024 = 8 rows a batch at most
    assert max(len(i) for i, n, _ in plan if n == 1024) <= 8
    again = signals.plan_batches(frames, batch_size=16, seed=3)
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(plan, again))


def test_frame_count_and_padding():
    # 16000 samples = 62.5 hops: one hop of zeros appended, 63 + 1 frames
    assert signals.frame_count(16000) == 1 + (16000 + 256) // 256
    assert signals.frame_count(256 * 64) == 1 + 64
    x = (np.arange(16000) % 200 - 100).astype(np.int16)
    x_b, mask = signals.padded([x, x[:8000]])
    assert x_b.dtype == np.int16 and mask.shape == (2, 128)
    assert x_b.shape[1] == 127 * 256 + 1024
    assert mask[0].sum() == signals.frame_count(16000)
    assert mask[1].sum() == signals.frame_count(8000)
    assert np.array_equal(x_b[0, 512:512 + 16000], x)
    assert np.array_equal(x_b[0, :512], x[1:513][::-1])      # reflect


def test_traffic_same_for_same_seed():
    spec = {"gamma_shape": 4, "mean": 4.0, "min": 1.0, "max": 12.0}
    a = signals.draw(2**31 + 5, 64, spec, [-5, 0, 5], 8.0, 30.0)
    b = signals.draw(2**31 + 5, 64, spec, [-5, 0, 5], 8.0, 30.0)
    c = signals.draw(11, 64, spec, [-5, 0, 5], 8.0, 30.0)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    # another seed: the same lengths, SNRs and gaps, in another order
    for x, y in zip(a[:2], c[:2]):
        assert np.array_equal(np.sort(x), np.sort(y))
        assert not np.array_equal(x, y)
    ga, gc = np.diff(a[3]), np.diff(c[3])
    assert np.isclose(a[3][-1] + 0, a[3][-1])
    assert 0.0 == a[3][0] and a[3][-1] < 30.0
    assert np.allclose(np.sort(np.append(ga, 30 - a[3][-1])),
                       np.sort(np.append(gc, 30 - c[3][-1])))
    lens = a[0] / signals.FS
    assert lens.min() >= 1.0 and lens.max() <= 12.0
    assert abs(lens.mean() - 4.0) < 0.2
    x1 = signals.mixtures(a[0][:2] // 8, a[1][:2], a[2][:2], "cpu")
    x2 = signals.mixtures(a[0][:2] // 8, a[1][:2], a[2][:2], "cpu")
    assert all(np.array_equal(p, q) for p, q in zip(x1, x2))
    assert all(p.dtype == np.int16 and len(p) == n
               for p, n in zip(x1, a[0][:2] // 8))


def test_sweep_schedule_same_for_same_seed():
    spec = {"gamma_shape": 4, "mean": 4.0, "min": 1.0, "max": 12.0}
    plans = []
    for seed in (77, 77, 78):
        lens, _, _, _ = signals.draw(seed, 256, spec, [-5, 0, 5])
        frames = [signals.frame_count(int(n)) for n in lens]
        plans.append(signals.plan_batches(frames, 16, 128, seed))
    same = [(list(i), n) for i, n, _ in plans[0]]
    assert same == [(list(i), n) for i, n, _ in plans[1]]
    # another seed: the same batch shapes (sizes and buckets)
    assert [(len(i), n) for i, n, _ in plans[0]] == [
        (len(i), n) for i, n, _ in plans[2]]


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32_10
    M = 0xFFFFFFFF
    for c, k, want in [
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((M, M, M, M), (M, M),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]:
        assert tuple(int(v) for v in philox4x32_10(c, *k)) == want


def test_cpu_streams_follow_the_generator():
    zn, u = streams(123, 2, 5, 3, 4, "cpu")
    g = torch.Generator().manual_seed(123)
    assert torch.equal(zn, torch.randn((2, 4, 5, 3), generator=g))
    assert torch.equal(u, torch.rand((2, 4, 5), generator=g))


def test_round_tf32():
    x = torch.randn(10000)
    r = round_tf32(x)
    assert torch.equal(round_tf32(r), r)
    assert float(((r - x) / x).abs().max()) <= 2.0**-11
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert torch.equal(round_tf32(torch.tensor([1 + 3 * 2**-11])),
                       torch.tensor([1 + 4 * 2**-11]))
