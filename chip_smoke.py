#!/usr/bin/env python3
"""Drive the PyTorch port's enhancement paths on one NVIDIA GPU: the M2-IBM
main path (NMF noise model), the fixed-noise path (the real-noise and
impulse-noise profiles), fast mode, the rest of the offline pipeline
(oracle labels, the Wiener-DNN baseline, enhance_batch, the eager MCEM
engine and serving on it), the online service with its HTTP front end,
streaming (the Wiener, SPP and M2 stream enhancers, the multi-stream pool,
its driver and the HTTP stream route), the evaluation protocol (the
`gvnmf-torch` command line, the evaluate / run_metrics scripts and the
metrics), training (`gvnmf-torch dataset` / `train` for the four model
families at the shipped widths), and the paper-config path (PEEM,
the PEEM -> MCEM hybrid and the 500-iteration harness, whose fast_bf16mm
variant runs K1d).

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, in order; any failure exits nonzero without a result line:

1. device: CUDA is required; prints the card's name and power limit.
2. build: compiles `guided_vae_nmf_torch/csrc/*.cu` for sm_90a (timed)
   and the native host loader `csrc/gvnmf_native.cpp` with g++ (timed; a
   failed build fails the run; its batch rows held bit for bit against
   `_fill_row`'s Python rows and its STFT power against `stft`),
   with each kernel's registers and spills from ptxas, and K1's launch
   geometry (cluster size, CTAs, threads, shared memory a CTA, registers,
   resident clusters and waves at B=4, N=384 and at B=32, N=512) and K2's
   (CTAs, threads, shared memory, stages, frames a tile, CTAs an SM and
   the SMs occupied, in each mode and form at the same two shapes).
3. kernels vs plain versions, on the card, at full width (F=513, L=32,
   H=128, K=10, the shipped M2-IBM decoder, seeded inputs) at B=2, N=256
   and at the paths' B=4, N=384: the MH chain in E- and WF-mode with the
   NMF factors (K1a) and with a given noise variance (K1b), under injected
   accept/reject noise and at var_RW=0, and the M-step sums in 'h' and 'g'
   mode in both forms (K2a, K2b); the same chains in fast mode (K1c:
   bfloat16 dumps and approximate reciprocal, and with the bit-arithmetic
   exp / log) under injected noise, and the sums over bfloat16 samples with
   the approximate reciprocal (K2c); the chain with bfloat16 decoder
   products (K1d, at the fast level) in both modes and forms, at K1D_TOL
   with the elements past TOL counted; then, at B=2, N=256, the accept
   rule under real uniforms and the in-kernel Philox stream.
4. main path: four synthetic speech-like mixtures (2-5 s, 5 dB SNR, int16)
   through `enhance_waveform(label_mode="dnn")` with the shipped M2-IBM and
   classifier weights and the default MCEMConfig (100 EM iterations), with
   the launch counters reset before and read after each run; the same
   mixtures as wav files through `enhance_files` (its rows assembled by
   the native loader, counted; its stage report printed); one short
   utterance on the card against the CPU path at var_RW=0; a profiled
   batch; the shipped M2-IBM and classifier as reference `.pt` state
   dicts through `load_model` on the card (the main batch's PCM equal to
   the `.ckpt.npz` models', 100 / 1 / 100 / 100 launches); and
   `ops.device_time_ms` on one main batch (its K1 total within 10 % of
   the profiled batch's) and `ops.profile_trace` (a trace naming K1).
5. fixed-noise path: the same wav files through
   `enhance_files(profile="real-noise")` (spp2, noise gain, soft
   guidance; 125 K1b E / 2 K1b WF / 125 K2b h / 125 K2b g launches a
   batch), the real-noise settings through `enhance_waveform` (timed), the
   impulse-noise settings (spp, 2-band gain) on mixtures with 20 ms noise
   bursts (100 / 1 / 100 / 100), one short utterance with the real-noise
   settings on the card against the CPU path at var_RW=0, and a profiled
   real-noise batch with the time of the SPP tracker and of `_ema_time`.
6. fast mode: the main batch through `enhance_waveform(fast=True)` and
   `fast="trans"` (100 / 1 / 100 / 100 fast launches and no exact one),
   x realtime beside the exact path's, |s + n - x| <= 2 LSB and SI-SDR
   against the exact output (no quality claim); and the real-noise
   settings with `fast="trans"` (125 / 2 / 125 / 125).
7. the rest of the offline pipeline, on the main batch: oracle labels
   from the clean tracks (`label_mode="oracle"`, 100 / 1 / 100 / 100 K1a
   / K2a launches; the card's labels against `make_labels("oracle")` on
   the host, at most one element apart an utterance; and
   `enhance_files(classif_type="oracle")`); the Wiener-DNN baseline
   (`enhance_files_wiener` with the shipped `wiener` checkpoint, on the
   card against the CPU, PCM within 2 LSB, and its batch program timed);
   `enhance_batch` on host spectrograms (fused: the main path's launches;
   the hybrid noise model: the eager engine, no launch); the eager engine
   (`engine="xla"`, no launch) timed and profiled; a 1 s utterance
   through the eager `mcem_run` under injected streams on the card
   against the CPU; and `EnhancementService(ServeConfig(engine="xla"))`:
   a request alone and co-batched within 1 LSB.
8. serving: `EnhancementService(ServeConfig(fast=True))` (spp noise model,
   dnn labels, shipped weights), warmed up, then 16 requests of 1-5 s from
   4 producer threads (100 E / 1 WF / 0 h / 100 g fast Vb-form launches a
   batch): requests/s, audio seconds per wall second, mean batch, p50 / p95
   latency; then the HTTP front end on port 0 (/v1/enhance, /healthz,
   /metrics); then streaming, on a 2.5 s speech-like mixture with three
   noise bursts and the shipped weights, every phase with the launch
   counters reset before and 0 K1 / K2 launches checked after: the
   Wiener stream (ragged pushes) within 2 LSB of `_wiener_waveform` on
   the card; the SPP stream's masks against `timo_mask` of the whole
   spectrogram; the M2 stream (dnn labels) in the `reference`,
   `real-noise`, `streaming-low-latency` and `streaming-192ms` profiles
   and `streaming-low-latency` with `lookahead` over 2.5 s: the tick
   wall (median, p95) against the chunk's duration and x realtime on the
   card, the card against the port on the CPU tick by tick (flipped hard
   labels and escalations counted and printed; PCM16 within 2 LSB where
   none flipped), and the device activities a tick and busy share of a
   profiled 0.5 s stream; a pool of 8 streams of 1-2 s (real-noise
   settings)
   fed ragged, interleaved pushes, each lane against a dedicated stream
   pushed the same pieces (atol 2e-5 / rtol 1e-4), audio s per wall s and
   the tick wall; `StreamPoolDriver` from 4 threads; and
   `build_server(stream=True)`: a chunked PCM16 POST to
   /v1/enhance_stream (200, X-Chunk-Frames, every sample) within 1 LSB of
   the enhancer called directly, counted in /stats.
9. evaluation protocol, on the main batch's four mixtures written as a
   reference-layout data root (`raw/` and `processed/.../si_et_05/`, the
   SNR pickle): `gvnmf-torch enhance <dir> <out>/` in-process (one padded
   batch: 100 / 1 / 100 / 100 K1a / K2a launches; PCM16 equal to
   `enhance_to_audio` with the same seed; x realtime with wav I/O and
   labels), `scripts.evaluate_M2_ibm` (dnn labels, MCEMConfig()) then
   `scripts.run_metrics_M2` and `scripts.run_metrics_mixture` through the
   spawn pool (one worker an utterance; every row finite; files/s,
   utterances/s, and the mean SI-SDR / SI-SIR / SI-SAR / ESTOI / PESQ-wb /
   F1 beside the mixture floor, no quality claim), the figures
   (`run_metrics(make_figures=True)`: one PNG an utterance; the
   `reconstruct_M1`, `reconstruct_dnn_classif`, `reconstruct_timo_classif`
   and `visualization` scripts on the same root with the shipped M1 and
   classifier), `energy_ratios_torch`
   on the card over the zero-padded batch against numpy (float32 within
   1e-3 dB, float64 within 1e-9 dB), `gvnmf-torch metrics` on one pair
   against the library's values, `gvnmf-torch stream --profile
   streaming-low-latency` on the 2.5 s burst mixture (0 K1 / K2 launches,
   PCM equal to `StreamingM2Enhancer` pushed the same chunks), and
   `gvnmf-torch doctor` (the card, both kernel libraries and the native
   loader found).
10. training, at the shipped widths (M1 513/32/(128, 128), M2
   513/513/32/(128, 128), classifier 513/(128, 128)/513, Wiener
   513/(128 x 5)/513), batch 128, Adam 1e-3: 48 speech-like clean
   utterances of 3-5 s and the synthetic noise bank as wavs, two
   `gvnmf-torch dataset` stores (noisy_labels, noisy_wiener_labels; where
   h5py is missing the stores' code runs over `MemH5`, an in-memory
   stand-in of h5py's File); `gvnmf-torch train <family> --epochs 3` for
   the four families (three checkpoints with the reference naming, both
   logs, the side-cars, finite losses, the training loss falling from
   epoch 1 to 3; steady epochs' wall and training frames/s); one M2 epoch
   profiled (device activities, busy share, host syncs counted by the
   CUDA sync debug mode); the classifier's and the Wiener DNN's `fit`, 2
   epochs from the same weights on the card and the CPU, and one M1 / M2
   step with z = mu on each (stated tolerances); a 4th M2 epoch through
   `--resume`, whose best checkpoint then drives the main batch (100 / 1
   / 100 / 100 K1a / K2a launches, |s + n - x| <= 2 LSB).
   Then multi-device (`parallel/`; one card, so no scaling is measured):
   `enhance_files(mesh=make_mesh())` on a mesh of the card, PCM equal to
   the unsharded sweep and its launches; the main batch on a virtual mesh
   of two shards on cuda:0 (`make_mesh(devices=[cuda:0] * 2)`, each shard
   its own thread and stream) through `enhance_waveform_sharded`: fused
   shards equal to their rows' unsharded runs bit for bit, 100 / 1 / 100
   / 100 launches a shard (`mesh.shard_launches`), |s + n - x| <= 2 LSB,
   and the eager engine equal to the unsharded batch; `frame_sharded_mcem`
   on one 10.5 s recording (virtual 2-mesh) and `grid_sharded_mcem` at
   B=2 on a (2, 2) virtual mesh, at var_RW=0 against single-device
   `mcem_run` (rtol 2e-4 / atol 1e-6); `EnhancementService(mesh=)` within
   1 LSB of the unsharded service and `MultiStreamM2Enhancer(mesh=)`
   lanes against dedicated streams; one data-parallel M2 epoch (equal on
   a mesh of one, within PR 10's card-against-CPU tolerance on two); and
   `multihost.initialize` at world size 1 with NCCL, an all-reduce and
   `shard_file_list`; each with its wall.
   Then the remaining scripts (`guided_vae_nmf_torch/scripts/`), each
   through its `main(argv)` on the card with the launch counters read
   around it, on the main batch as a data root (`write_eval_root`) and on
   a campaign-layout root of 21 utterances (`write_campaign_root`): (a)
   `bench_niter500` at B=32, N=512, 50 iterations with `--quality 1
   --seeds 1` (each variant's launches, K1d's on the `_mm16` keys); (b)
   `bench_long`, one 30-minute recording (112,501 frames, N=112,512 in
   one K1c / K2c launch a step), twice, the warm run's files equal to the
   cold run's, its peak device memory; (c) `bench_serving` at 2 and 8
   requests/s, 16 requests each, all answered; (d) `eval_real_noise`
   system by system, whole spp batches a system, its files equal to
   `enhance_files` / `enhance_files_wiener`'s; (e) `warm_cache` (12
   programs); (f) `eval_campaign --smoke 1` and `campaign_tables` on its
   record; (g) `eval_classifier_context`; (h) `pretrain_subset` and
   `bench_train`; (i) `validate_parity` (the port's half, fused and
   replayed-stream eager); (j) `pesq_battery` against the committed
   expectations; (k) `bench_vpu` at its default size and at 2^28
   elements, every streamed share of the HBM peak at 105 % or under.
11. paper-config path: `enhance_waveform(cfg=HybridConfig())` on the main
   batch (500 PEEM + 150 MCEM iterations and the WF chain; 150 / 1 / 150
   / 150 launches), with `fast=True` (the same on `_fast`) and with the
   spp noise model (150 K1b E / 1 WF / 150 K2b g); `PEEMConfig()` (no
   launch); one hybrid batch profiled (device activity only) with the
   wall time of its PEEM and MCEM stages; a 1 s utterance through
   `HybridConfig(niter=50, refine=10, var_RW=0)` on the card against the
   CPU path; and `bench_niter500.main` at B=4, N=384, 100 iterations,
   PEEM and a 25-iteration hybrid, which prints its JSON line (fast_bf16mm:
   100 K1d E + 1 K1d WF launches a run).
12. kernel times at the paths' shapes, every variant, beside their bounds
   and their plain versions' times: K1 by CUDA events; K2 as device time
   between two events inside a CUDA graph with the L2 as the main path
   leaves it (right after a K1 E launch), warm and cold, beside the
   CUDA-event time of back-to-back calls and the wrapper's host time a
   call; and K1a / K1b E and WF and K2a / K2b 'h' and 'g' at bench.py's
   B=32, N=512 beside their bounds.

Prints the card's name and power limit, a `{"kernels": [...]}` line, and
as its last line `{"ok": true, "device": {...}}`.
"""

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# K1d's bound: the dense bfloat16 tensor-core peak (NVIDIA data sheet) and
# 16 special-function results per clock per SM (Hopper architecture white
# paper), at the SM count and maximum SM clock the card reports.
PEAK_BF16_FLOPS = 989e12
SFU_PER_CLOCK_PER_SM = 16
TOL = dict(atol=2e-5, rtol=2e-4)
# K1d against its plain version: the two sum the same exact products in
# another order, and where that moves a hidden output (or an E-mode
# sample dump) across a bfloat16 rounding boundary the operand moves by
# one bfloat16 ulp, at most 2^-7 of it; through |wo| <= 0.52 of the
# shipped decoder that moves an exponent by at most 4e-3. So every element
# must lie within atol 2e-5 + rtol 2e-2 and at most 1 % of them past TOL;
# a kernel that skipped the rounding would put most of Vs past TOL.
K1D_TOL = dict(atol=2e-5, rtol=2e-2)
K1D_MAX_PAST = 0.01
# Lengths of the main path's synthetic mixtures: 2-5 s, so padding and
# frame masks are exercised (they pad to 384 frames).
MAIN_SECONDS = (2.1, 3.3, 4.2, 4.9)
# Launches a batch at the default MCEMConfig (100 EM iterations,
# spp2_pass1_niter 25): K1 E / WF chains and K2 'h' / 'g' passes, all in
# one form ('wh': NMF factors, K1a / K2a; 'vb': given noise variance,
# K1b / K2b) and at one level ('': exact; '_fast': fast=True, K1c / K2c;
# '_trans': fast="trans", whose sums passes are '_fast').
MAIN_LAUNCHES = dict(form="wh", e=100, wf=1, h=100, g=100)
REAL_NOISE_LAUNCHES = dict(form="vb", e=125, wf=2, h=125, g=125)
IMPULSE_LAUNCHES = dict(form="vb", e=100, wf=1, h=100, g=100)
SERVING_LAUNCHES = dict(form="vb", e=100, wf=1, h=0, g=100, level="_fast")
# The PEEM -> MCEM hybrid at HybridConfig() refines with 150 MCEM
# iterations; PEEM alone launches no kernel.
HYBRID_LAUNCHES = dict(form="wh", e=150, wf=1, h=150, g=150)
HYBRID_SPP_LAUNCHES = dict(form="vb", e=150, wf=1, h=0, g=150)
PEEM_LAUNCHES = dict(form="wh", e=0, wf=0, h=0, g=0)
# The paper-config harness's arguments here (a cut of its B=32, N=512,
# 500 iterations, so the script stays well inside its time limit).
HARNESS_ARGS = dict(batch=4, n=384, niter=100, peem=1, hybrid=25)
# Chain launch keys: mode, form, level ('', '_fast', '_trans'), and
# '_mm16' for the decoder products on bfloat16 operands (K1d).
CHAIN_VARIANTS = [f"{m}_{f}{lv}{mm}" for mm in ("", "_mm16")
                  for lv in ("", "_fast", "_trans")
                  for m, f in (("e", "wh"), ("wf", "wh"), ("e", "vb"),
                               ("wf", "vb"))]
# K1d as the harness's fast_bf16mm variant runs it: the fast level with
# bfloat16 products, in both modes and forms.
K1D_VARIANTS = [f"{m}_{f}_fast_mm16" for m, f in (
    ("e", "wh"), ("wf", "wh"), ("e", "vb"), ("wf", "vb"))]
# No entry point runs bfloat16 products at a given noise variance (the
# JAX package's only caller of the option, the harness, runs the NMF
# noise model), so these two are checked and timed but on no path.
OFF_PATH = ("mh_chain_e_vb_fast_mm16", "mh_chain_wf_vb_fast_mm16")
SUMS_VARIANTS = [f"{m}_{f}{lv}" for lv in ("", "_fast")
                 for m, f in (("h", "wh"), ("g", "wh"), ("h", "vb"),
                              ("g", "vb"))]


def expected_launches(form, e, wf, h, g, n_batches=1, level=""):
    """The launch counts (`launch_counts()` layout) of a path that runs
    the given launches a batch at `level`, over `n_batches` batches."""
    out = {"mh_chain": dict.fromkeys(CHAIN_VARIANTS, 0),
           "nmf_sums": dict.fromkeys(SUMS_VARIANTS, 0)}
    sums_level = "_fast" if level else ""
    for kern, mode, n, lv in (("mh_chain", "e", e, level),
                              ("mh_chain", "wf", wf, level),
                              ("nmf_sums", "h", h, sums_level),
                              ("nmf_sums", "g", g, sums_level)):
        out[kern][f"{mode}_{form}{lv}"] = n * n_batches
    return out


def fast_kw(torch, level):
    """The kernel options of a level ('', '_fast', '_trans', and
    '_fast_mm16' for K1d as the harness runs it)."""
    if not level:
        return {}
    kw = dict(samples_dtype=torch.bfloat16, approx_recip=True)
    if level == "_trans":
        kw["approx_trans"] = True
    if level.endswith("_mm16"):
        kw["matmul_dtype"] = torch.bfloat16
    return kw


def harness_launches(niter, hybrid):
    """The launch counts of one `bench_niter500.main` run: each of its four
    variants runs twice (warm-up and timed) over `niter` EM iterations and
    a WF chain; the hybrid twice over `hybrid` fast MCEM iterations; PEEM
    launches nothing."""
    out = expected_launches("wh", 0, 0, 0, 0)
    for level, runs in (("", 2), ("_fast", 2), ("_trans", 2),
                        ("_fast_mm16", 2)):
        out["mh_chain"][f"e_wh{level}"] += runs * niter
        out["mh_chain"][f"wf_wh{level}"] += runs
        sums = "_fast" if level else ""
        out["nmf_sums"][f"h_wh{sums}"] += runs * niter
        out["nmf_sums"][f"g_wh{sums}"] += runs * niter
    out["mh_chain"]["e_wh_fast"] += 2 * hybrid
    out["mh_chain"]["wf_wh_fast"] += 2 if hybrid else 0
    out["nmf_sums"]["h_wh_fast"] += 2 * hybrid
    out["nmf_sums"]["g_wh_fast"] += 2 * hybrid
    return out


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def compare(name, got, ref, atol=TOL["atol"], rtol=TOL["rtol"]):
    """Max abs / rel error of got vs ref (float64 on the host); fails
    where |got - ref| > atol + rtol |ref|."""
    g = got.detach().double().cpu().numpy()
    r = ref.detach().double().cpu().numpy()
    check(g.shape == r.shape, f"{name}: shape {g.shape} vs {r.shape}")
    check(np.all(np.isfinite(g)), f"{name}: non-finite kernel output")
    err = np.abs(g - r)
    rel = err / np.maximum(np.abs(r), 1e-30)
    ok = bool(np.all(err <= atol + rtol * np.abs(r)))
    log(f"  {name:<28s} max_abs {err.max():.3e}  max_rel {rel.max():.3e}  "
        f"tol atol {atol:g} rtol {rtol:g}  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return float(err.max())


def compare_k1d(name, got, ref):
    """K1d output against its plain version at K1D_TOL, with at most
    K1D_MAX_PAST of the elements past TOL. Returns (max abs error, elements
    past TOL, elements)."""
    g = got.detach().double().cpu().numpy()
    r = ref.detach().double().cpu().numpy()
    check(g.shape == r.shape, f"{name}: shape {g.shape} vs {r.shape}")
    check(np.all(np.isfinite(g)), f"{name}: non-finite kernel output")
    err = np.abs(g - r)
    ok = bool(np.all(err <= K1D_TOL["atol"] + K1D_TOL["rtol"] * np.abs(r)))
    past = int(np.sum(err > TOL["atol"] + TOL["rtol"] * np.abs(r)))
    ok = ok and past <= K1D_MAX_PAST * g.size
    log(f"  {name:<28s} max_abs {err.max():.3e}  max_rel "
        f"{(err / np.maximum(np.abs(r), 1e-30)).max():.3e}  past TOL "
        f"{past} of {g.size}  tol atol {K1D_TOL['atol']:g} rtol "
        f"{K1D_TOL['rtol']:g}, <= {100 * K1D_MAX_PAST:g} % past TOL  "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: K1d disagrees with its plain version")
    return float(err.max()), past, g.size


def past_fraction(a, b):
    """Share of the elements of a past TOL from b."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    return float(np.mean(np.abs(a - b) > TOL["atol"] + TOL["rtol"]
                         * np.abs(b)))


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def time_cuda(fn, launches=10, reps=5):
    """Milliseconds per fn() on the card: CUDA events around `launches`
    back-to-back calls, so the device queue stays full and the wrapper's
    host work is hidden; median over `reps` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


# K2's kernel by name in a profile
K2_KERNEL_NAME = "nmf_sums_kernel"


def graph_ms(torch, fn, prep, launches=10):
    """Device milliseconds a launch of fn(s): one CUDA graph holds
    `launches` copies of [s = prep(), event, fn(s), event], where prep()
    enqueues the step that sets the L2 state and returns the samples
    (nothing: warm; a write of 4x the L2: cold; the K1 E launch that writes
    the samples: as the main path leaves it). The graph is replayed once to
    load it and once more to time it, so the wrapper's host work and the
    graph's first launch stay outside every event pair. Median of the
    pairs; `graph_floor_ms` reads a pair with no kernel between."""
    fn(prep())
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True, external=True)
           for _ in range(2)] for _ in range(launches)]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        for a, b in ev:
            s = prep()
            a.record()
            fn(s)
            b.record()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def graph_floor_ms(torch, launches=10):
    """`graph_ms` with no kernel between the two events."""
    return graph_ms(torch, lambda s: None, lambda: None, launches)


def host_us(torch, fn, calls=1000):
    """Host microseconds a call of fn(): the host clock over `calls` calls
    with no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def chain_inputs(torch, model, B, N, K, seed, device):
    """Seeded chain inputs at full width on the shipped decoder: X2 power
    frames, NMF factors, a given noise variance Vb, gains, binary labels ->
    ypre, Z ~ N(0, 1), Vs = decode(Z), and a mask whose last row ends 37
    frames early."""
    from guided_vae_nmf_torch.mcem.fused_engine import _dec_parts

    rng = np.random.RandomState(seed)
    dec = model.decoder
    F = dec.out.w.shape[1]
    L = dec.hidden[0].w.shape[0] - model.y_dim
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    y = t((rng.uniform(size=(B, N, model.y_dim)) > 0.5).astype(np.float32))
    l0 = dec.hidden[0]
    Z = t(rng.randn(B, N, L).astype(np.float32))
    mask = np.ones((B, N), np.float32)
    mask[-1, N - 37:] = 0.0
    return dict(
        dec_w=_dec_parts(dec, L),
        X2=t(rng.gamma(0.5, 2.0, (B, N, F)).astype(np.float32) + 1e-3),
        WH=(t(rng.uniform(0.01, 0.2, (B, K, F)).astype(np.float32)),
            t(rng.uniform(0.01, 1.0, (B, K, N)).astype(np.float32))),
        g=t(rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)),
        ypre=(y @ l0.w[L:] + l0.b).contiguous(), Z=Z,
        Vs=dec(torch.cat([Z, y], dim=-1)).contiguous(), mask=t(mask), L=L,
        Vb=t(rng.uniform(0.05, 1.5, (B, N, F)).astype(np.float32)))


def decisive_noise(torch, seed, B, N, L, n_steps, device):
    """Normals plus accept uniforms of 0 (log u = -inf, always accept) or
    inf (always reject): no decision can flip on rounding differences."""
    rng = np.random.RandomState(seed)
    zn = rng.randn(B, n_steps, N, L).astype(np.float32)
    u = np.where(rng.uniform(size=(B, n_steps, N)) < 0.5, 0.0, np.inf)
    return (torch.tensor(zn, device=device),
            torch.tensor(u.astype(np.float32), device=device))


def speech_like_mixtures(seed, seconds, fs=16000, snr_db=5.0, bursts=0):
    """int16 (clean, mixture) pairs: harmonic voiced tones with a gliding
    f0, formant-like spectral tilt and syllable-rate (~4 Hz) on/off
    amplitude modulation, plus low-passed noise at `snr_db`; `bursts`
    adds that many 20 ms white-noise bursts (8x the noise level) to each
    utterance's noise."""
    rng = np.random.RandomState(seed)
    out = []
    for sec in seconds:
        n = int(sec * fs)
        t = np.arange(n) / fs
        f0 = rng.uniform(100, 200) * (1 + 0.1 * np.sin(
            2 * np.pi * rng.uniform(0.2, 0.6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / fs
        s = np.zeros(n)
        for k in range(1, 30):
            fk = k * f0
            amp = np.exp(-((fk.mean() - 700) / 900) ** 2) / k ** 0.5
            s += np.where(fk < 7000, amp, 0.0) * np.sin(k * phase)
        syl = 0.5 - 0.5 * np.cos(2 * np.pi * rng.uniform(3, 5) * t)
        gate = (np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6)) > -0.6)
        s *= syl * gate
        noise = np.convolve(rng.randn(n), np.ones(4) / 4, mode="same")
        noise *= np.sqrt(np.mean(s**2) / np.mean(noise**2)
                         / 10 ** (snr_db / 10))
        level = noise.std()
        for _ in range(bursts):
            at = rng.randint(0, n - fs // 50)
            noise[at:at + fs // 50] += 8 * level * rng.randn(fs // 50)
        x = s + noise
        scale = 0.5 / np.max(np.abs(x))
        out.append((np.round(s * scale * 32767).astype(np.int16),
                    np.round(x * scale * 32767).astype(np.int16)))
    return out


def si_sdr(ref, est):
    ref = ref.astype(np.float64)
    est = est.astype(np.float64)
    a = np.dot(est, ref) / np.dot(ref, ref)
    e = est - a * ref
    return 10 * np.log10(np.sum((a * ref) ** 2) / np.sum(e**2))


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for one launch
# ---------------------------------------------------------------------------


def chain_bound(B, N, F, L, Hd, K, R, n_steps, mode, vb=False,
                sample_bytes=4):
    """(bound_ms, bound_by, flops, bytes) of one K1 launch. Operations per
    frame and step: the decoder's 2 (L Hd + Hd Hd + Hd F) multiply-adds,
    Hd (depth 2: 2 Hd) tanh and F exp, and per bin 8 more (g Vs + Vb,
    floor, reciprocal, log, X2 / Vx, two sums), plus, with the NMF factors
    (K1a), 2 K F per frame to form Vb; transcendentals count as one
    operation. Bytes: every input read once and every output written once;
    the Vb form (K1b) reads Vb (B, N, F) in place of Wt, H and the mask,
    and in E-mode writes s1, s2 (B, N, F) in place of numW, denW; the
    E-mode dumps take `sample_bytes` an element (2 for K1c's bfloat16).
    Fast mode computes the same function, so its operation count is the
    exact one's (an approximate exp or log counts as one operation)."""
    per_step = (2 * (L * Hd + Hd * Hd + Hd * F) + 2 * Hd + F + 8 * F
                + 6 * L)
    flops = B * N * n_steps * per_step
    if vb:
        in_noise = B * N * F
        e_out = 2 * B * N * F                        # s1, s2
    else:
        flops += B * N * 2 * K * F
        in_noise = B * K * F + B * K * N + (B * N if mode == "e" else 0)
        e_out = 2 * B * K * F                        # numW, denW
        if mode == "e":
            flops += 2 * 2 * B * K * N * F           # numW / denW
    if mode == "e":
        out_bytes = (4 * (B * N * L + B * N * F + e_out)
                     + sample_bytes * B * R * N * F)
    else:
        out_bytes = 4 * (B * N * L + 3 * B * N * F)
    in_bytes = 4 * (2 * B * N * F + in_noise + B * N + B * N * Hd
                    + B * N * L + L * Hd + Hd * Hd + Hd + Hd * F + F)
    nbytes = in_bytes + out_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def chain_bound_mm16(B, N, F, L, Hd, K, R, n_steps, mode, vb, sms, clock_hz):
    """(bound_ms, bound_by, terms_ms, binding term, flops, bytes) of one
    K1d launch (bfloat16 sample dumps): the largest of the tensor-core time
    of the decoder's products, 2 (L Hd + Hd Hd + Hd F) flops a frame-step
    at the bfloat16 peak; the special-function time of its 2 Hd tanh, F
    exp and F log a frame-step on SFU_PER_CLOCK_PER_SM results per clock
    on each of `sms` SMs at `clock_hz`; and chain_bound's byte time."""
    steps = B * N * n_steps
    flops = steps * 2 * (L * Hd + Hd * Hd + Hd * F)
    *_, nbytes = chain_bound(B, N, F, L, Hd, K, R, n_steps, mode, vb=vb,
                             sample_bytes=2)
    terms = {"tensor cores": flops / PEAK_BF16_FLOPS,
             "special functions": steps * (2 * Hd + 2 * F)
             / (SFU_PER_CLOCK_PER_SM * sms * clock_hz),
             "bytes": nbytes / PEAK_BYTES}
    binding = max(terms, key=terms.get)
    return (1e3 * terms[binding],
            "bytes" if binding == "bytes" else "operations",
            {k: 1e3 * v for k, v in terms.items()}, binding, flops, nbytes)


def sums_bound(B, R, N, F, K, mode, vb=False, sample_bytes=4):
    """(bound_ms, bound_by, flops, bytes) of one K2 launch. Operations: 6
    per sample (g Vs + Vb, floor, reciprocal and two sums), 2 per bin in
    'g' mode for the X2 product, and with the NMF factors (K2a) 2 K per bin
    to form Vb plus, in 'h' mode, 4 K per bin for the H-update contraction
    (in place of the 2). Bytes: the samples, g and Vb (K2b) or Wt and H
    (K2a) read once, X2 read where the mode uses it ('g', and 'h' with WH),
    the outputs written once: (B, N, F) x2 for 'h' with Vb, (B, N, K) x2
    for 'h' with WH, (B, N) x2 for 'g'. The samples take `sample_bytes` an
    element (2 for K2c's bfloat16)."""
    samples = sample_bytes * B * R * N * F
    if vb:
        flops = B * N * F * (6 * R + (2 if mode == "g" else 0))
        in_bytes = samples + 4 * (B * N * F + B * N
                                  + (B * N * F if mode == "g" else 0))
        out_bytes = 4 * 2 * (B * N * F if mode == "h" else B * N)
    else:
        flops = B * N * F * (2 * K + 6 * R + (4 * K if mode == "h" else 2))
        in_bytes = samples + 4 * (B * N * F + B * K * F + B * K * N + B * N)
        out_bytes = 4 * 2 * B * N * (K if mode == "h" else 1)
    nbytes = in_bytes + out_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


VARIANTS = ([f"mh_chain_{v}" for v in CHAIN_VARIANTS
             if not v.endswith("_mm16")]
            + [f"mh_chain_{v}" for v in K1D_VARIANTS]
            + [f"nmf_sums_{v}" for v in SUMS_VARIANTS])


def run_chain(c, fn, mode, nsamples, burnin, var_rw, vb=False, **kw):
    """One chain over the inputs `c`: with the NMF factors (K1a) or, with
    `vb`, at the given noise variance (K1b)."""
    return fn(c["dec_w"], c["X2"], None if vb else c["WH"], c["g"],
              c["ypre"], c["Z"], c["Vs"], mode=mode, nsamples=nsamples,
              burnin=burnin, var_RW=var_rw,
              mask=c["mask"] if mode == "e" and not vb else None,
              Vb=c["Vb"] if vb else None, **kw)


def run_sums(c, fn, samples, mode, vb=False, **kw):
    if vb:
        return fn(samples, None, c["g"], c["X2"], mode=mode, Vb=c["Vb"],
                  **kw)
    return fn(samples, c["WH"], c["g"], c["X2"], mode=mode, **kw)


def check_sums(torch, c, vb, dev, samples=None):
    """K2 in one form against its plain version on the inputs `c`: 'h' and
    'g' over float32 samples (K2a / K2b) and over their bfloat16 rounding
    with the approximate reciprocal (K2c); seeded gamma samples unless
    `samples` is given. Returns the largest absolute error per variant."""
    from guided_vae_nmf_torch.mcem import nmf_sums, nmf_sums_ref

    form = "vb" if vb else "wh"
    B, N, F = c["X2"].shape
    if samples is None:
        rng = np.random.RandomState(6)
        samples = torch.tensor(rng.gamma(0.5, 2.0, (B, 10, N, F))
                               .astype(np.float32) + 1e-3, device=dev)
    err = {}
    for level, smp in (("", samples), ("_fast", samples.to(torch.bfloat16))):
        kw = dict(approx_recip=True) if level else {}
        for mode in ("h", "g"):
            got = run_sums(c, nmf_sums, smp, mode, vb, **kw)
            ref = run_sums(c, nmf_sums_ref, smp, mode, vb)
            names = ("s1", "s2") if vb and mode == "h" else ("num", "den")
            log(f" K2{'c' if level else ('b' if vb else 'a')} "
                f"{mode}-mode, {form} form, {smp.dtype}, B={B} N={N}:")
            key = f"nmf_sums_{mode}_{form}{level}"
            err[key] = max(compare(name, x, y)
                           for name, x, y in zip(names, got, ref))
    return err


def phase_kernels(torch, model, dev, shapes):
    """Kernel vs plain version at full width, at each (B, N) of `shapes`,
    every variant; the Philox and accept-rule checks run at the first.
    Returns the largest absolute error per variant and, for K1d, the
    elements past TOL and the elements compared."""
    from guided_vae_nmf_torch.mcem import mh_chain, mh_chain_ref
    from guided_vae_nmf_torch.mcem.mh_chain import philox_streams

    K = 10
    err = dict.fromkeys(VARIANTS, 0.0)
    k1d_past = {f"mh_chain_{v}": [0, 0] for v in K1D_VARIANTS}

    for B, N in shapes:
        c = chain_inputs(torch, model, B, N, K, 1, dev)
        L = c["L"]
        for vb, form in ((False, "wh"), (True, "vb")):
            for mode, nsamples, burnin in (("e", 10, 30), ("wf", 25, 75)):
                names = (["Z", "Vs", "samples"]
                         + (["s1", "s2"] if vb else ["numW", "denW"])
                         if mode == "e" else ["Z", "Vs", "WFs_sum",
                                              "WFn_sum"])
                key = f"mh_chain_{mode}_{form}"
                for var_rw, label in ((0.01, "injected"), (0.0, "var_RW=0")):
                    if var_rw:
                        kw = dict(noise=decisive_noise(
                            torch, 2, B, N, L, nsamples + burnin, dev))
                        kw_ref = kw
                    else:
                        kw = dict(seed=3)
                        kw_ref = dict(generator=torch.Generator(
                            device=dev).manual_seed(3))
                    got = run_chain(c, mh_chain, mode, nsamples, burnin,
                                    var_rw, vb=vb, **kw)
                    ref = run_chain(c, mh_chain_ref, mode, nsamples, burnin,
                                    var_rw, vb=vb, **kw_ref)
                    torch.cuda.synchronize()
                    log(f" K1{'b' if vb else 'a'} {mode}-mode, {label}, "
                        f"B={B} N={N}:")
                    for name, x, y in zip(names, (got[0], got[1]) + got[2],
                                          (ref[0], ref[1]) + ref[2]):
                        err[key] = max(err[key], compare(name, x, y))
                    if mode == "wf":
                        unity = (got[2][0] + got[2][1]) / nsamples
                        check(torch.allclose(unity, torch.ones_like(unity),
                                             atol=1e-5), "WFs + WFn != 1")
            for level in ("_fast", "_trans"):
                kw = fast_kw(torch, level)
                noise = decisive_noise(torch, 4, B, N, L, 40, dev)
                for mode in ("e", "wf"):
                    got = run_chain(c, mh_chain, mode, 10, 30, 0.01, vb=vb,
                                    noise=noise, **kw)
                    ref = run_chain(c, mh_chain_ref, mode, 10, 30, 0.01,
                                    vb=vb, noise=noise, **kw)
                    torch.cuda.synchronize()
                    log(f" K1c {mode}-mode, {form} form, {kw}, injected, "
                        f"B={B} N={N}:")
                    if mode == "e":
                        log(f"  bfloat16 samples bit-equal to the plain "
                            f"version's: {torch.equal(got[2][0], ref[2][0])}")
                    key = f"mh_chain_{mode}_{form}{level}"
                    for x, y in zip((got[0], got[1]) + got[2],
                                    (ref[0], ref[1]) + ref[2]):
                        err[key] = max(err[key], compare(
                            "out", x.float(), y.float()))
                    if level != "_fast":
                        continue
                    # K1d: the same fast options with bfloat16 products
                    kw16 = fast_kw(torch, "_fast_mm16")
                    got16 = run_chain(c, mh_chain, mode, 10, 30, 0.01,
                                      vb=vb, noise=noise, **kw16)
                    ref16 = run_chain(c, mh_chain_ref, mode, 10, 30, 0.01,
                                      vb=vb, noise=noise, **kw16)
                    torch.cuda.synchronize()
                    log(f" K1d {mode}-mode, {form} form, {kw16}, "
                        f"injected, B={B} N={N}:")
                    key16 = f"mh_chain_{mode}_{form}_fast_mm16"
                    check(torch.equal(got16[0], ref16[0]),
                          "K1d: Z differs from the plain version's under "
                          "decisive noise")
                    names16 = (["Z", "Vs", "samples"]
                               + (["s1", "s2"] if vb else ["numW", "denW"])
                               if mode == "e" else ["Z", "Vs", "WFs_sum",
                                                    "WFn_sum"])
                    for name, x, y in zip(names16, (got16[0], got16[1])
                                          + got16[2],
                                          (ref16[0], ref16[1]) + ref16[2]):
                        e, past, n = compare_k1d(name, x.float(), y.float())
                        err[key16] = max(err[key16], e)
                        k1d_past[key16][0] += past
                        k1d_past[key16][1] += n
                    moved = past_fraction(got16[1], got[1])
                    log(f"  Vs past TOL from the float32-product kernel's: "
                        f"{100 * moved:.1f} % (needs > 50 %: the option "
                        "reached the products)")
                    check(moved > 0.5, "K1d: bfloat16 products changed "
                          "nothing")
            for key, e in check_sums(torch, c, vb, dev).items():
                err[key] = max(err[key], e)

    # the accept rule itself under real uniforms: a decision whose margin
    # is below rounding may flip between the two, so count frames
    B, N = shapes[0]
    c = chain_inputs(torch, model, B, N, K, 1, dev)
    L = c["L"]
    chain_c = lambda *a, **kw: run_chain(c, *a, **kw)  # noqa: E731
    nsamples, burnin = 10, 30
    gen = np.random.RandomState(9)
    noise = (torch.tensor(gen.randn(B, 40, N, L).astype(np.float32),
                          device=dev),
             torch.tensor(gen.uniform(1e-6, 1, (B, 40, N)).astype(
                 np.float32), device=dev))
    got = chain_c(mh_chain, "e", nsamples, burnin, 0.01, noise=noise)
    ref = chain_c(mh_chain_ref, "e", nsamples, burnin, 0.01, noise=noise)
    same = torch.all(torch.isclose(got[0], ref[0], **TOL), dim=-1)
    frac = same.float().mean().item()
    log(f" K1 e-mode, uniform accept draws: {frac:.4f} of frames follow "
        "the plain version's trajectory (needs >= 0.95)")
    check(frac >= 0.95, "accept decisions disagree with the plain version")

    # in-kernel Philox
    a = chain_c(mh_chain, "e", nsamples, burnin, 0.01, seed=11)
    b = chain_c(mh_chain, "e", nsamples, burnin, 0.01, seed=11)
    check(torch.equal(a[0], b[0]) and torch.equal(a[2][0], b[2][0]),
          "Philox run is not reproducible")
    samples = a[2][0]
    rate = torch.any(samples[:, 1:] != samples[:, :-1],
                     dim=-1).float().mean().item()
    zn, u = philox_streams(11, B, N, L, nsamples + burnin, dev)
    inj = chain_c(mh_chain, "e", nsamples, burnin, 0.01, noise=(zn, u))
    log(f" K1 Philox: reproducible; sampling-phase acceptance {rate:.4f}; "
        f"proposal normals mean {zn.mean().item():+.5f} var "
        f"{zn.var().item():.5f} ({zn.numel()} draws); uniforms in "
        f"({u.min().item():.2e}, {u.max().item():.7f})")
    check(0.0 < rate < 1.0, "acceptance rate not strictly inside (0, 1)")
    check(abs(zn.mean().item()) < 0.01 and abs(zn.var().item() - 1) < 0.01,
          "proposal normals are not standard normal")
    check(torch.equal(a[0], inj[0]) and torch.equal(a[2][0], inj[2][0]),
          "the Philox run differs from the reported streams")
    return err, k1d_past


def padded(signals):
    """Host-padded int16 rows (B, L) and frame masks (B, n_pad) of
    `signals`, bucketed as enhance_files buckets them."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.pipeline import HOP, NFFT, bucket_frames

    rows = [pad_signal_for_stft(x) for x in signals]
    n_pad = bucket_frames(max(nf for _, nf in rows))
    Lw = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((len(rows), Lw), np.int16)
    mask = np.zeros((len(rows), n_pad), np.float32)
    for j, (xp, nf) in enumerate(rows):
        x_b[j, : min(len(xp), Lw)] = xp[:Lw]
        mask[j, :nf] = 1.0
    return x_b, mask


def main_batch(seed, bursts=0):
    """The main path's batch: (clean, mixture) int16 pairs of MAIN_SECONDS,
    the host-padded mixtures (B, L) and their frame masks (B, n_pad)."""
    pairs = speech_like_mixtures(seed, MAIN_SECONDS, bursts=bursts)
    return (pairs,) + padded([x for _, x in pairs])


def phase_main(torch, model, classifier, mean, std, cfg, batch, seed, dev,
               gpu, launches=MAIN_LAUNCHES, label="main path",
               label_mode="dnn", **settings):
    """A path through enhance_waveform (dnn labels unless `label_mode` says
    otherwise; `settings` such as noise_model, soft_guidance, engine or
    s_pad, `cfg` with its noise gain): three runs, each with the launch
    counters reset before and checked against `launches` after. Returns
    its shapes, times, launch counts, PCM and packed hard labels."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.pipeline import NFFT, enhance_waveform

    pairs, x_b, mask = batch
    n_pad = mask.shape[1]
    audio_s = sum(MAIN_SECONDS)
    log(f" batch: B={len(pairs)}, {audio_s:.1f} s of audio, n_pad={n_pad} "
        f"frames, {cfg.niter} EM iterations")

    walls = []
    for rep in range(3):
        port.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s16, n16, y_soft, y_hard, ok = enhance_waveform(
            model, x_b, mask, cfg, classifier=classifier, mean=mean, std=std,
            label_mode=label_mode, return_noise=True, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed + rep),
            **settings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = port.launch_counts()
        log(f"  run {rep}: {walls[-1]:.3f} s wall, launches {counts}")
        check(counts == expected_launches(**launches),
              f"{label} launches {counts}, expected {launches}")
    s16, n16, ok = (a.cpu().numpy() for a in (s16, n16, ok))
    check(bool(ok.all()), "non-finite enhancement output")
    check(s16.shape == (len(pairs), x_b.shape[1] - NFFT),
          f"s shape {s16.shape}")
    if label_mode == "dnn":
        check(y_soft.shape == (len(pairs), 513, n_pad), "soft label shape")
    check(y_hard.shape == (len(pairs), 65, n_pad), "packed label shape")
    worst = 0
    for j, (clean, x) in enumerate(pairs):
        T = len(x)
        # WFs + WFn = 1, so s + n is the mixture up to PCM rounding
        recon = s16[j][:T].astype(np.int32) + n16[j][:T].astype(np.int32)
        worst = max(worst, int(np.abs(recon - x.astype(np.int32)).max()))
        log(f"  utt {j}: {T / 16000:.1f} s, SI-SDR mixture "
            f"{si_sdr(clean, x):+.2f} dB -> enhanced "
            f"{si_sdr(clean, s16[j][:T]):+.2f} dB")
    log(f"  |s + n - x| max {worst} LSB (needs <= 2: WFs + WFn = 1)")
    check(worst <= 2, "Wiener gains do not sum to one")
    wall = float(np.median(walls[1:]))
    log(f" {label}: {wall:.3f} s wall for {audio_s:.1f} s of audio = "
        f"{audio_s / wall:.2f}x realtime (median of runs 1-2; {gpu})")
    return {"n_pad": n_pad, "B": len(pairs), "wall_s": wall,
            "walls_s": walls, "audio_s": audio_s,
            "x_realtime": audio_s / wall,
            "launches": port.launch_counts(), "s16": s16,
            "y_hard": y_hard.cpu().numpy()}


def phase_files(torch, model, classifier, mean, std, pairs, cfg, seed,
                dev, launches, profile=None, classif_type="dnn",
                stages=False, gpu=""):
    """The same mixtures as wav files through enhance_files (with
    `profile`, if given; with classif_type="oracle" also the clean tracks
    as `_s.wav`); `launches` are the expected counts per batch, and every
    wav the sweep reads must be one native row assembly (counted). With
    `stages`, logs the sweep's stage report (`verbose=True`). Returns the
    sweep's wall seconds."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.data import native_loader, read_wav_int16, \
        write_wav
    from guided_vae_nmf_torch.pipeline import enhance_files, plan_batches

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        files = []
        for j, (clean, x) in enumerate(pairs):
            write_wav(os.path.join(src, f"utt{j}_x.wav"), x, 16000)
            write_wav(os.path.join(src, f"utt{j}_s.wav"), clean, 16000)
            files.append(f"utt{j}.wav")
        port.reset_launch_counts()
        native_loader.reset_call_counts()
        res, out = captured(lambda: enhance_files(
            files, src, dst, model, classif_type=classif_type,
            classifier=classifier, mean=mean, std=std, cfg=cfg, seed=seed,
            device=dev, profile=profile, verbose=stages))
        counts = port.launch_counts()
        native = native_loader.call_counts()
        reads = len(pairs) * (2 if classif_type == "oracle" else 1)
        check(native == {"assemble_utt": reads},
              f"enhance_files did not assemble its {reads} rows with the "
              f"native loader: its calls {native}")
        if stages:
            report = out[out.index("STAGE"):].rstrip().splitlines()
            log(f" enhance_files stage report (verbose=True; {gpu}):")
            for line in report:
                log(f"   {line}")
        from guided_vae_nmf_torch.dsp import frame_count

        n_batches = len(plan_batches(
            files, [frame_count(len(x)) for _, x in pairs]))
        audio_s = sum(len(x) for _, x in pairs) / 16000
        log(f" enhance_files(profile={profile!r}, classif_type="
            f"{classif_type!r}): {res.n_processed} files "
            f"in {float(res):.3f} s ({audio_s / float(res):.2f}x realtime, "
            f"wav I/O included), {n_batches} batches, launches {counts}, "
            f"native loader calls {native}")
        check(counts == expected_launches(n_batches=n_batches, **launches),
              f"enhance_files did not run {launches} launches a batch")
        for j, (_, x) in enumerate(pairs):
            s, _ = read_wav_int16(os.path.join(dst, f"utt{j}_s_est.wav"))
            n, _ = read_wav_int16(os.path.join(dst, f"utt{j}_n_est.wav"))
            yh = np.load(os.path.join(dst, f"utt{j}_ibm_hard_est.npy"))
            check(len(s) == len(x) and len(n) == len(x), "output length")
            check(np.array_equal(
                np.clip(x.astype(np.int32) - s, -32768, 32767), n),
                "n_est != x - s_est")
            check(yh.shape[0] == 513, "hard label shape")
            check(np.any(s != x), "enhance_files wrote passthrough")
    return float(res)


def phase_reference(torch, model, classifier, mean, std, pairs, dev):
    """One short utterance on the card against the CPU path (plain
    versions) at var_RW=0, where the chains are deterministic: the main
    path's settings (NMF from a shared init) and the real-noise profile's
    (spp2, noise gain, soft guidance)."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.pipeline import (
        HOP, NFFT, bucket_frames, enhance_waveform)

    x = pairs[0][1][:16000]
    xp, nf = pad_signal_for_stft(x)
    n_pad = bucket_frames(nf)
    Lw = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((1, Lw), np.int16)
    x_b[0, : min(len(xp), Lw)] = xp[:Lw]
    mask = np.zeros((1, n_pad), np.float32)
    mask[0, :nf] = 1
    small = dict(niter=3, nsamples_E_step=3, burnin_E_step=2,
                 nsamples_WF=3, burnin_WF=2, var_RW=0.0)
    rng = np.random.RandomState(5)
    init = {"W": rng.uniform(0.05, 1, (1, 513, 10)).astype(np.float32),
            "H": rng.uniform(0.05, 1, (1, 10, n_pad)).astype(np.float32)}
    cases = (("nmf", MCEMConfig(**small), {}, init),
             ("real-noise", MCEMConfig(**small, noise_gain=True),
              dict(noise_model="spp2", soft_guidance=True), None))
    for name, cfg, settings, init_np in cases:
        outs = {}
        for d in ("cpu", dev):
            mods = [m.to(d) for m in (model, classifier)]
            init_d = None if init_np is None else {
                k: torch.tensor(v, device=d) for k, v in init_np.items()}
            outs[str(d)] = [a if a is None else a.cpu().numpy()
                            for a in enhance_waveform(
                mods[0], x_b, mask, cfg, classifier=mods[1], mean=mean,
                std=std, label_mode="dnn", device=d, init=init_d,
                **settings)]
        for m in (model, classifier):
            m.to(dev)
        g, r = outs[str(dev)], outs["cpu"]
        diff = int(np.abs(g[0].astype(np.int32)
                          - r[0].astype(np.int32)).max())
        log(f" card vs CPU path ({name}), 1 s at var_RW=0: max |s16 diff| "
            f"{diff} LSB (needs <= 2); hard labels equal: "
            f"{np.array_equal(g[3], r[3])}")
        check(diff <= 2, f"card and CPU paths disagree ({name})")
        check(np.array_equal(g[3], r[3]),
              f"card and CPU labels disagree ({name})")


def phase_profile(torch, model, classifier, mean, std, x_b, mask, cfg,
                  dev, gpu, label="main path", host_ops=True, spans=None,
                  **settings):
    """One batch of a path under torch.profiler: device time by kernel
    group and the device's busy share of the wall time, and, where the
    path runs them, the wall time, device span (CUDA events) and kernel
    time of the functions in `spans` ((module, name) pairs; by default the
    SPP tracker and `_ema_time`, the two loops over frames that the host
    paces). host_ops=False records device activity alone, for a path of
    hundreds of thousands of small host ops. Informational: the profiler's
    own cost and the synchronisation around the spans inflate the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import guided_vae_nmf_torch.pipeline as pl

    if spans is None:
        spans = ((pl, "spp_track"), (pl, "_ema_time"))

    loops = {}

    def instrumented(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            with record_function(name):
                out = fn(*a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            st = loops.setdefault(name, dict(calls=0, wall_ms=0.0,
                                             span_ms=0.0))
            st["calls"] += 1
            st["wall_ms"] += 1e3 * (time.perf_counter() - t0)
            st["span_ms"] += ev[0].elapsed_time(ev[1])
            return out
        return run

    saved = [getattr(mod, name) for mod, name in spans]
    for mod, name in spans:
        setattr(mod, name, instrumented(name, getattr(mod, name)))
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    try:
        with profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pl.enhance_waveform(model, x_b, mask, cfg, classifier=classifier,
                                mean=mean, std=std, label_mode="dnn",
                                device=dev, **settings)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for (mod, name), fn in zip(spans, saved):
            setattr(mod, name, fn)
    groups = {"mh_chain": 0.0, "nmf_sums": 0.0, "other": 0.0}
    other = {}
    n_device = 0        # kernels, copies and fills the profiler saw
    averages = prof.key_averages()
    for evt in averages:
        if evt.key in loops:
            # the range's kernels; its device-side annotation event spans
            # the range and is no kernel, so it stays out of the groups
            if evt.device_type != DeviceType.CUDA:
                loops[evt.key]["kernel_ms"] = getattr(
                    evt, "device_time_total", 0.0) / 1e3
            continue
        if evt.device_type != DeviceType.CUDA:
            continue     # host ops: their device time is their kernels'
        us = evt.self_device_time_total
        if not us:
            continue
        n_device += evt.count
        if "mh_chain_kernel" in evt.key or "sum_tiles_kernel" in evt.key:
            groups["mh_chain"] += us / 1e3
        elif K2_KERNEL_NAME in evt.key:
            groups["nmf_sums"] += us / 1e3
        else:
            groups["other"] += us / 1e3
            other[evt.key[:60]] = other.get(evt.key[:60], 0.0) + us / 1e3
    for name, st in loops.items():
        log(f" profile ({label}): {name}: {st['calls']} call(s), wall "
            f"{st['wall_ms']:.2f} ms, device span {st['span_ms']:.2f} ms, "
            f"kernel time {st.get('kernel_ms', float('nan')):.2f} ms; {gpu}")
    busy = sum(groups.values())
    if busy == 0.0:
        log(f" profile ({label}): the profiler saw no device time (not "
            "measured)")
        return {"wall_ms": wall_ms, "loops": loops}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    log(f" profile ({label}): device busy {busy:.2f} ms of {wall_ms:.2f} ms "
        f"wall ({100 * busy / wall_ms:.1f}%); K1 {groups['mh_chain']:.2f} ms, "
        f"K2 {groups['nmf_sums']:.2f} ms, other kernels "
        f"{groups['other']:.2f} ms; {n_device} device activities; {gpu}")
    for name, ms in top:
        log(f"   other: {ms:8.3f} ms  {name}")
    return {"wall_ms": wall_ms, "device_ms": groups, "busy_ms": busy,
            "device_activities": n_device, "top_other": top,
            "loops": loops}


def phase_native(pairs, gpu):
    """The native host loader on the card's machine: its g++ build (timed;
    a failed build fails the run), its batch rows against `_fill_row`'s
    Python rows (bit for bit) and its STFT power against the port's
    `stft` (the JAX package's tests/data/test_native.py tolerances), on
    the main batch's mixtures and a 300-sample tail. Returns the record."""
    from guided_vae_nmf_torch.data import native_loader, write_wav
    from guided_vae_nmf_torch.dsp import frame_count, stft
    from guided_vae_nmf_torch.pipeline import (
        HOP, NFFT, _fill_row, bucket_frames)

    build_s = native_loader.build()
    log(f" native loader: g++ {' '.join(native_loader.CXX_FLAGS)} into "
        f"{native_loader.lib_path()} in {build_s:.2f} s")
    sigs = [x for _, x in pairs] + [pairs[0][1][:300]]
    worst_pow = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for j, x in enumerate(sigs):
            path = os.path.join(tmp, f"u{j}.wav")
            write_wav(path, x, 16000)
            L = (bucket_frames(frame_count(len(x))) - 1) * HOP + NFFT
            rows = np.zeros((2, L), np.int16)
            got = native_loader.assemble_utt_native(path, rows[0])
            saved = native_loader.is_available
            native_loader.is_available = lambda: False
            try:
                ref = _fill_row(path, rows[1])
            finally:
                native_loader.is_available = saved
            check(got == ref and np.array_equal(rows[0], rows[1]),
                  f"native row {j} ({len(x)} samples) differs from "
                  "_fill_row's")
            xf = x.astype(np.float64) / 32768.0
            want = (np.abs(stft(xf)) ** 2).astype(np.float32)
            power = native_loader.stft_power_native(xf)
            err = np.abs(power - want)
            check(power.shape == want.shape and bool(np.all(
                err <= 1e-5 * np.abs(want) + 1e-7 * want.max())),
                f"stft_power_native off the port's stft on row {j}")
            worst_pow = max(worst_pow, float((err / want.max()).max()))
    log(f" native loader: {len(sigs)} batch rows equal to _fill_row's bit "
        f"for bit; stft_power_native within rtol 1e-5 / atol 1e-7 max of "
        f"stft (max |diff| / max {worst_pow:.2e}); host work ({gpu})")
    return {"build_s": build_s, "rows": len(sigs),
            "stft_power_max_rel_to_peak": worst_pow}


def phase_pt(torch, mods, mean, std, cfg, batch, seed, dev, main_res):
    """Reference `.pt` state dicts on the card: the shipped M2-IBM by
    `export_vae`, the classifier in the reference's key naming, loaded by
    `load_model` on the card, run the main batch with the main path's
    last run's seed: PCM equal (torch.equal) to the `.ckpt.npz` models',
    at the main path's launch counts."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.models import export_vae
    from guided_vae_nmf_torch.pipeline import enhance_waveform
    from guided_vae_nmf_torch.train import load_model

    model, classifier = mods
    _, x_b, mask = batch
    with tempfile.TemporaryDirectory() as tmp:
        m2_pt, cls_pt = (os.path.join(tmp, f) for f in ("M2.pt", "cls.pt"))
        torch.save({k: torch.from_numpy(v)
                    for k, v in export_vae(model).items()}, m2_pt)
        sd = {}
        for i, layer in enumerate(classifier.hidden):
            sd[f"hidden.{i}.weight"] = layer.w.detach().T.cpu()
            sd[f"hidden.{i}.bias"] = layer.b.detach().cpu()
        sd["output_layer.weight"] = classifier.out.w.detach().T.cpu()
        sd["output_layer.bias"] = classifier.out.b.detach().cpu()
        torch.save(sd, cls_pt)
        m2 = load_model(m2_pt, kind="dgm", y_dim=513, device=dev)
        cls = load_model(cls_pt, kind="classifier", device=dev)
    port.reset_launch_counts()
    s16 = enhance_waveform(
        m2, x_b, mask, cfg, classifier=cls, mean=mean, std=std,
        label_mode="dnn", return_noise=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 2))[0]
    torch.cuda.synchronize()
    counts = port.launch_counts()
    same = torch.equal(s16.cpu(), torch.from_numpy(main_res["s16"]))
    log(f" .pt models (export_vae M2-IBM, reference-named classifier) on "
        f"the card: main batch PCM equal to the .ckpt.npz models': {same}; "
        f"launches {counts}")
    check(counts == expected_launches(**MAIN_LAUNCHES),
          f".pt main batch launches {counts}, expected {MAIN_LAUNCHES}")
    check(same, "the .pt models' main batch differs from the .ckpt.npz "
          "models'")
    return {"pcm_equal": same, "launches": counts}


def phase_profiling(torch, mods, mean, std, x_b, mask, cfg, dev, gpu, prof):
    """The port's profiling hooks on one main batch: `device_time_ms`
    (its top rows; its K1 total within 10 % of `phase_profile`'s K1 ms,
    measured in the same call) and `profile_trace` (a trace file that
    names the K1 kernel). Returns the record."""
    from guided_vae_nmf_torch.ops import device_time_ms, profile_trace
    from guided_vae_nmf_torch.pipeline import enhance_waveform

    model, classifier = mods

    def batch():
        return enhance_waveform(model, x_b, mask, cfg, classifier=classifier,
                                mean=mean, std=std, label_mode="dnn",
                                device=dev)

    log(" device_time_ms(one main batch), top rows:")
    total, table = device_time_ms(batch, top=6)
    k1 = sum(ms for ms, _, name in table
             if "mh_chain_kernel" in name or "sum_tiles_kernel" in name)
    k1_prof = prof.get("device_ms", {}).get("mh_chain", 0.0)
    rel = abs(k1 - k1_prof) / k1_prof if k1_prof else float("inf")
    log(f" device_time_ms: device {total:.2f} ms (union of kernel and copy "
        f"intervals), K1 {k1:.2f} ms against phase_profile's K1 "
        f"{k1_prof:.2f} ms ({100 * rel:.1f} % apart, needs <= 10 %); {gpu}")
    check(rel <= 0.10, "device_time_ms's K1 total is more than 10 % from "
          "phase_profile's")
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            batch()
            torch.cuda.synchronize()
        traces = [os.path.join(tmp, f) for f in os.listdir(tmp)
                  if f.endswith(".json")]
        check(len(traces) == 1, f"profile_trace wrote {traces}")
        with open(traces[0]) as f:
            text = f.read()
        named = "mh_chain_kernel" in text
        log(f" profile_trace: {os.path.basename(traces[0])}, "
            f"{len(text) / 1e6:.1f} MB, names mh_chain_kernel: {named}")
        check(named, "profile_trace's trace does not name mh_chain_kernel")
    return {"device_ms": total, "k1_ms": k1, "k1_profile_ms": k1_prof,
            "k1_rel_diff": rel, "top": table[:6]}


def phase_fast(torch, model, classifier, mean, std, cfg, batch, seed, dev,
               gpu, exact):
    """The main batch in fast mode (fast=True and fast="trans", launch
    counts checked per run) beside the exact path's run `exact`, with the
    SI-SDR of each fast output against the exact one; then the real-noise
    settings with fast="trans". Returns the paths' records."""
    from guided_vae_nmf_torch.profiles import (
        apply_profile_cfg, offline_settings)

    pairs = batch[0]
    out = {}
    for fast, level in ((True, "_fast"), ("trans", "_trans")):
        log(f"fast main path (enhance_waveform, fast={fast!r}):")
        res = phase_main(torch, model, classifier, mean, std, cfg, batch,
                         seed, dev, gpu,
                         launches=dict(MAIN_LAUNCHES, level=level),
                         label=f"fast={fast!r} main path", fast=fast)
        sdr = [float(si_sdr(exact["s16"][j][:len(x)], res["s16"][j][:len(x)]))
               for j, (_, x) in enumerate(pairs)]
        log(f" fast={fast!r}: {res['x_realtime']:.2f}x realtime against "
            f"the exact path's {exact['x_realtime']:.2f}x; SI-SDR against "
            f"the exact output {', '.join(f'{v:.2f}' for v in sdr)} dB "
            "(the chains diverge once a decision flips; no quality claim)")
        res["si_sdr_vs_exact_db"] = sdr
        out[f"fast={fast}"] = res
    noise_model, soft = offline_settings("real-noise")
    log("real-noise path with fast='trans':")
    out["real-noise, fast=trans"] = phase_main(
        torch, model, classifier, mean, std,
        apply_profile_cfg(cfg, "real-noise"), batch, seed, dev, gpu,
        launches=dict(REAL_NOISE_LAUNCHES, level="_trans"),
        label="real-noise fast='trans' path", fast="trans",
        noise_model=noise_model, soft_guidance=soft)
    return out


# The card against the CPU path for a 1 s utterance through the hybrid at
# var_RW=0, over the utterance's own samples. PEEM's init is a function of
# the generator's seed on every device and its 50 iterations are
# deterministic, but cuBLAS and the CPU sum in other orders, and 50
# iterations of 5 fixed-rate gradient steps carry those differences
# further than the 3 MCEM iterations of phase_reference (2 LSB).
HYBRID_CPU_LSB = 16


def phase_hybrid(torch, model, classifier, mean, std, batch, seed, dev,
                 gpu):
    """The PEEM -> MCEM hybrid at HybridConfig() (500 PEEM iterations, 150
    MCEM, the WF chain) on the main batch: exact, with fast=True, and with
    the spp noise model; then PEEM alone at PEEMConfig(); then one hybrid
    batch profiled (device activity only), with the wall time and device
    span of its two stages. Returns the runs' records."""
    import guided_vae_nmf_torch.mcem.peem as peem_mod
    from guided_vae_nmf_torch.mcem import HybridConfig, PEEMConfig

    # PEEM's products run on cuBLAS: in full float32 only with TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for float32 matrix products")
    out = {}
    hcfg = HybridConfig()
    for name, launches, settings in (
            ("hybrid", HYBRID_LAUNCHES, {}),
            ("hybrid, fast=True", dict(HYBRID_LAUNCHES, level="_fast"),
             dict(fast=True)),
            ("hybrid, spp", HYBRID_SPP_LAUNCHES, dict(noise_model="spp"))):
        log(f"{name} path (enhance_waveform, label_mode='dnn', "
            f"HybridConfig(), {settings}):")
        out[name] = phase_main(torch, model, classifier, mean, std, hcfg,
                               batch, seed, dev, gpu, launches=launches,
                               label=f"{name} path", **settings)
    log("PEEM path (enhance_waveform, label_mode='dnn', PEEMConfig()):")
    out["peem"] = phase_main(torch, model, classifier, mean, std,
                             PEEMConfig(), batch, seed, dev, gpu,
                             launches=PEEM_LAUNCHES, label="PEEM path")
    _, x_b, mask = batch
    out["hybrid"]["profile"] = phase_profile(
        torch, model, classifier, mean, std, x_b, mask, hcfg, dev, gpu,
        label="hybrid path", host_ops=False,
        spans=((peem_mod, "peem_run"), (peem_mod, "mcem_batch_fused")))
    return out


def phase_hybrid_reference(torch, model, classifier, mean, std, pairs, dev):
    """A 1 s utterance through HybridConfig(niter=50, refine=10,
    var_RW=0.0) with dnn labels on the card and on the CPU path: PCM16
    within HYBRID_CPU_LSB over its samples, hard labels equal."""
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.mcem import HybridConfig
    from guided_vae_nmf_torch.pipeline import (
        HOP, NFFT, bucket_frames, enhance_waveform)

    x = pairs[0][1][:16000]
    xp, nf = pad_signal_for_stft(x)
    n_pad = bucket_frames(nf)
    Lw = (n_pad - 1) * HOP + NFFT
    x_b = np.zeros((1, Lw), np.int16)
    x_b[0, : min(len(xp), Lw)] = xp[:Lw]
    mask = np.zeros((1, n_pad), np.float32)
    mask[0, :nf] = 1
    cfg = HybridConfig(niter=50, refine=10, var_RW=0.0)
    outs = {}
    for d in ("cpu", dev):
        mods = [m.to(d) for m in (model, classifier)]
        t0 = time.perf_counter()
        outs[str(d)] = [a if a is None else a.cpu().numpy()
                        for a in enhance_waveform(
            mods[0], x_b, mask, cfg, classifier=mods[1], mean=mean,
            std=std, label_mode="dnn", device=d)]
        log(f"  {d}: {time.perf_counter() - t0:.2f} s")
    for m in (model, classifier):
        m.to(dev)
    g, r = outs[str(dev)], outs["cpu"]
    diff = int(np.abs(g[0][0, :len(x)].astype(np.int32)
                      - r[0][0, :len(x)].astype(np.int32)).max())
    log(f" card vs CPU path (hybrid, niter=50, refine=10), 1 s at "
        f"var_RW=0: max |s16 diff| {diff} LSB over the utterance (needs <= "
        f"{HYBRID_CPU_LSB}); hard labels equal: {np.array_equal(g[3], r[3])}")
    check(diff <= HYBRID_CPU_LSB, "card and CPU paths disagree (hybrid)")
    check(np.array_equal(g[3], r[3]), "card and CPU labels disagree (hybrid)")
    return diff


# ---------------------------------------------------------------------------
# The rest of the offline pipeline: oracle labels, the Wiener-DNN baseline,
# enhance_batch, the eager engine and eager serving
# ---------------------------------------------------------------------------

NO_LAUNCHES = dict(form="wh", e=0, wf=0, h=0, g=0)
# The eager engine's card-vs-CPU check: a 1 s utterance, 3 EM iterations
# at full width under injected streams whose accept decisions cannot flip.
EAGER_REF_CFG = dict(niter=3, nsamples_E_step=10, burnin_E_step=30,
                     nsamples_WF=25, burnin_WF=75)


def phase_oracle(torch, model, mean, std, cfg, batch, seed, dev, gpu):
    """Oracle labels from the clean tracks: enhance_waveform(label_mode=
    "oracle", s_pad=...) on the main batch (100 / 1 / 100 / 100 K1a / K2a
    launches a run); the card's hard labels against make_labels("oracle")
    on the host over each utterance's valid frames (equal but for at most
    one crossing element an utterance); and enhance_files(classif_type=
    "oracle") over `_x.wav` / `_s.wav` files. Returns the record."""
    from guided_vae_nmf_torch.data import write_wav
    from guided_vae_nmf_torch.dsp import frame_count
    from guided_vae_nmf_torch.pipeline import make_labels

    pairs, x_b, mask = batch
    s_b, _ = padded([clean for clean, _ in pairs])
    res = phase_main(torch, model, None, None, None, cfg, batch, seed, dev,
                     gpu, label="oracle path", label_mode="oracle",
                     s_pad=s_b)
    y_card = np.unpackbits(res["y_hard"], axis=1)[:, :513]
    crossings = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (clean, _) in enumerate(pairs):
            path = os.path.join(tmp, f"utt{j}_s.wav")
            write_wav(path, clean, 16000)
            _, y_host = make_labels("oracle", None, s_path=path)
            nf = frame_count(len(clean))
            check(y_host.shape == (513, nf), f"host labels {y_host.shape}")
            crossings.append(int((y_card[j, :, :nf] != y_host).sum()))
    log(f" oracle labels, card against make_labels on the host: "
        f"{crossings} differing elements an utterance (needs <= 1 each: "
        "the element at the Lorenz threshold)")
    check(max(crossings) <= 1, "card and host oracle labels disagree")
    res["label_crossings"] = crossings
    res["enhance_files_s"] = phase_files(
        torch, model, None, mean, std, pairs, cfg, seed, dev, MAIN_LAUNCHES,
        classif_type="oracle")
    return res


def phase_wiener(torch, batch, dev, gpu, art):
    """The Wiener-DNN baseline with the shipped `wiener` checkpoint, its
    mean and its std: enhance_files_wiener over the main batch's mixtures
    as wav files on the card (a warm-up sweep, then the timed one) and on
    the CPU; PCM16 within 2 LSB, masks within 1e-3; and the batch's device
    program alone (`_wiener_waveform`, median of 5). Returns the record."""
    from guided_vae_nmf_torch.data import read_wav_int16, write_wav
    from guided_vae_nmf_torch.pipeline import (
        _wiener_waveform, enhance_files_wiener)
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    wdir = os.path.join(art, "wiener")
    wmean, wstd = load_norm_stats(wdir)
    pairs, x_b, mask = batch
    audio_s = sum(len(x) for _, x in pairs) / 16000
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        files = []
        for j, (_, x) in enumerate(pairs):
            write_wav(os.path.join(src, f"utt{j}_x.wav"), x, 16000)
            files.append(f"utt{j}.wav")
        for d in (dev, dev, "cpu"):
            model = load_model(wdir, kind="classifier", device=d)
            torch.cuda.synchronize()
            secs = enhance_files_wiener(files, src, os.path.join(
                tmp, str(d)), model, mean=wmean, std=wstd, device=d)
            out[str(d)] = secs
        worst = 0
        for j in range(len(pairs)):
            got, ref = (read_wav_int16(os.path.join(tmp, d, f"utt{j}_s_est"
                                                    ".wav"))[0]
                        for d in (str(dev), "cpu"))
            m_got, m_ref = (np.load(os.path.join(tmp, d, f"utt{j}_wiener_"
                                                 "mask.npy"))
                            for d in (str(dev), "cpu"))
            worst = max(worst, int(np.abs(got.astype(np.int32) - ref).max()))
            check(m_got.shape == m_ref.shape and
                  np.abs(m_got - m_ref).max() <= 1e-3,
                  "Wiener masks: card and CPU disagree")
    log(f" enhance_files_wiener: {len(files)} files in {out[str(dev)]:.3f} s "
        f"on the card ({audio_s / out[str(dev)]:.2f}x realtime, wav I/O "
        f"included; {gpu}), {out['cpu']:.3f} s on the CPU; card against "
        f"CPU: max |s16 diff| {worst} LSB (needs <= 2), masks within 1e-3")
    check(worst <= 2, "Wiener PCM: card and CPU disagree")
    model = load_model(wdir, kind="classifier", device=dev)
    x_d = torch.as_tensor(x_b, device=dev)
    m_d = torch.as_tensor(mask, device=dev)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _wiener_waveform(model, x_d, wmean, wstd, m_d)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[1:]))
    log(f" _wiener_waveform on the main batch: {1e3 * wall:.2f} ms = "
        f"{audio_s / wall:.1f}x realtime (median of 5 after a warm-up; "
        f"{gpu})")
    return {"files_s": out[str(dev)], "files_cpu_s": out["cpu"],
            "x_realtime_files": audio_s / out[str(dev)],
            "batch_ms": 1e3 * wall, "x_realtime_batch": audio_s / wall,
            "card_vs_cpu_lsb": worst}


def phase_enhance_batch(torch, model, classifier, mean, std, cfg, batch,
                        seed, dev, gpu):
    """enhance_batch on the main mixtures' host spectrograms with the dnn
    labels of make_labels: engine="fused" with the NMF noise model (the
    main path's launches) and noise_model="hybrid" (the eager engine: no
    K1 / K2 launch). Returns the record."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.dsp import stft
    from guided_vae_nmf_torch.pipeline import enhance_batch, make_labels

    pairs = batch[0]
    X_tfs = [stft(x.astype(np.float64) / 32768.0) for _, x in pairs]
    ys = [make_labels("dnn", (np.abs(X) ** 2).astype(np.float32),
                      classifier=classifier, mean=mean, std=std)[1]
          for X in X_tfs]
    audio_s = sum(len(x) for _, x in pairs) / 16000
    out = {}
    for name, kw, launches in (
            ("fused, nmf", dict(engine="fused"), MAIN_LAUNCHES),
            ("hybrid noise model", dict(noise_model="hybrid"), NO_LAUNCHES)):
        walls = []
        for rep in range(2):
            port.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S_hat, N_hat = enhance_batch(
                model, X_tfs, ys, cfg=cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed + rep),
                **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = port.launch_counts()
            check(counts == expected_launches(**launches),
                  f"enhance_batch ({name}) launches {counts}, expected "
                  f"{launches}")
        for S, Nh, X in zip(S_hat, N_hat, X_tfs):
            check(S.shape == X.shape and np.all(np.isfinite(S)) and
                  np.all(np.isfinite(Nh)), "enhance_batch output")
            check(np.abs(S + Nh - X).max() <= 1e-3 * np.abs(X).max(),
                  "enhance_batch: S + N != X")
        log(f" enhance_batch ({name}): {walls[1]:.3f} s for {audio_s:.1f} s "
            f"of audio = {audio_s / walls[1]:.2f}x realtime (second run), "
            f"launches {launches}; {gpu}")
        out[name] = {"wall_s": walls[1], "x_realtime": audio_s / walls[1],
                     "launches": counts}
    return out


def phase_eager(torch, model, classifier, mean, std, cfg, batch, seed, dev,
                gpu):
    """The eager engine: enhance_waveform(engine="xla") on the main batch
    (no K1 / K2 launch), then one run profiled (device activity only) for
    the device's busy share. Returns the record."""
    _, x_b, mask = batch
    res = phase_main(torch, model, classifier, mean, std, cfg, batch, seed,
                     dev, gpu, launches=NO_LAUNCHES, label="eager engine",
                     engine="xla")
    res["profile"] = phase_profile(
        torch, model, classifier, mean, std, x_b, mask, cfg, dev, gpu,
        label="eager engine", host_ops=False, spans=(), engine="xla")
    return res


def phase_eager_reference(torch, model, pairs, dev):
    """A 1 s utterance through the eager engine's mcem_run under injected
    streams (accept decisions of u = 0 or inf, which cannot flip) from one
    NMF init, on the card and on the CPU, EAGER_REF_CFG: WFs, WFn, g and
    Z within atol 2e-5 / rtol 2e-4. Returns the largest errors."""
    from guided_vae_nmf_torch.dsp import stft
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.mcem.engine import mcem_run, pad_power

    X = stft(pairs[0][1][:16000].astype(np.float64) / 32768.0)
    F, n = X.shape
    N = 64
    rng = np.random.RandomState(6)
    X_p, m = pad_power(torch.tensor(np.abs(X[None]) ** 2,
                                    dtype=torch.float32), N)
    y = np.zeros((1, 513, N), np.float32)
    y[:, :, :n] = (np.abs(X) ** 2 > np.median(np.abs(X) ** 2))
    cfg = MCEMConfig(**EAGER_REF_CFG)
    L = model.encoder.mu.w.shape[1]
    sE = cfg.nsamples_E_step + cfg.burnin_E_step
    sW = cfg.nsamples_WF + cfg.burnin_WF
    zE = rng.randn(1, cfg.niter, sE, L, N).astype(np.float32)
    uE = np.where(rng.uniform(size=(1, cfg.niter, sE, N)) < 0.5, 0, np.inf)
    zW = rng.randn(1, sW, L, N).astype(np.float32)
    uW = np.where(rng.uniform(size=(1, sW, N)) < 0.5, 0, np.inf)
    W0 = rng.uniform(0.05, 1, (1, F, cfg.nmf_rank)).astype(np.float32)
    H0 = rng.uniform(0.05, 1, (1, cfg.nmf_rank, N)).astype(np.float32)
    outs = {}
    for d in ("cpu", dev):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=d)

        t0 = time.perf_counter()
        outs[str(d)] = mcem_run(
            model.to(d), t(X_p), t(m), t(y), [7], cfg,
            init_nmf=(t(W0), t(H0), t(np.ones((1, N)))),
            noise=tuple(map(t, (zE, uE, zW, uW))))
        log(f"  {d}: {time.perf_counter() - t0:.2f} s")
    model.to(dev)
    errs = {}
    for k in ("WFs", "WFn", "g", "Z"):
        errs[k] = compare(f"eager engine {k}, card vs CPU",
                          outs[str(dev)][k], outs["cpu"][k])
    return errs


def phase_eager_serving(torch, model, classifier, mean, std, cfg, seed,
                        dev, gpu):
    """EnhancementService(ServeConfig(engine="xla")) (spp noise model, dnn
    labels): a request served alone, then the same request (again the
    first, so the same seed) co-batched with two others, one of them in
    the next length bucket: PCM within 1 LSB, and no K1 / K2 launch.
    Returns the record."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig

    xs = [x.astype(np.float32) / 32768.0 for _, x in
          speech_like_mixtures(seed + 3, (1.5, 3.9, 1.1))]
    outs = []
    port.reset_launch_counts()
    t0 = time.perf_counter()
    for group, wait_ms in ((xs[:1], 50.0), (xs, 2000.0)):
        with EnhancementService(model, classifier=classifier, mean=mean,
                                std=std, cfg=cfg, device=dev,
                                serve=ServeConfig(engine="xla",
                                                  max_wait_ms=wait_ms)) as svc:
            futs = [svc.submit(x) for x in group]
            outs.append([f.result(timeout=600) for f in futs])
    wall = time.perf_counter() - t0
    counts = port.launch_counts()
    alone, mixed = outs[0][0], outs[1][0]
    diff = float(np.abs(alone["s"] - mixed["s"]).max() * 32768)
    log(f" serving, engine='xla': 1 request alone (batch "
        f"{alone['batch_size']}), then co-batched (batch "
        f"{mixed['batch_size']}) with 2 others: max |s diff| {diff:.1f} LSB "
        f"(needs <= 1); latency {alone['latency_s']:.3f} s alone, "
        f"{mixed['latency_s']:.3f} s co-batched; {wall:.2f} s in all; {gpu}")
    check(mixed["batch_size"] == 3, "the requests were not co-batched")
    check(counts == expected_launches(**NO_LAUNCHES),
          f"eager serving launched kernels: {counts}")
    for x, r in zip(xs, outs[1]):
        check(r["s"].shape == x.shape and np.all(np.isfinite(r["s"])),
              "eager serving output")
        check(np.abs(r["s"] + r["n"] - x).max() <= 3 / 32768,
              "eager serving: s + n != x")
    check(diff <= 1.0, "a request co-batched differs from itself alone")
    return {"alone_vs_cobatched_lsb": diff, "wall_s": wall,
            "latency_alone_s": alone["latency_s"],
            "latency_cobatched_s": mixed["latency_s"]}


def phase_harness(torch, dev):
    """`bench_niter500.main` at HARNESS_ARGS (it prints its JSON line), with
    the launch counters reset before and read after: four variants twice
    each (warm-up and timed), fast_bf16mm on the K1d keys."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch import bench_niter500

    argv = [a for k, v in HARNESS_ARGS.items() for a in (f"--{k}", str(v))]
    port.reset_launch_counts()
    rec = bench_niter500.main(argv + ["--device", str(dev)])
    counts = port.launch_counts()
    want = harness_launches(HARNESS_ARGS["niter"], HARNESS_ARGS["hybrid"])
    mm16 = {k: n for k, n in counts["mh_chain"].items() if k.endswith("_mm16")
            and n}
    log(f" harness launches {counts}; on the K1d keys {mm16} (2 runs of "
        f"{HARNESS_ARGS['niter']} E + 1 WF)")
    check(counts == want, f"harness launches {counts}, expected {want}")
    return {"record": rec, "launches": counts}


def phase_serving(torch, model, classifier, mean, std, cfg, seed, dev, gpu):
    """EnhancementService(ServeConfig(fast=True)): warm-up, then 16 requests
    of 1-5 s from 4 producer threads with the launch counters reset before
    and read after. Returns (service, record); the service stays open for
    the HTTP phase."""
    import threading

    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig

    svc = EnhancementService(model, classifier=classifier, mean=mean,
                             std=std, cfg=cfg, serve=ServeConfig(fast=True),
                             device=dev)
    warm_s = svc.warmup(buckets=(128, 256, 384))
    log(f" warm-up over buckets 128 / 256 / 384 and batches 1-16: "
        f"{warm_s:.2f} s")
    seconds = np.random.RandomState(seed + 2).uniform(1.0, 5.0, 16)
    xs = [x.astype(np.float32) / 32768.0
          for _, x in speech_like_mixtures(seed + 2, seconds)]
    results = [None] * len(xs)
    errors = []

    def producer(k):
        try:
            futs = [(i, svc.submit(xs[i])) for i in range(k, len(xs), 4)]
            for i, f in futs:
                results[i] = f.result(timeout=600)
        except Exception as e:       # reported by the checks below
            errors.append(repr(e))

    svc.reset_stats()
    port.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    counts = port.launch_counts()
    st = svc.stats()
    check(not errors and not any(t.is_alive() for t in threads),
          f"serving producers failed: {errors}")
    check(all(r is not None for r in results), "a request did not resolve")
    for x, r in zip(xs, results):
        check(r["s"].shape == x.shape and np.all(np.isfinite(r["s"])),
              "serving output not finite or of the wrong length")
        check(np.abs(r["s"] + r["n"] - x).max() <= 1e-6, "s + n != x")
    want = expected_launches(n_batches=st["batches"], **SERVING_LAUNCHES)
    log(f" {len(xs)} requests ({sum(seconds):.1f} s of audio) in {wall:.3f} "
        f"s: {len(xs) / wall:.2f} requests/s, {sum(seconds) / wall:.2f} "
        f"audio s per wall s; {st['batches']} batches, mean batch "
        f"{st['mean_batch']:.2f}, latency p50 {st['p50_s']:.3f} s, p95 "
        f"{st['p95_s']:.3f} s; {gpu}")
    log(f" launches {counts}")
    check(counts == want, f"serving launches {counts}, expected {want}")
    return svc, {"requests": len(xs), "audio_s": float(sum(seconds)),
                 "wall_s": wall, "requests_per_s": len(xs) / wall,
                 "audio_s_per_s": float(sum(seconds)) / wall,
                 "warmup_s": warm_s, "stats": st, "launches": counts}


def phase_http(svc, pair):
    """The HTTP front end on port 0 over the serving phase's service: one
    wav through /v1/enhance (200, its length), /healthz and /metrics."""
    import io
    import urllib.request

    from guided_vae_nmf_torch.data import read_wav, write_wav
    from guided_vae_nmf_torch.http_serving import EnhancementHTTPServer

    srv = EnhancementHTTPServer(svc, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        buf = io.BytesIO()
        write_wav(buf, pair[1], 16000)
        req = urllib.request.Request(url + "/v1/enhance",
                                     data=buf.getvalue(),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            status, lat = r.status, r.headers["X-Latency-S"]
            s, fs = read_wav(io.BytesIO(r.read()))
        check(status == 200 and fs == 16000 and len(s) == len(pair[1]),
              f"/v1/enhance answered {status} with {len(s)} samples")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        check(health["status"] == "ok", f"/healthz {health}")
        check("gvnmf_requests_total" in metrics, "/metrics lacks counters")
        log(f" POST /v1/enhance: 200, {len(s)} samples, X-Latency-S {lat}; "
            f"/healthz {health}; /metrics {len(metrics.splitlines())} lines")
    finally:
        srv.close_all()
    return {"latency_s": float(lat), "health": health}


# ---------------------------------------------------------------------------
# Streaming: the Wiener, SPP and M2 stream enhancers, the pool, its driver
# and the HTTP stream route
# ---------------------------------------------------------------------------

STREAM_PROFILES = ("reference", "real-noise", "streaming-low-latency",
                   "streaming-192ms")
STREAM_SECONDS = 2.5       # a profile's stream, on the card and the CPU
STREAM_PROF_SECONDS = 0.5  # its profiled stream
POOL_STREAMS = 8
POOL_SECONDS = (1.0, 2.0)  # the range of the pool's stream lengths
POOL_TOL = dict(atol=2e-5, rtol=1e-4)


def ragged_sizes(seed, n=16, lo=500, hi=5000):
    return [int(v) for v in np.random.RandomState(seed).randint(lo, hi, n)]


def drive(enh, x, sizes):
    """Push x in the cyclic `sizes` pieces, then flush; returns the output
    and the wall seconds."""
    t0 = time.perf_counter()
    out, lo, i = [], 0, 0
    while lo < len(x):
        n = sizes[i % len(sizes)]
        out.append(enh.push(x[lo:lo + n]))
        lo += n
        i += 1
    out.append(enh.flush())
    return np.concatenate(out), time.perf_counter() - t0


def pcm(x):
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0), -32768,
                   32767).astype(np.int32)


def stream_kwargs(name, classifier, mean, std, meta, **extra):
    """StreamingM2Enhancer settings of a profile with the shipped
    classifier's protocol (dnn labels)."""
    from guided_vae_nmf_torch.profiles import streaming_settings

    return dict(streaming_settings(name), classifier=classifier, mean=mean,
                std=std, label_mode="dnn", features=meta["features"],
                dnn_threshold=meta["threshold"], **extra)


def check_no_launches(what):
    import guided_vae_nmf_torch as port

    counts = port.launch_counts()
    check(counts == expected_launches(**NO_LAUNCHES),
          f"{what} launched K1 / K2 kernels: {counts}")


def profile_device(torch, fn):
    """fn() under torch.profiler with device activity only: (wall ms, busy
    ms, device activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy, n = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            busy += evt.self_device_time_total / 1e3
            n += evt.count
    return wall_ms, busy, n


def captured_ticks(st_mod):
    """Wrap streaming._m2_tick to keep each tick's labels and adaptive
    iterations on the host; returns (records, restore)."""
    records = []
    orig = st_mod._m2_tick

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        records.append((out[3]["labels"].cpu().numpy(),
                        out[3]["extra"].cpu().numpy()))
        return out

    st_mod._m2_tick = wrapped

    def restore():
        st_mod._m2_tick = orig
    return records, restore


def timed_ticks(enh, name):
    """Wrap one of the enhancer's tick methods with a host clock; returns
    the list the tick walls (s) land in."""
    walls = []
    fn = getattr(enh, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls.append(time.perf_counter() - t0)
        return out

    setattr(enh, name, run)
    return walls


def phase_stream_wiener(torch, dev, gpu, art, x):
    """StreamingWienerEnhancer with the shipped `wiener` checkpoint on the
    card, ragged pushes, against the offline `_wiener_waveform` on the
    card: PCM16 within 2 LSB. Returns the record."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft
    from guided_vae_nmf_torch.pipeline import _wiener_waveform
    from guided_vae_nmf_torch.streaming import StreamingWienerEnhancer
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    wdir = os.path.join(art, "wiener")
    wmean, wstd = load_norm_stats(wdir)
    model = load_model(wdir, kind="classifier", device=dev)
    port.reset_launch_counts()
    walls = []
    for _ in range(2):
        y, wall = drive(StreamingWienerEnhancer(model, wmean, wstd,
                                                device=dev),
                        x, ragged_sizes(11))
        walls.append(wall)
    xp, nf = pad_signal_for_stft(x)
    s16, _ = _wiener_waveform(model, xp[None], wmean, wstd,
                              np.ones((1, nf), np.float32))
    check_no_launches("the Wiener stream")
    ref = s16[0, :len(x)].cpu().numpy().astype(np.int32)
    diff = int(np.abs(pcm(y) - ref).max())
    audio_s = len(x) / 16000
    log(f" Wiener stream (64-frame chunks, ragged pushes): {audio_s:.1f} s "
        f"in {walls[1]:.3f} s = {audio_s / walls[1]:.1f}x realtime; against "
        f"the offline program on the card: max |s16 diff| {diff} LSB (needs "
        f"<= 2); launches 0; {gpu}")
    check(len(y) == len(x), "Wiener stream length")
    check(diff <= 2, "the Wiener stream disagrees with the offline program")
    return {"wall_s": walls[1], "x_realtime": audio_s / walls[1],
            "vs_offline_lsb": diff}


def phase_stream_spp(torch, dev, gpu, x):
    """StreamingSPPEnhancer on the card, ragged pushes: its masks against
    `timo_mask` of the whole spectrogram (float16 masks, atol 1e-3).
    Returns the record."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.dsp import stft_torch
    from guided_vae_nmf_torch.mcem.spp import timo_mask
    from guided_vae_nmf_torch.streaming import StreamingSPPEnhancer

    port.reset_launch_counts()
    walls = []
    for _ in range(2):
        enh = StreamingSPPEnhancer(device=dev)
        y, wall = drive(enh, x, ragged_sizes(12))
        walls.append(wall)
    X = stft_torch(torch.as_tensor(x, device=dev))
    whole = timo_mask(X.real**2 + X.imag**2).to(torch.float16).float()
    check_no_launches("the SPP stream")
    masks = enh.masks.astype(np.float32)
    check(masks.shape == tuple(whole.shape),
          f"SPP masks {masks.shape} vs {tuple(whole.shape)}")
    err = float(np.abs(masks - whole.cpu().numpy()).max())
    audio_s = len(x) / 16000
    log(f" SPP stream (64-frame chunks): {audio_s:.1f} s in {walls[1]:.3f} "
        f"s = {audio_s / walls[1]:.1f}x realtime; masks against timo_mask "
        f"of the whole spectrogram: max abs {err:.2e} (needs <= 1e-3); "
        f"{gpu}")
    check(err <= 1e-3 and len(y) == len(x),
          "the SPP stream's masks disagree with timo_mask")
    return {"wall_s": walls[1], "x_realtime": audio_s / walls[1],
            "mask_err": err}


def phase_stream_m2(torch, mods, cpu_mods, mean, std, meta, dev, gpu, x,
                    name, lookahead=False):
    """One profile's M2 stream (dnn labels, shipped weights) over
    STREAM_SECONDS on the card, its tick walls timed (median, p95), against
    the same stream on the CPU tick by tick: the hard labels and the
    adaptive iterations compared (flips counted), the PCM16 within 2 LSB
    where nothing flipped; then a profiled stream of STREAM_PROF_SECONDS
    (device activities a tick, busy share). Returns the record."""
    import guided_vae_nmf_torch as port
    import guided_vae_nmf_torch.streaming as st

    label = name + (", lookahead" if lookahead else "")
    sizes = ragged_sizes(13)
    extra = dict(lookahead=True) if lookahead else {}
    tick_fn = "_tick_full" if lookahead else "_enhance_frame_batch"
    port.reset_launch_counts()
    runs = {}
    for d, (m2, cls) in ((dev, mods), ("cpu", cpu_mods)):
        enh = st.StreamingM2Enhancer(
            m2, device=d, **stream_kwargs(name, cls, mean, std, meta,
                                          **extra))
        walls = timed_ticks(enh, tick_fn)
        records, restore = captured_ticks(st)
        try:
            y, wall = drive(enh, x, sizes)
        finally:
            restore()
        runs[str(d)] = (y, records, walls, wall)
    (yg, rg, walls, wall), (yc, rc, _, _) = runs[str(dev)], runs["cpu"]
    check(len(rg) == len(rc), "card and CPU ran different tick counts")
    check(len(yg) == len(x) and len(yc) == len(x) and
          np.all(np.isfinite(yg)), f"M2 stream {label}: output")
    soft = stream_kwargs(name, None, None, None, meta)["soft_guidance"]
    label_flips = 0 if soft else int(sum(
        (a[0] != b[0]).sum() for a, b in zip(rg, rc)))
    esc_flips = int(sum((a[1] != b[1]).sum() for a, b in zip(rg, rc)))
    escalated = int(sum((a[1] > 0).sum() for a in rg))
    diff = int(np.abs(pcm(yg) - pcm(yc)).max())
    n_labels = int(sum(a[0].size for a in rg))
    flipped = label_flips or esc_flips
    log(f" M2 stream {label}: card against CPU ({len(rg)} ticks): label "
        f"flips {label_flips} of {n_labels}"
        f"{' (soft guidance: none possible)' if soft else ''}, escalation "
        f"flips {esc_flips} ({escalated} escalated blocks on the card); "
        f"max |s16 diff| {diff} LSB "
        + ("(needs <= 2)" if not flipped else
           "(not held: a decision flipped)"))
    if not flipped:
        check(diff <= 2, f"M2 stream {label}: card and CPU disagree")

    enh = st.StreamingM2Enhancer(
        mods[0], device=dev, **stream_kwargs(name, mods[1], mean, std, meta,
                                             **extra))
    n_ticks = timed_ticks(enh, tick_fn)
    xp = x[:int(STREAM_PROF_SECONDS * 16000)]
    pwall, busy, acts = profile_device(torch, lambda: drive(enh, xp, sizes))
    check_no_launches(f"the M2 stream ({label})")
    chunk_ms = 16.0 * enh.chunk_frames
    med = 1e3 * float(np.median(walls))
    p95 = 1e3 * float(np.percentile(walls, 95))
    audio_s = len(x) / 16000
    log(f" M2 stream {label} (chunk {enh.chunk_frames} = {chunk_ms:.0f} ms): "
        f"tick wall median {med:.2f} ms, p95 {p95:.2f} ms over {len(walls)} "
        f"ticks; {audio_s:.1f} s in {wall:.3f} s = {audio_s / wall:.2f}x "
        f"realtime; profiled {STREAM_PROF_SECONDS} s: "
        f"{acts / max(len(n_ticks), 1):.0f} device activities a tick, busy "
        f"{busy:.2f} ms of {pwall:.2f} ms ({100 * busy / pwall:.1f}%); "
        f"launches 0; {gpu}")
    return {"chunk_ms": chunk_ms, "tick_ms_median": med, "tick_ms_p95": p95,
            "ticks": len(walls), "x_realtime": audio_s / wall,
            "activities_per_tick": acts / max(len(n_ticks), 1),
            "busy_share": busy / pwall, "label_flips": label_flips,
            "escalation_flips": esc_flips, "escalated": escalated,
            "card_vs_cpu_lsb": diff}


def phase_stream_pool(torch, mods, mean, std, meta, dev, gpu, seed):
    """MultiStreamM2Enhancer of POOL_STREAMS slots (real-noise settings:
    soft guidance, so no label edge) fed ragged, interleaved pushes: each
    lane against a dedicated stream on the card pushed the same pieces
    (the residual floor follows the tick boundaries, so the pieces must
    match) within POOL_TOL; audio s per wall s and the tick wall; then
    StreamPoolDriver from 4 threads pushing the same pieces, each stream
    against its dedicated one. Returns the record."""
    import threading

    import guided_vae_nmf_torch as port
    import guided_vae_nmf_torch.streaming as st

    m2, cls = mods
    kw = stream_kwargs("real-noise", cls, mean, std, meta)
    seconds = np.random.RandomState(seed + 5).uniform(*POOL_SECONDS,
                                                      POOL_STREAMS)
    xs = [x.astype(np.float32) / 32768.0 for _, x in
          speech_like_mixtures(seed + 5, seconds)]
    rng = np.random.RandomState(seed + 6)
    pieces = []
    for x in xs:
        cuts = np.cumsum(rng.randint(800, 5000, len(x) // 800 + 1))
        cuts = [0] + [int(c) for c in cuts if c < len(x)] + [len(x)]
        pieces.append([x[a:b] for a, b in zip(cuts, cuts[1:])])
    port.reset_launch_counts()
    singles = []
    for ps in pieces:
        enh = st.StreamingM2Enhancer(m2, device=dev, **kw)
        singles.append(np.concatenate([enh.push(p) for p in ps]
                                      + [enh.flush()]))
    pool = st.MultiStreamM2Enhancer(m2, max_streams=POOL_STREAMS,
                                    device=dev, **kw)
    walls = timed_ticks(pool, "_tick")
    t0 = time.perf_counter()
    sids = [pool.open() for _ in xs]
    outs = {sid: [] for sid in sids}
    live = set(range(len(xs)))
    rnd = 0
    while live:
        for i in sorted(live):
            pool.feed(sids[i], pieces[i][rnd])
        for sid, arr in pool.step().items():
            outs[sid].append(arr)
        rnd += 1
        for i in sorted(live):
            if rnd == len(pieces[i]):
                outs[sids[i]].append(pool.flush(sids[i]))
                pool.close(sids[i])
                live.discard(i)
    wall = time.perf_counter() - t0

    def worst_of(got, i, what):
        check(len(got) == len(xs[i]), f"{what} {i}: length")
        err = np.abs(got - singles[i])
        check(bool(np.all(err <= POOL_TOL["atol"] + POOL_TOL["rtol"]
                          * np.abs(singles[i]))),
              f"{what} {i} disagrees with its dedicated stream")
        return float(err.max())

    worst = max(worst_of(np.concatenate(outs[sid]), i, "pool lane")
                for i, sid in enumerate(sids))
    audio_s = float(sum(len(x) for x in xs)) / 16000
    med = 1e3 * float(np.median(walls))
    p95 = 1e3 * float(np.percentile(walls, 95))
    log(f" pool of {POOL_STREAMS} (real-noise settings, chunk 8): "
        f"{audio_s:.1f} s of audio in {wall:.3f} s = {audio_s / wall:.2f} "
        f"audio s per wall s; {len(walls)} ticks, tick wall median "
        f"{med:.2f} ms, p95 {p95:.2f} ms; lanes against dedicated streams: "
        f"max abs {worst:.2e} (atol {POOL_TOL['atol']:g} rtol "
        f"{POOL_TOL['rtol']:g}); {gpu}")

    driver = st.StreamPoolDriver(st.MultiStreamM2Enhancer(
        m2, max_streams=POOL_STREAMS, device=dev, **kw), tick_ms=2.0)
    results, errors = {}, []

    def client(i):
        try:
            sess = st.PooledStreamSession(driver)
            try:
                parts = [sess.push(p) for p in pieces[i]]
                parts.append(sess.flush())
                results[i] = np.concatenate([p for p in parts if p.size])
            finally:
                sess.close()
        except Exception as e:       # reported by the checks below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    dwall = time.perf_counter() - t0
    driver.shutdown()
    check(not errors and not any(t.is_alive() for t in threads),
          f"driver clients failed: {errors}")
    dworst = max(worst_of(results[i], i, "driver stream") for i in range(4))
    check_no_launches("the stream pool")
    d_audio = float(sum(len(x) for x in xs[:4])) / 16000
    log(f" StreamPoolDriver from 4 threads (the same pieces, tick_ms 2): "
        f"{d_audio:.1f} s in {dwall:.3f} s = {d_audio / dwall:.2f} audio s "
        f"per wall s; against dedicated streams max abs {dworst:.2e}; "
        f"launches 0; {gpu}")
    return {"streams": POOL_STREAMS, "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "tick_ms_median": med,
            "tick_ms_p95": p95, "ticks": len(walls), "vs_single_max": worst,
            "driver_audio_s_per_s": d_audio / dwall,
            "driver_vs_single_max": dworst}


def phase_stream_http(torch, mods, mean, std, meta, dev, gpu, art, x):
    """build_server(stream=True) on the card: a chunked PCM16 POST to
    /v1/enhance_stream (odd-sized pieces) answers 200 with X-Chunk-Frames
    and as many samples as were sent, within 1 LSB of the enhancer called
    directly; /stats counts the stream. Returns the record."""
    import http.client

    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.http_serving import build_server
    from guided_vae_nmf_torch.streaming import StreamingM2Enhancer

    port.reset_launch_counts()
    body = pcm(x).astype("<i2").tobytes()
    srv = build_server(art, port=0, device=dev, stream=True).start()
    try:
        cuts = list(range(0, len(body), 3001)) + [len(body)]
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/enhance_stream",
                     body=iter([body[a:b] for a, b in zip(cuts, cuts[1:])]),
                     headers={"Content-Type": "audio/L16",
                              "Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        resp = conn.getresponse()
        status, chunk = resp.status, resp.headers.get("X-Chunk-Frames")
        got = np.frombuffer(resp.read(), "<i2").astype(np.int32)
        wall = time.perf_counter() - t0
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/stats")
        streams = json.loads(conn.getresponse().read())["streams"]
        conn.close()
    finally:
        srv.close_all()
    m2, cls = mods
    xq = pcm(x).astype(np.float32) / 32768.0
    enh = StreamingM2Enhancer(m2, classifier=cls, mean=mean, std=std,
                              label_mode="dnn", features=meta["features"],
                              dnn_threshold=meta["threshold"],
                              keep_masks=False, device=dev)
    want = pcm(np.concatenate([enh.push(xq), enh.flush()]))
    check_no_launches("the HTTP stream route")
    check(status == 200 and chunk == "8" and len(got) == len(x),
          f"/v1/enhance_stream answered {status}, X-Chunk-Frames {chunk}, "
          f"{len(got)} of {len(x)} samples")
    diff = int(np.abs(got - want).max())
    log(f" POST /v1/enhance_stream (chunked, {len(cuts) - 1} pieces): "
        f"{status}, X-Chunk-Frames {chunk}, {len(got)} samples in "
        f"{wall:.3f} s; against the enhancer called directly: max |s16 "
        f"diff| {diff} LSB (needs <= 1); /stats streams {streams}; {gpu}")
    check(diff <= 1, "the HTTP stream disagrees with the enhancer")
    check(streams.get("done") == 1 and streams.get("active") == 0,
          f"/stats does not count the stream: {streams}")
    return {"wall_s": wall, "vs_direct_lsb": diff, "streams": streams}


def phase_streaming(torch, mods, mean, std, meta, dev, gpu, art, seed):
    """Every streaming phase, on one speech-like mixture with three noise
    bursts (STREAM_SECONDS) and the shipped weights. Returns the record."""
    from guided_vae_nmf_torch.train import load_model

    t0 = time.perf_counter()
    _, x16 = speech_like_mixtures(seed + 4, (STREAM_SECONDS,), bursts=3)[0]
    x = x16.astype(np.float32) / 32768.0          # every stream's input
    rec = {"wiener": phase_stream_wiener(torch, dev, gpu, art, x),
           "spp": phase_stream_spp(torch, dev, gpu, x)}
    cpu_mods = (load_model(os.path.join(art, "M2_ibm"), kind="dgm",
                           y_dim=513, device="cpu"),
                load_model(os.path.join(art, "classifier_ibm"),
                           kind="classifier", device="cpu"))
    m2 = {}
    for name in STREAM_PROFILES:
        m2[name] = phase_stream_m2(torch, mods, cpu_mods, mean, std, meta,
                                   dev, gpu, x, name)
    m2["streaming-low-latency, lookahead"] = phase_stream_m2(
        torch, mods, cpu_mods, mean, std, meta, dev, gpu, x,
        "streaming-low-latency", lookahead=True)
    rec["m2"] = m2
    rec["pool"] = phase_stream_pool(torch, mods, mean, std, meta, dev, gpu,
                                    seed)
    rec["http"] = phase_stream_http(torch, mods, mean, std, meta, dev, gpu,
                                    art, x)
    rec["seconds"] = time.perf_counter() - t0
    log(f" streaming phases: {rec['seconds']:.1f} s in all")
    return rec


EVAL_SNR_DB = 5.0          # speech_like_mixtures' SNR, the sweep's SNR list


def write_eval_root(pairs, root):
    """The (clean, mixture) int16 pairs as a reference-layout data root:
    `<root>/subset/{raw,processed}/CSR-1-WSJ-0/WAV/wsj0/si_et_05/<spk>/`
    with `<utt>.wav` (raw clean) and `<utt>_{s,n,x}.wav` (processed), and
    the test split's SNR pickle. Returns (raw dir, processed dir, utterance
    base paths under processed)."""
    from guided_vae_nmf_torch.data import write_dataset, write_wav

    sub = os.path.join(root, "subset")
    rel = os.path.join("CSR-1-WSJ-0", "WAV", "wsj0", "si_et_05")
    raw, proc = (os.path.join(sub, d) + "/" for d in ("raw", "processed"))
    bases = []
    for j, (clean, x) in enumerate(pairs):
        spk = str(440 + j // 2)
        utt = f"{spk}c02{j:02d}"
        for d in (raw, proc):
            os.makedirs(os.path.join(d, rel, spk), exist_ok=True)
        noise = np.clip(x.astype(np.int32) - clean, -32768,
                        32767).astype(np.int16)
        write_wav(os.path.join(raw, rel, spk, utt + ".wav"), clean, 16000)
        base = os.path.join(proc, rel, spk, utt)
        for tag, sig in (("s", clean), ("n", noise), ("x", x)):
            write_wav(f"{base}_{tag}.wav", sig, 16000)
        bases.append(os.path.join(rel, spk, utt))
    write_dataset([EVAL_SNR_DB] * len(pairs), proc, "test", "snr_db")
    return raw, proc, bases


# the campaign's speakers (scripts/eval_campaign.py's splits): WSJ0 split /
# speaker, then NTCD-TIMIT group / speaker; three utterances each
CAMPAIGN_WSJ = (("si_tr_s", "011"), ("si_dt_05", "050"), ("si_et_05", "440"))
CAMPAIGN_NTCD = (("lipspeakers", "Lipspkr1"), ("volunteers", "01M"),
                 ("volunteers", "08F"), ("volunteers", "34M"))


def write_campaign_root(root, seed, seconds=(1.5, 2.5)):
    """21 speech-like clean utterances (int16, lengths drawn from
    `seconds`) in the campaign's layout under `<root>/subset/raw/`:
    `CSR-1-WSJ-0/WAV/wsj0/<split>/<spk>/<spk>c020<j>.wav` and
    `ntcd_timit/Clean/<group>/<spk>/straightcam/s<j>.wav` (NTCD basenames
    repeat across speakers, as in the corpus). Returns the subset dir."""
    from guided_vae_nmf_torch.data import write_wav

    raw = os.path.join(root, "subset", "raw")
    dirs = [(os.path.join(raw, "CSR-1-WSJ-0", "WAV", "wsj0", split, spk),
             spk + "c020") for split, spk in CAMPAIGN_WSJ]
    dirs += [(os.path.join(raw, "ntcd_timit", "Clean", group, spk,
                           "straightcam"), "s") for group, spk in
             CAMPAIGN_NTCD]
    lengths = np.random.RandomState(seed).uniform(*seconds, 3 * len(dirs))
    pairs = speech_like_mixtures(seed, lengths)
    for i, (d, stem) in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        for j in range(3):
            write_wav(os.path.join(d, f"{stem}{j + 1}.wav"),
                      pairs[3 * i + j][0], 16000)
    return os.path.join(root, "subset")


def captured(fn, *args):
    """(fn(*args), what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def figures_and_scripts(torch, root, raw, proc, est, bases, art, tmp, gpu):
    """Figures on the evaluation root: `run_metrics(make_figures=True)`
    (serial, in this process; one `<utt>_fig.png` an utterance beside the
    estimates), then `reconstruct_M1` (the shipped M1's forward on the
    card), `reconstruct_dnn_classif` (the shipped classifier on the card),
    `reconstruct_timo_classif` (the SPP tracker on the card) and
    `visualization` (host) on the same root. Every figure must be a PNG
    that Pillow opens, of more than 16 colours. Returns the record."""
    from PIL import Image

    from guided_vae_nmf_torch.metrics import run_metrics
    from guided_vae_nmf_torch.scripts import (
        reconstruct_M1, reconstruct_dnn_classif, reconstruct_timo_classif,
        visualization)

    def figure_ok(path):
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return False
        with Image.open(path) as im:
            px = np.asarray(im.convert("RGB")).reshape(-1, 3)
        return len(np.unique(px[::97], axis=0)) > 16

    rec = {}
    t0 = time.perf_counter()
    captured(lambda: run_metrics(raw, proc, est, with_f1=True, serial=True,
                                 make_figures=True))
    figs = [os.path.join(est, b) + "_fig.png" for b in bases]
    rec["run_metrics_s"] = time.perf_counter() - t0
    check(all(figure_ok(f) for f in figs),
          f"run_metrics(make_figures=True) did not write {figs}")
    log(f" run_metrics(make_figures=True, serial): {len(figs)} figures, "
        f"{rec['run_metrics_s']:.2f} s with the metrics")
    out = os.path.join(tmp, "figs") + "/"
    cdir = os.path.join(art, "classifier_ibm")
    for name, fn, argv, n in (
            ("reconstruct_M1", reconstruct_M1.main,
             ["--model", os.path.join(art, "M1")], len(bases)),
            ("reconstruct_dnn_classif", reconstruct_dnn_classif.main,
             ["--classifier", cdir], len(bases)),
            ("reconstruct_timo_classif", reconstruct_timo_classif.main, [],
             2 * len(bases)),
            ("visualization", visualization.main,
             ["--dataset_type", "test"], len(bases))):
        t0 = time.perf_counter()
        written, _ = captured(lambda: fn(["--data_root", root, "--output",
                                          out + name + "/", *argv]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        written = list(written)
        check(len(written) == n and all(figure_ok(f) for f in written),
              f"{name} wrote {written}, expected {n} figures")
        rec[name] = {"figures": len(written), "wall_s": wall}
        log(f" {name} (--data_root, shipped weights): {len(written)} "
            f"figures in {wall:.2f} s ({gpu})")
    return rec


def phase_evaluation(torch, mods, mean, std, meta, batch, dev, gpu, art,
                     seed):
    """The evaluation protocol on the card with the main batch's mixtures
    and the shipped weights: `gvnmf-torch enhance` on a directory (one
    padded batch; the main path's launches; PCM equal to enhance_to_audio
    with the same seed), `evaluate_M2_ibm` then `run_metrics_M2` and
    `run_metrics_mixture` through the spawn pool, `energy_ratios_torch` on
    the card against numpy, the `metrics` subcommand against the library,
    the `stream` subcommand against its enhancer (no K1 / K2 launch) and
    the doctor. Returns the record."""
    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch import cli
    from guided_vae_nmf_torch.data import read_wav, read_wav_int16, write_wav
    from guided_vae_nmf_torch.dsp import frame_count, stft
    from guided_vae_nmf_torch.metrics import (
        energy_ratios, energy_ratios_torch, mos_lqo_wb, stoi)
    from guided_vae_nmf_torch.metrics.pesq import pesq
    from guided_vae_nmf_torch.pipeline import (
        enhance_to_audio, make_labels, plan_batches)
    from guided_vae_nmf_torch.scripts import (
        evaluate_M2_ibm, run_metrics_M2, run_metrics_mixture)
    from guided_vae_nmf_torch.streaming import HOP, StreamingM2Enhancer

    model, classifier = mods
    pairs = batch[0]
    m2_dir, cdir = (os.path.join(art, d) for d in ("M2_ibm",
                                                   "classifier_ibm"))
    audio_s = sum(len(x) for _, x in pairs) / 16000
    rec = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        raw, proc, bases = write_eval_root(pairs, os.path.join(tmp, "data"))

        # -- gvnmf-torch enhance <dir> <out>/ against the library ---------
        mix_dir, out_dir = os.path.join(tmp, "mix"), os.path.join(tmp, "cli")
        os.makedirs(mix_dir)
        mix_paths = []
        for j, (_, x) in enumerate(pairs):
            mix_paths.append(os.path.join(mix_dir, f"utt{j}.wav"))
            write_wav(mix_paths[-1], x, 16000)
        port.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out = captured(cli.main, [
            "enhance", mix_dir, out_dir + "/", "--model", m2_dir,
            "--classifier", cdir, "--seed", str(seed)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = port.launch_counts()
        check(rc == 0, f"gvnmf-torch enhance returned {rc}")
        check(counts == expected_launches(**MAIN_LAUNCHES),
              f"gvnmf-torch enhance launches {counts}, expected "
              f"{MAIN_LAUNCHES} (one padded batch)")
        xs = [read_wav(p)[0].astype(np.float32) for p in mix_paths]
        X = [stft(x) for x in xs]
        ys = [make_labels("dnn", np.abs(Xi) ** 2, classifier=classifier,
                          mean=mean, std=std, features=meta["features"],
                          dnn_threshold=meta["threshold"])[1] for Xi in X]
        s_list, _ = enhance_to_audio(
            model, X, [len(x) for x in xs], ys=ys,
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        for j, s in enumerate(s_list):
            ref_path = os.path.join(tmp, f"ref{j}.wav")
            write_wav(ref_path, s, 16000)
            got = read_wav_int16(os.path.join(out_dir,
                                              f"utt{j}_enhanced.wav"))[0]
            check(torch.equal(torch.from_numpy(got), torch.from_numpy(
                read_wav_int16(ref_path)[0])),
                f"gvnmf-torch enhance utt{j} differs from enhance_to_audio")
        log(f" gvnmf-torch enhance {mix_dir}/ (4 files, one padded batch): "
            f"{wall:.3f} s wall with model loads, wav I/O and labels = "
            f"{audio_s / wall:.2f}x realtime ({gpu}); launches {counts}; "
            "PCM equal to enhance_to_audio with the same seed")
        rec["cli_enhance"] = {"wall_s": wall, "audio_s": audio_s,
                              "x_realtime": audio_s / wall,
                              "launches": counts}

        # -- evaluate_M2_ibm, then run_metrics_M2 / run_metrics_mixture ---
        est = os.path.join(tmp, "M2_ibm_dnn_enhanced") + "/"
        root = os.path.join(tmp, "data")
        files = [b + ".wav" for b in bases]
        n_batches = len(plan_batches(
            files, [frame_count(len(x)) for _, x in pairs]))
        port.reset_launch_counts()
        res, _ = captured(evaluate_M2_ibm.main, [
            "--data_root", root, "--model", m2_dir, "--classifier", cdir,
            "--output", est])
        counts = port.launch_counts()
        check(counts == expected_launches(n_batches=n_batches,
                                          **MAIN_LAUNCHES),
              f"evaluate_M2_ibm launches {counts}, expected {MAIN_LAUNCHES}"
              f" a batch over {n_batches} batches")
        check(res.n_processed == len(pairs), "evaluate_M2_ibm processed "
              f"{res.n_processed} of {len(pairs)}")
        log(f" evaluate_M2_ibm (dnn labels, MCEMConfig()): {len(pairs)} "
            f"files in {float(res):.3f} s = {len(pairs) / float(res):.3f} "
            f"files/s, {audio_s / float(res):.2f}x realtime, {n_batches} "
            f"batches, launches {counts}")
        sweeps = {}
        for name, fn, argv in (
                ("run_metrics_M2", run_metrics_M2.main,
                 ["--data_root", root, "--est_dir", est]),
                ("run_metrics_mixture", run_metrics_mixture.main,
                 ["--data_root", root])):
            t0 = time.perf_counter()
            (keys, rows, _, _), _ = captured(fn, argv)
            w = time.perf_counter() - t0
            check(len(rows) == len(pairs)
                  and all(np.all(np.isfinite(r)) for r in rows),
                  f"{name}: rows {rows}")
            means = {k: float(np.mean([r[i] for r in rows]))
                     for i, k in enumerate(keys)}
            sweeps[name] = {"wall_s": w, "utt_per_s": len(rows) / w,
                            "keys": keys, "rows": [list(map(float, r))
                                                   for r in rows],
                            "means": means}
            log(f" {name} (spawn pool, {min(8, len(rows))} workers, pool "
                f"start included): {len(rows)} utterances in {w:.3f} s = "
                f"{len(rows) / w:.3f} utterances/s")
        from guided_vae_nmf_torch.metrics.runner import metrics_pool

        t0 = time.perf_counter()
        with metrics_pool(len(pairs)) as ex:
            list(ex.map(abs, range(len(pairs))))
        sweeps["pool_start_s"] = time.perf_counter() - t0
        log(f" a spawn pool of {len(pairs)} workers alone (start, one "
            f"trivial task each, shutdown): {sweeps['pool_start_s']:.3f} s")
        out_m, floor = sweeps["run_metrics_M2"]["means"], \
            sweeps["run_metrics_mixture"]["means"]
        log("  means, synthetic mixtures, no quality claim: "
            + ", ".join(f"{k} {out_m[k]:.4f} (mixture {floor[k]:.4f})"
                        for k in ("SI-SDR", "SI-SIR", "SI-SAR", "ESTOI",
                                  "PESQ"))
            + f", F1 {out_m['F1']:.4f}")
        rec["evaluate_M2_ibm"] = {"wall_s": float(res),
                                  "files_per_s": len(pairs) / float(res),
                                  "launches": counts}
        rec["metrics"] = sweeps
        rec["figures"] = figures_and_scripts(
            torch, root, raw, proc, est, bases, art, tmp, gpu)

        # -- energy_ratios_torch on the card over the padded batch ---------
        sigs = []
        for b in bases:
            s, _ = read_wav(os.path.join(proc, b) + "_s.wav")
            n, _ = read_wav(os.path.join(proc, b) + "_n.wav")
            sh, _ = read_wav(os.path.join(est, b) + "_s_est.wav")
            ln = min(len(s), len(sh))
            sigs.append((sh[:ln], s[:ln], n[:ln]))
        T = max(len(a[0]) for a in sigs)
        errs = {}
        for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
            padded_b = torch.zeros(3, len(sigs), T, dtype=torch.float64)
            for j, trio in enumerate(sigs):
                for k, a in enumerate(trio):
                    padded_b[k, j, :len(a)] = torch.from_numpy(a)
            got = energy_ratios_torch(*(a.to(dev, dtype) for a in padded_b))
            err = max(abs(float(g[j]) - r) for j, trio in enumerate(sigs)
                      for g, r in zip(got, energy_ratios(*trio)))
            errs[str(dtype)] = err
            log(f" energy_ratios_torch on the card, {dtype}, B={len(sigs)} "
                f"zero-padded to {T}: max |dB - numpy| {err:.3e} (needs < "
                f"{tol:g})")
            check(err < tol, f"energy_ratios_torch {dtype} off numpy by "
                  f"{err} dB")
        rec["energy_ratios_torch_max_err_db"] = errs

        # -- the metrics subcommand against the library --------------------
        b = bases[0]
        paths = (os.path.join(proc, b) + "_s.wav",
                 os.path.join(est, b) + "_s_est.wav",
                 os.path.join(proc, b) + "_x.wav")
        rc, out = captured(cli.main, ["metrics", "--clean", paths[0],
                                      "--enhanced", paths[1], "--mixture",
                                      paths[2]])
        s, _ = read_wav(paths[0])
        sh, _ = read_wav(paths[1])
        x, _ = read_wav(paths[2])
        ln = min(len(s), len(sh), len(x))
        s, sh = s[:ln], sh[:ln]
        sdr, sir, sar = energy_ratios(sh, s, x[:ln] - s)
        want = {"ESTOI": f"{stoi(s, sh, 16000, True):.4f}",
                # the JAX command's composition, kept for parity
                "PESQ-wb (MOS-LQO)":
                    f"{mos_lqo_wb(pesq(16000, s, sh, 'wb')):.3f}",
                "SI-SDR": f"{sdr:+.2f} dB", "SI-SIR": f"{sir:+.2f} dB",
                "SI-SAR": f"{sar:+.2f} dB"}
        got = dict(line.rsplit("  ", 1) for line in out.splitlines())
        got = {k.strip(): v for k, v in got.items()}
        check(rc == 0 and got == want,
              f"gvnmf-torch metrics printed {got}, the library gives {want}")
        log(f" gvnmf-torch metrics on {os.path.basename(b)}: {got} (equal "
            "to the library's values)")

        # -- the stream subcommand against its enhancer ---------------------
        _, x16 = speech_like_mixtures(seed + 4, (STREAM_SECONDS,),
                                      bursts=3)[0]
        s_in, s_out = (os.path.join(tmp, f"stream_{t}.wav")
                       for t in ("in", "out"))
        write_wav(s_in, x16, 16000)
        prof = "streaming-low-latency"
        port.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, _ = captured(cli.main, [
            "stream", s_in, s_out, "--model", m2_dir, "--label", "dnn",
            "--classifier", cdir, "--profile", prof])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"gvnmf-torch stream returned {rc}")
        check_no_launches("gvnmf-torch stream")
        enh = StreamingM2Enhancer(model, device=dev, **stream_kwargs(
            prof, classifier, mean, std, meta))
        xf = read_wav(s_in)[0].astype(np.float32)
        chunk = enh.chunk_frames * HOP
        y = np.concatenate([enh.push(xf[lo:lo + chunk])
                            for lo in range(0, len(xf), chunk)]
                           + [enh.flush()])
        ref_path = os.path.join(tmp, "stream_ref.wav")
        write_wav(ref_path, y, 16000)
        a, r = (read_wav_int16(p)[0].astype(np.int32)
                for p in (s_out, ref_path))
        diff = int(np.abs(a - r).max()) if len(a) == len(r) else -1
        log(f" gvnmf-torch stream --profile {prof} ({STREAM_SECONDS} s, "
            f"three noise bursts): {wall:.3f} s wall with model loads and "
            f"wav I/O; 0 K1 / K2 launches; max |PCM - enhancer| {diff} LSB "
            "(needs 0)")
        check(diff == 0, "gvnmf-torch stream differs from its enhancer")
        rec["cli_stream"] = {"wall_s": wall, "audio_s": STREAM_SECONDS,
                             "max_lsb": diff}

        # -- the doctor ----------------------------------------------------
        rc, out = captured(cli.main, ["doctor"])
        rows = [ln.strip() for ln in out.splitlines()[1:]]
        log(" gvnmf-torch doctor: " + "; ".join(rows))
        check(rc == 0 and not any(r.startswith("FAIL") for r in rows)
              and "ok  kernel library mh_chain: built" in rows
              and "ok  kernel library nmf_sums: built" in rows
              and any(r.startswith("ok  cuda: 1 device(s)") for r in rows),
              "gvnmf-torch doctor did not find the card and both kernel "
              "libraries")
        check(any(r.startswith("ok  native C++ loader: loaded")
                  for r in rows),
              "gvnmf-torch doctor did not find the native loader")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f" evaluation-protocol phase: {rec['seconds']:.1f} s in all")
    return rec


# -- training -----------------------------------------------------------

TRAIN_UTTS = 48                    # clean utterances of the training data
TRAIN_SECONDS = (3.0, 5.0)         # the range of their lengths
TRAIN_EPOCHS = 3
# (family, store labels, checkpoint name, extra `train` flags): the
# shipped models' widths (M1 513/32/(128, 128), M2 513/513/32/(128, 128),
# classifier 513/(128, 128)/513, Wiener 513/(128 x 5)/513), batch 128,
# Adam 1e-3
TRAIN_FAMILIES = (
    ("m1", "noisy_labels", "M1", []),
    ("m2", "noisy_labels", "M2", []),
    ("classifier", "noisy_labels", "Classifier", []),
    ("wiener", "noisy_wiener_labels", "Wiener",
     ["--h_dim", "128,128,128,128,128"]),
)
CARD_CPU_FRAMES = (2560, 640)      # the card-against-CPU fits' frames
# measured (NVIDIA H100 80GB HBM3): losses 2.6e-7 / 9.9e-7 apart, weights
# 8.9e-8 / 3.4e-4 (classifier / Wiener): Adam moves a weight whose gradient
# sits at rounding level (a dead ReLU's inputs) by up to lr a step either
# way, so the weights are held to lr
CARD_CPU_TOL = dict(loss_rtol=1e-5, weight_atol=1e-3)
# one M1 / M2 step: Adam's first step moves a weight by about lr whatever
# its gradient's size, so a gradient at float32 rounding level may move a
# weight 2 lr the other way on the other device
STEP_WEIGHT_ATOL = 2.1e-3
STEP_GRAD_TOL = dict(rtol=1e-4, scale_atol=1e-5)


class MemH5:
    """In-memory stand-in for the part of h5py's `File` that
    `guided_vae_nmf_torch/data/h5io.py` calls (attrs, create / resize /
    slice / delete a dataset), for a machine without h5py: the stores'
    code runs as written, without HDF5 compression or disk I/O."""

    files = {}

    class Dataset:
        def __init__(self, shape, dtype, chunks=None, compression=None,
                     maxshape=None):
            self.data = np.zeros(shape, dtype)
            self.chunks = chunks
            self.compression = compression

        @property
        def shape(self):
            return self.data.shape

        def resize(self, n, axis):
            grow = [(0, 0)] * self.data.ndim
            grow[axis] = (0, n - self.data.shape[axis])
            self.data = np.pad(self.data, grow)

        def __getitem__(self, key):
            return np.array(self.data[key])

        def __setitem__(self, key, value):
            self.data[key] = value

    class File:
        def __init__(self, path, mode="r", **_):
            if mode == "r" and path not in MemH5.files:
                raise FileNotFoundError(path)
            store = MemH5.files.setdefault(path, ({}, {}))
            self.attrs, self._sets = store

        def __contains__(self, name):
            return name in self._sets

        def __getitem__(self, name):
            return self._sets[name]

        def __delitem__(self, name):
            del self._sets[name]

        def create_dataset(self, name, shape, dtype, **kw):
            self._sets[name] = MemH5.Dataset(shape, dtype, **kw)
            return self._sets[name]

        def close(self):
            pass


def store_backend():
    """'h5py', or 'memory' (MemH5 installed) where h5py is missing."""
    import importlib.util

    from guided_vae_nmf_torch.data import h5io

    if importlib.util.find_spec("h5py") is not None:
        return "h5py"
    h5io._h5 = lambda: MemH5
    return "memory"


def recorded_fits():
    """Wrap trainer.fit to keep each run's history by model dir; returns
    (records, restore)."""
    from guided_vae_nmf_torch.train import trainer

    records = {}
    orig = trainer.fit

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        records[a[5]] = out[1]
        return out

    trainer.fit = wrapped

    def restore():
        trainer.fit = orig
    return records, restore


def training_data(torch, tmp, seed):
    """Clean utterances and the synthetic noise bank as wavs, then
    `gvnmf-torch dataset` twice (noisy_labels, noisy_wiener_labels).
    Returns ({labels: store path}, record)."""
    from guided_vae_nmf_torch import cli
    from guided_vae_nmf_torch.data import synthetic_noise_bank, write_wav

    rng = np.random.RandomState(seed + 17)
    seconds = rng.uniform(*TRAIN_SECONDS, TRAIN_UTTS)
    clean_dir, noise_dir = (os.path.join(tmp, d) for d in ("clean",
                                                           "noise"))
    os.makedirs(clean_dir)
    os.makedirs(noise_dir)
    t0 = time.perf_counter()
    for j, (clean, _) in enumerate(speech_like_mixtures(seed + 17,
                                                        seconds)):
        write_wav(os.path.join(clean_dir, f"utt{j:02d}.wav"), clean, 16000)
    bank = synthetic_noise_bank()
    for name, x in bank.items():
        write_wav(os.path.join(noise_dir, f"{name}.wav"), x, 16000)
    wav_s = time.perf_counter() - t0
    stores, rec = {}, {"utterances": TRAIN_UTTS,
                       "audio_s": float(seconds.sum()),
                       "noise_types": sorted(bank), "wavs_s": wav_s}
    for labels in ("noisy_labels", "noisy_wiener_labels"):
        stores[labels] = os.path.join(tmp, f"{labels}.h5")
        t0 = time.perf_counter()
        rc, out = captured(cli.main, [
            "dataset", "--clean", clean_dir, "--noise", noise_dir,
            "--out", stores[labels], "--labels", labels,
            "--seed", str(seed)])
        wall = time.perf_counter() - t0
        check(rc == 0, f"gvnmf-torch dataset {labels} returned {rc}")
        rec[labels] = {"wall_s": wall, "printed": out.strip()}
        log(f"  gvnmf-torch dataset --labels {labels}: {wall:.2f} s; "
            f"{out.strip()}")
    log(f"  {TRAIN_UTTS} clean utterances ({seconds.sum():.1f} s of audio, "
        f"{TRAIN_SECONDS[0]:g}-{TRAIN_SECONDS[1]:g} s each) and "
        f"{len(bank)} noise wavs written in {wav_s:.2f} s")
    return stores, rec


def read_store(path):
    """(((Xtr, Ytr), (Xva, Yva)), train mean, train std) of a store."""
    from guided_vae_nmf_torch.data import H5FrameReader

    rtr = H5FrameReader(path, "train")
    rva = H5FrameReader(path, "validation")
    out = (rtr.load_all(), rva.load_all()), rtr.mean[:, 0], rtr.std[:, 0]
    rtr.close()
    rva.close()
    return out


def epoch_line(path):
    """[(epoch, train, valid)] of an output_epoch.log."""
    rows = []
    with open(path) as f:
        for line in f:
            m = re.match(r"Epoch: (\d+) Train loss: (\S+) Valid loss: (\S+)",
                         line)
            rows.append((int(m.group(1)), float(m.group(2)),
                         float(m.group(3))))
    return rows


def training_runs(torch, tmp, stores, gpu):
    """`gvnmf-torch train <family> --epochs 3` for the four families on
    the card, with each run's checkpoints, logs and side-cars checked and
    its steady epochs (2-3) timed. Returns {family: record}."""
    from guided_vae_nmf_torch import cli

    records, restore = recorded_fits()
    out = {}
    try:
        for family, labels, name, extra in TRAIN_FAMILIES:
            model_dir = os.path.join(tmp, f"train_{family}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, printed = captured(cli.main, [
                "train", family, "--h5", stores[labels], "--out", model_dir,
                "--epochs", str(TRAIN_EPOCHS), *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"gvnmf-torch train {family} returned {rc}")
            files = sorted(os.listdir(model_dir))
            ckpts = [f for f in files if re.fullmatch(
                rf"{name}_epoch_(\d{{3}})_vloss_-?\d+\.\d\d\.ckpt\.npz", f)]
            check([int(c.split("_epoch_")[1][:3]) for c in ckpts]
                  == list(range(1, TRAIN_EPOCHS + 1)),
                  f"{family}: checkpoints {ckpts}")
            want = {"output_batch.log", "output_epoch.log",
                    "resume_state.npz"}
            if family in ("classifier", "wiener"):
                want |= {"trainset_mean.npy", "trainset_std.npy"}
            if family == "classifier":
                want.add("classifier_meta.json")
            check(want <= set(files), f"{family}: missing "
                  f"{sorted(want - set(files))}")
            rows = epoch_line(os.path.join(model_dir, "output_epoch.log"))
            check(len(rows) == TRAIN_EPOCHS and all(
                np.isfinite(v) for r in rows for v in r[1:]),
                f"{family}: epoch log {rows}")
            check(rows[-1][1] < rows[0][1],
                  f"{family}: training loss did not fall {rows}")
            hist = records[model_dir]
            steady = [h["time_s"] for h in hist[1:]]
            (Xtr, _), _ = read_store(stores[labels])[0]
            frames = (len(Xtr) // 128) * 128
            epoch_s = float(np.mean(steady))
            out[family] = {
                "model_dir": model_dir, "wall_s": wall, "epochs": rows,
                "epoch_s": [h["time_s"] for h in hist],
                "steady_epoch_s": epoch_s, "train_frames": frames,
                "frames_per_s": frames / epoch_s}
            log(f"  train {family}: {wall:.2f} s for {TRAIN_EPOCHS} epochs "
                f"with store load; losses {[(r[1], r[2]) for r in rows]}; "
                f"epochs {[round(h['time_s'], 4) for h in hist]} s; steady "
                f"epoch {epoch_s:.4f} s = {frames / epoch_s:.0f} training "
                f"frames/s ({frames} frames, batch 128; {gpu})")
    finally:
        restore()
    return out


def training_profile(torch, store, dev, gpu):
    """One epoch of M2 (fresh weights, frames already on the card) under
    torch.profiler with device activity only and the CUDA sync debug mode
    counting host syncs. Returns the record."""
    import warnings

    from guided_vae_nmf_torch.models import dgm_init
    from guided_vae_nmf_torch.train import TrainConfig, fit

    ((Xtr, Ytr), (Xva, Yva)), _, _ = read_store(store)
    data = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (Xtr, Ytr, Xva, Yva)]
    model = dgm_init(torch.Generator().manual_seed(0),
                     [513, 513, 32, [128, 128]]).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        def one_epoch():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fit(model, "m2", data[:2], data[2:], TrainConfig(end_epoch=1),
                    tmp, "M2", device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        one_epoch()                                    # warm
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            wall, busy, n = profile_device(torch, one_epoch)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    log(f"  one M2 epoch profiled ({len(Xtr) // 128} batches of 128, "
        f"{len(Yva)} validation frames): {wall:.2f} ms wall, {n} device "
        f"activities, {busy:.2f} ms busy = {100 * busy / wall:.1f} % busy; "
        f"{len(syncs)} host syncs ({gpu})")
    for s in sorted(set(syncs)):
        log(f"    sync: {s[:120]}")
    return {"wall_ms": wall, "busy_ms": busy, "activities": n,
            "busy_share": busy / wall, "host_syncs": len(syncs),
            "sync_messages": sorted(set(syncs))}


def training_card_vs_cpu(torch, stores, dev, seed):
    """The classifier's and the Wiener DNN's `fit`, 2 epochs each from the
    same initial weights on the card and on the CPU, and one M1 / M2 step
    with z = mu on each. Returns the record."""
    import copy

    from guided_vae_nmf_torch.models import (classifier_init, dgm_init,
                                             vae_init)
    from guided_vae_nmf_torch.train import TrainConfig, fit, trainer

    n_tr, n_va = CARD_CPU_FRAMES
    rec = {}
    for family, labels, h in (("classifier", "noisy_labels", [128, 128]),
                              ("wiener", "noisy_wiener_labels", [128] * 5)):
        ((Xtr, Ytr), (Xva, Yva)), mean, std = read_store(stores[labels])
        Xtr = ((Xtr[:n_tr] - mean) / (std + 1e-8)).astype(np.float32)
        Xva = ((Xva[:n_va] - mean) / (std + 1e-8)).astype(np.float32)
        init = classifier_init(torch.Generator().manual_seed(seed),
                               [513, h, 513])
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
                m, hist = fit(init, family, (Xtr, Ytr[:n_tr]),
                              (Xva, Yva[:n_va]), TrainConfig(end_epoch=2),
                              os.path.join(tmp, tag), family, device=d)
                runs[tag] = (m.cpu().state_dict(), hist)
        (wc, hc), (wg, hg) = runs["cpu"], runs["card"]
        loss_rel = max(abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(hc, hg)
                       for k in ("train", "valid"))
        w_abs = max(float((wc[k] - wg[k]).abs().max()) for k in wc)
        ok = (loss_rel <= CARD_CPU_TOL["loss_rtol"]
              and w_abs <= CARD_CPU_TOL["weight_atol"])
        log(f"  {family} fit, 2 epochs of {n_tr} frames, card against CPU: "
            f"epoch losses {loss_rel:.2e} apart (rel), final weights "
            f"{w_abs:.2e} apart (abs); tolerance {CARD_CPU_TOL}  "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{family} fit: card and CPU disagree")
        rec[family] = {"loss_rel": loss_rel, "weight_abs": w_abs}

    ((Xtr, Ytr), _), _, _ = read_store(stores["noisy_labels"])
    for family, init in (("m1", vae_init(torch.Generator().manual_seed(
            seed), [513, 32, [128, 128]])),
            ("m2", dgm_init(torch.Generator().manual_seed(seed),
                            [513, 513, 32, [128, 128]]))):
        out = {}
        for tag, d in (("cpu", torch.device("cpu")), ("card", dev)):
            m = copy.deepcopy(init).to(d)
            leaves = trainer._trainable(m)
            for _, t in leaves:
                t.requires_grad_(True)
            opt = trainer.make_optimizer(TrainConfig(),
                                         [t for _, t in leaves])
            batch = (torch.from_numpy(Xtr[:128]).to(d),
                     torch.from_numpy(Ytr[:128]).to(d))
            loss, _ = trainer.LOSSES[family](m, batch, None, 1e-8)
            opt.zero_grad()
            loss.backward()
            grads = {k: t.grad.cpu().numpy().copy() for k, t in leaves}
            opt.step()
            out[tag] = (float(loss.detach()), grads, {
                k: t.detach().cpu().numpy() for k, t in leaves})
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["card"]
        g_err = max(float(np.max(np.abs(gg[k] - gc[k]) / (
            STEP_GRAD_TOL["rtol"] * np.abs(gc[k])
            + STEP_GRAD_TOL["scale_atol"] * np.abs(gc[k]).max() + 1e-30)))
            for k in gc)
        w_abs = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc)
        moved = sum(int(np.sum(np.abs(pg[k] - pc[k]) > 1e-6)) for k in pc)
        total = sum(v.size for v in pc.values())
        ok = (abs(lg - lc) <= 1e-5 * abs(lc) and g_err <= 1
              and w_abs <= STEP_WEIGHT_ATOL)
        log(f"  {family} step (z = mu, 128 store frames), card against CPU: "
            f"loss {lg:.6g} vs {lc:.6g}, gradients at {g_err:.3f} of "
            f"their tolerance ({STEP_GRAD_TOL}), weights after the step "
            f"{w_abs:.2e} apart (needs <= {STEP_WEIGHT_ATOL:g}), {moved} of "
            f"{total} past 1e-6  {'ok' if ok else 'FAIL'}")
        check(ok, f"{family} step: card and CPU disagree")
        rec[family] = {"loss": lg, "loss_cpu": lc, "grad_err": g_err,
                       "weight_abs": w_abs, "past_1e-6": moved,
                       "elements": total}
    return rec


def phase_training(torch, classifier, mean, std, batch, dev, gpu, seed):
    """Training at the shipped models' full width on the card: data
    synthesis through `gvnmf-torch dataset`, `gvnmf-torch train` for the
    four families, one profiled M2 epoch, the card against the CPU, and a
    resumed 4th M2 epoch whose best checkpoint drives one main-path batch.
    Returns the record."""
    from guided_vae_nmf_torch import cli
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.train import load_model

    t_phase = time.perf_counter()
    rec = {"store": store_backend()}
    note = ("" if rec["store"] == "h5py" else ": h5py is missing, the "
            "stores' code runs over chip_smoke.MemH5 (no HDF5 compression "
            "or disk I/O)")
    log(f"  frame stores: {rec['store']}{note}")
    with tempfile.TemporaryDirectory() as tmp:
        stores, rec["data"] = training_data(torch, tmp, seed)
        rec["runs"] = training_runs(torch, tmp, stores, gpu)
        rec["profile_m2_epoch"] = training_profile(
            torch, stores["noisy_labels"], dev, gpu)
        rec["card_vs_cpu"] = training_card_vs_cpu(torch, stores, dev, seed)

        m2_dir = rec["runs"]["m2"]["model_dir"]
        rc, out = captured(cli.main, [
            "train", "m2", "--h5", stores["noisy_labels"], "--out", m2_dir,
            "--epochs", str(TRAIN_EPOCHS + 1), "--resume"])
        rows = epoch_line(os.path.join(m2_dir, "output_epoch.log"))
        check(rc == 0 and [r[0] for r in rows] == list(
            range(1, TRAIN_EPOCHS + 2)) and np.isfinite(rows[-1][1]),
            f"resumed M2 run: {rows}")
        check(any(f.startswith(f"M2_epoch_{TRAIN_EPOCHS + 1:03d}_")
                  for f in os.listdir(m2_dir)), "no 4th M2 checkpoint")
        log(f"  train m2 --resume: epoch {rows[-1][0]} train "
            f"{rows[-1][1]:.2f} valid {rows[-1][2]:.2f}")
        model = load_model(m2_dir, kind="dgm", device=dev)
        rec["enhance"] = phase_main(
            torch, model, classifier, mean, std, MCEMConfig(), batch, seed,
            dev, gpu, label="main path with the trained M2")
        rec["enhance"].pop("s16")
        rec["enhance"].pop("y_hard")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f" training phase: {rec['seconds']:.1f} s in all")
    return rec


# ---------------------------------------------------------------------------
# The remaining scripts: bench_niter500 (with its quality gate), bench_long,
# bench_serving, eval_real_noise, warm_cache, eval_campaign, campaign_tables,
# eval_classifier_context, pretrain_subset, bench_train, validate_parity,
# pesq_battery, bench_vpu
# ---------------------------------------------------------------------------

# cut from the scripts' defaults for time (PERF.md §4); widths are the
# shipped models'
SCRIPT_HARNESS = dict(batch=32, n=512, niter=50)    # from niter 500
LONG_MINUTES, LONG_NITER = 30, 100
SERVING_ARGS = dict(rates="2,8", n=16)              # from 2,8,24 and 40
REAL_NOISE_NITER = 100
REAL_NOISE_SYSTEMS = ("m2dnn_spp", "m2oracle_spp", "wiener", "m1_spp")
SPP_LAUNCHES = dict(form="vb", e=100, wf=1, h=0, g=100)
CAMPAIGN_SECONDS = (1.5, 2.5)      # the campaign root's utterances
VPU_M = 1 << 28                    # 1 GiB of float32: past the 50 MB L2
VPU_ITERS = 100                    # at VPU_M, from 400
VPU_MAX_SHARE = 1.05


def add_counts(*counts):
    """The sum of `launch_counts()`-layout dicts."""
    out = expected_launches("wh", 0, 0, 0, 0)
    for c in counts:
        for k, d in c.items():
            for v, n in d.items():
                out[k][v] += n
    return out


def whole_batches(what, counts, form, niter, h=True, level=""):
    """The fused batches of `niter` EM iterations in a run's launch counts
    (one WF launch a batch), checked against `expected_launches` for that
    many batches of the form and level."""
    k = counts["mh_chain"][f"wf_{form}{level}"]
    want = expected_launches(form, niter, 1, niter if h else 0, niter,
                             n_batches=k, level=level)
    check(k > 0 and counts == want, f"{what} launches {nonzero(counts)}, "
          f"expected whole batches of {niter} iterations ({form}{level})")
    return k


def script_argv(**kw):
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def counted(port, torch, fn, *args):
    """(fn(*args), its stdout, the launches it made, its wall s)."""
    port.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, text = captured(fn, *args)
    torch.cuda.synchronize()
    return out, text, port.launch_counts(), time.perf_counter() - t0


def same_files(a, b):
    """The relative paths under `a`, each file equal to its namesake under
    `b` (and `b` holding no other)."""
    names = [sorted(os.path.relpath(os.path.join(r, f), d)
                    for r, _, fs in os.walk(d) for f in fs) for d in (a, b)]
    check(names[0] == names[1] and names[0], f"{a} and {b} hold other files")
    for rel in names[0]:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            check(fa.read() == fb.read(), f"{rel} differs in {a} and {b}")
    return names[0]


def compare_on_card(name, got, ref, k1d=False):
    """got against ref, reduced on the card (a script's buffers are GBs on
    the host): every element within TOL or, for K1d, within K1D_TOL with at
    most K1D_MAX_PAST of them past TOL. Returns (max abs error, elements
    past TOL, elements)."""
    g, r = got.float(), ref.float()
    check(g.shape == r.shape, f"{name}: shape {tuple(g.shape)} vs "
          f"{tuple(r.shape)}")
    check(bool(g.isfinite().all()), f"{name}: non-finite kernel output")
    err = (g - r).abs()
    past = int((err > TOL["atol"] + TOL["rtol"] * r.abs()).sum())
    n = err.numel()
    if k1d:
        ok = past <= K1D_MAX_PAST * n and bool(
            (err <= K1D_TOL["atol"] + K1D_TOL["rtol"] * r.abs()).all())
        tol = f"{K1D_TOL}, at most {K1D_MAX_PAST:.0%} past TOL"
    else:
        ok, tol = past == 0, str(TOL)
    e = float(err.max())
    log(f"  {name:<10s} max_abs {e:.3e}  past TOL {past} of {n}  tol {tol}"
        f"  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return e, past, n


def hold_at_script_shape(torch, model, B, N, levels, dev, what):
    """K1 in E and WF mode ('wh' form, MCEMConfig()'s chain lengths and
    step, decisive injected noise) at each of `levels`, and K2 'h' / 'g'
    over each E chain's own dump, against their plain versions on the same
    inputs at a script's (B, N), on the shipped decoder. Returns
    {variant: [max abs error, elements past TOL, elements]}."""
    from guided_vae_nmf_torch.mcem import (MCEMConfig, mh_chain,
                                           mh_chain_ref, nmf_sums,
                                           nmf_sums_ref)

    cfg = MCEMConfig()
    c = chain_inputs(torch, model, B, N, cfg.nmf_rank, 5, dev)
    out = {}

    def keep(key, res):
        o = out.setdefault(key, [0.0, 0, 0])
        o[0] = max(o[0], res[0])
        o[1] += res[1]
        o[2] += res[2]

    for mode, ns, bi in (("e", cfg.nsamples_E_step, cfg.burnin_E_step),
                         ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
        noise = decisive_noise(torch, 7, B, N, c["L"], ns + bi, dev)
        names = ["Z", "Vs"] + (["samples", "numW", "denW"] if mode == "e"
                               else ["WFs_sum", "WFn_sum"])
        for level in levels:
            kw = fast_kw(torch, level)
            got = run_chain(c, mh_chain, mode, ns, bi, cfg.var_RW,
                            noise=noise, **kw)
            ref = run_chain(c, mh_chain_ref, mode, ns, bi, cfg.var_RW,
                            noise=noise, **kw)
            key = f"mh_chain_{mode}_wh{level}"
            log(f" {what}: {key} against its plain version at B={B}, "
                f"N={N}, {ns} + {bi} steps:")
            for name, x, y in zip(names, (got[0], got[1]) + tuple(got[2]),
                                  (ref[0], ref[1]) + tuple(ref[2])):
                keep(key, compare_on_card(name, x, y,
                                          k1d=level.endswith("_mm16")))
            del ref
            if mode == "wf":
                continue
            samples, sums = got[2][0], "_fast" if level else ""
            skw = dict(approx_recip=True) if level else {}
            for smode in ("h", "g"):
                key = f"nmf_sums_{smode}_wh{sums}"
                log(f" {what}: {key} over the {level or 'exact'} chain's "
                    f"{samples.dtype} dump {tuple(samples.shape)}:")
                for name, x, y in zip(
                        ("num", "den"),
                        run_sums(c, nmf_sums, samples, smode, **skw),
                        run_sums(c, nmf_sums_ref, samples, smode)):
                    keep(key, compare_on_card(name, x, y))
            del got, samples
        del noise
        torch.cuda.empty_cache()
    return out


def scripts_harness(torch, port, model, root, dev):
    """(a) the bench_niter500 script at SCRIPT_HARNESS with its quality gate
    (one seed) on the evaluation root: each of the four variants twice
    (warm-up, timed) at B=32, N=512, then each test utterance in exact mode
    and in fast_bf16mm (K1d). Then K1a, K1c (fast, trans), K1d, K2a and
    K2c against their plain versions at B=32, N=512."""
    from guided_vae_nmf_torch.data import speech_list
    from guided_vae_nmf_torch.scripts import bench_niter500

    niter = SCRIPT_HARNESS["niter"]
    n_utts = len(speech_list(os.path.join(root, "subset", "raw") + "/",
                             "test"))
    out, text, counts, wall = counted(
        port, torch, bench_niter500.main,
        script_argv(**SCRIPT_HARNESS, quality=1, seeds=1, data_root=root,
                    device=dev))
    gate = expected_launches("wh", n_utts * niter, n_utts, n_utts * niter,
                             n_utts * niter)
    k1d = expected_launches("wh", n_utts * niter, n_utts, n_utts * niter,
                            n_utts * niter, level="_fast_mm16")
    want = add_counts(harness_launches(niter, 0), gate, k1d)
    check(counts == want, f"bench_niter500 launches {nonzero(counts)}, "
          f"expected {nonzero(want)}")
    times = {k: out[k] for k in out if k.endswith(("_s", "_rtf"))}
    log(f" (a) bench_niter500 {SCRIPT_HARNESS} (cut from niter 500) + "
        f"--quality 1 --seeds 1 on {n_utts} utterances: {wall:.1f} s; "
        f"{times}; quality {out['quality']} (synthetic mixtures: no quality "
        f"claim); launches {nonzero(counts)}")
    vs_plain = hold_at_script_shape(
        torch, model, SCRIPT_HARNESS["batch"], SCRIPT_HARNESS["n"],
        ("", "_fast", "_trans", "_fast_mm16"), dev, "(a)")
    return {"record": out, "launches": counts, "wall_s": wall,
            "vs_plain": vs_plain}


def scripts_long(torch, port, model, root, tmp, dev):
    """(b) bench_long: one recording of LONG_MINUTES through K1c / K2c in
    one launch a step at the bucketed N, twice (cold, warm); the warm
    run's files equal the cold run's byte for byte. Then K1c and K2c
    against their plain versions at B=1 and that N."""
    from guided_vae_nmf_torch.pipeline import bucket_frames
    from guided_vae_nmf_torch.scripts import bench_long

    work = os.path.join(tmp, "long")
    torch.cuda.reset_peak_memory_stats()
    row, _, counts, wall = counted(
        port, torch, bench_long.main,
        script_argv(minutes=LONG_MINUTES, niter=LONG_NITER, work=work,
                    data_root=root, device=dev))
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches("wh", LONG_NITER, 1, LONG_NITER, LONG_NITER,
                             n_batches=2, level="_fast")
    check(counts == want, f"bench_long launches {nonzero(counts)}, "
          f"expected {nonzero(want)}: one fused batch a run")
    files = same_files(os.path.join(work, "est"), os.path.join(work, "est2"))
    n_pad = bucket_frames(row["frames"])
    log(f" (b) bench_long {LONG_MINUTES} min, niter {LONG_NITER}: "
        f"{row['frames']} frames, bucketed N={n_pad} in one K1c launch a "
        f"step; cold {row['cold_s']} s, warm {row['warm_s']} s, rtf_warm "
        f"{row['rtf_warm']}x; sample_buffer_gb {row['sample_buffer_gb']}; "
        f"max_memory_allocated {peak / 1e9:.2f} GB; launches "
        f"{nonzero(counts)}; warm files equal the cold run's ({files})")
    vs_plain = hold_at_script_shape(torch, model, 1, n_pad, ("_fast",), dev,
                                    "(b)")
    return {"row": row, "n_pad": n_pad, "max_memory_allocated": peak,
            "launches": counts, "wall_s": wall, "vs_plain": vs_plain}


def scripts_serving(torch, port, dev):
    """(c) bench_serving: Poisson arrivals at SERVING_ARGS; every request
    answered (a future that fails raises out of the script)."""
    from guided_vae_nmf_torch.scripts import bench_serving

    out, _, counts, wall = counted(port, torch, bench_serving.main,
                                   script_argv(**SERVING_ARGS, device=dev))
    check(len(out["loads"]) == len(SERVING_ARGS["rates"].split(",")),
          f"bench_serving loads {out['loads']}")
    on = nonzero(counts)
    check(set(on) == {"mh_chain", "nmf_sums"} and set(on["mh_chain"]) ==
          {"e_vb", "wf_vb"} and set(on["nmf_sums"]) == {"g_vb"},
          f"bench_serving launched {on} (spp noise model: K1b / K2b)")
    for load in out["loads"]:
        log(f" (c) bench_serving {load['offered_req_s']} req/s, "
            f"{SERVING_ARGS['n']} requests all answered: achieved "
            f"{load['achieved_req_s']} req/s, p50 {load['p50_ms']} ms, p95 "
            f"{load['p95_ms']} ms, mean batch {load['mean_batch']}, rtf "
            f"{load['rtf']}x")
    return {"record": out, "launches": counts, "wall_s": wall}


def scripts_real_noise(torch, port, root, tmp, dev):
    """(d) eval_real_noise, one default system a run: an MCEM system's
    launches those of whole spp batches (the four utterances in their
    buckets), the Wiener baseline none, and each system's files equal to what `enhance_files` /
    `enhance_files_wiener` write with the same arguments in this call."""
    from guided_vae_nmf_torch.data import speech_list
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.pipeline import (enhance_files,
                                               enhance_files_wiener)
    from guided_vae_nmf_torch.scripts import eval_real_noise
    from guided_vae_nmf_torch.train import load_model, load_norm_stats

    art = "artifacts/pretrained"
    sub = os.path.join(root, "subset")
    files = speech_list(os.path.join(sub, "raw") + "/", "test")
    proc = os.path.join(sub, "processed") + "/"
    work = os.path.join(tmp, "real_noise")
    cfg = MCEMConfig(niter=REAL_NOISE_NITER)
    kw = dict(cfg=cfg, batch_size=4, noise_model="spp", seed=0, device=dev)
    rec = {}
    for name in REAL_NOISE_SYSTEMS:
        res, text, counts, wall = counted(
            port, torch, eval_real_noise.main,
            script_argv(niter=REAL_NOISE_NITER, systems=name, work=work,
                        data_root=root, device=dev))
        if name == "wiener":
            check(not nonzero(counts), f"eval_real_noise wiener launched "
                  f"{nonzero(counts)}")
        else:
            whole_batches(f"eval_real_noise {name}", counts, "vb",
                          REAL_NOISE_NITER, h=False)
        ref = os.path.join(tmp, "real_noise_ref", name)
        if name == "wiener":
            wdir = os.path.join(art, "wiener")
            enhance_files_wiener(
                files, proc, ref, load_model(wdir, kind="classifier",
                                             device=dev),
                *load_norm_stats(wdir), device=dev)
        elif name == "m1_spp":
            enhance_files(files, proc, ref, load_model(
                os.path.join(art, "M1"), kind="vae", device=dev),
                model_type="m1", **kw)
        else:
            m2 = load_model(os.path.join(art, "M2_ibm"), kind="dgm",
                            device=dev)
            cdir = os.path.join(art, "classifier_ibm")
            extra = (dict(classif_type="oracle") if name == "m2oracle_spp"
                     else dict(classif_type="dnn", classifier=load_model(
                         cdir, kind="classifier", device=dev),
                         mean=load_norm_stats(cdir)[0],
                         std=load_norm_stats(cdir)[1]))
            enhance_files(files, proc, ref, m2, model_type="m2", **extra,
                          **kw)
        same = same_files(eval_real_noise.system_dir(work, art, name, "", 0),
                          ref)
        cells = [ln for ln in text.splitlines() if ln.startswith(name)]
        log(f" (d) eval_real_noise {name} (niter {REAL_NOISE_NITER}, "
            f"{len(files)} utterances): {wall:.1f} s with its metrics; "
            f"launches {nonzero(counts)}; {len(same)} files equal to the "
            f"library's; {cells[-1].split(None, 1)[1] if cells else ''}")
        rec[name] = {"rows": res[name], "launches": counts, "wall_s": wall}
    return rec


def scripts_warm_cache(torch, port, dev):
    """(e) warm_cache with the JAX script's grid flags (ignored: the
    kernels take any shape): it loads every `csrc/*.cu` library from the
    build directory, launches nothing, and names the directory."""
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.scripts import warm_cache

    n, text, counts, wall = counted(port, torch, warm_cache.main, [
        "--buckets", "384", "--batch_size", "4", "--labels", "oracle,dnn",
        "--serving", "1", "--stream", "1", "--device", str(dev)])
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    line = f"warmed {len(sources)} programs into {_build.build_dir()}"
    check(n == len(sources) and text.splitlines()[-1] == line
          and not nonzero(counts)
          and all(_build.build_log(s) for s in sources),
          f"warm_cache: {n} programs, last line {text.splitlines()[-1:]}, "
          f"launches {nonzero(counts)}; expected {line!r} and none")
    for ln in text.splitlines():
        log(f" (e) {ln}")
    log(f" (e) warm_cache: {n} libraries ({', '.join(sources)}) in "
        f"{wall:.1f} s")
    return {"programs": n, "wall_s": wall}


def scripts_campaign(torch, port, croot, tmp, dev):
    """(f) eval_campaign --smoke 1 on the campaign root (retrains the six
    families at 2 epochs, 18 mixtures, mixture + m2dnn_reference) and
    campaign_tables on its record; (g) eval_classifier_context over its
    work; (h) pretrain_subset and bench_train; (i) validate_parity, the
    port's half only."""
    from guided_vae_nmf_torch.scripts import (
        bench_train, campaign_tables, eval_campaign, eval_classifier_context,
        pretrain_subset, validate_parity)

    rec = {}
    work = os.path.join(tmp, "campaign")
    base = ["--data_root", croot, "--device", str(dev)]
    res, text, counts, wall = counted(
        port, torch, eval_campaign.main,
        ["--smoke", "1", "--work", work, *base])
    on = nonzero(counts)
    wf = whole_batches("eval_campaign --smoke 1", counts, "wh", 2,
                       level="_fast")
    rows = res["m2dnn_reference"]["rows"]
    check(len(rows) == 18 and len(res["mixture"]["rows"]) == 18,
          "eval_campaign smoke: not 18 rows a system")
    _, tables = captured(campaign_tables.main, [
        "--json", os.path.join(work, "campaign_results.json")])
    check("M2 + DNN (reference parity)" in tables,
          "campaign_tables did not render the smoke record")
    f1 = res["m2dnn_reference"]["f1_by_family"]
    log(f" (f) eval_campaign --smoke 1: {wall:.1f} s (corpus, the six "
        f"families retrained at 2 epochs, {wf} fused batches, two metric "
        f"sweeps); launches {on}; F1 by family {f1}; campaign_tables "
        f"{len(tables.splitlines())} lines")
    rec["campaign"] = {"wall_s": wall, "launches": counts, "f1_by_family": f1,
                       "stats": res["m2dnn_reference"]["stats"]["overall"]}

    t0 = time.perf_counter()
    ctx, _ = captured(eval_classifier_context.main, [
        "--work", work, "--contexts", "0,1", "--epochs", "2",
        "--train_voices", "2", *base])
    f1s = {k: ctx[k]["0.5"]["all"]["F1"] for k in ("k0", "k1")}
    check(all(0.0 <= v <= 1.0 for v in f1s.values()),
          f"eval_classifier_context F1 {f1s}")
    rec["classifier_context"] = {"wall_s": time.perf_counter() - t0,
                                 "f1": f1s}
    log(f" (g) eval_classifier_context --contexts 0,1 --epochs 2: "
        f"{rec['classifier_context']['wall_s']:.1f} s; F1 at 0.5 {f1s}")

    t0 = time.perf_counter()
    out = os.path.join(tmp, "pretrained")
    captured(pretrain_subset.main, ["--epochs", "2", "--out", out, *base])
    fams = sorted(os.listdir(out))
    check(fams == ["M1", "M2_ibm", "M2_vad", "classifier_ibm",
                   "classifier_vad", "wiener"] and all(
        any(f.endswith(".ckpt.npz") for f in os.listdir(os.path.join(
            out, d))) for d in fams), f"pretrain_subset wrote {fams}")
    rec["pretrain_subset_s"] = time.perf_counter() - t0
    row, _ = captured(bench_train.main, ["--epochs", "3", *base])
    check(row["steady_frames_per_s"] > 0 and row["backend"] == "cuda",
          f"bench_train {row}")
    rec["bench_train"] = row
    log(f" (h) pretrain_subset --epochs 2: {rec['pretrain_subset_s']:.1f} s, "
        f"{len(fams)} families; bench_train --epochs 3: "
        f"{row['train_frames']} frames, steady {row['steady_frames_per_s']} "
        f"frames/s, first epoch {row['first_epoch_s']} s")

    vwork = os.path.join(tmp, "parity")
    vargs = ["--epochs", "2", "--niter", "10", "--work", vwork, *base]
    _, text, counts, wall = counted(port, torch, validate_parity.main,
                                    vargs + ["--engine", "ours"])
    ours = [ln for ln in text.splitlines() if " OURS: " in ln]
    check(len(ours) == 3, f"validate_parity ours printed {ours}")
    whole_batches("validate_parity --engine ours", counts, "wh", 10)
    _, text, counts, pwall = counted(port, torch, validate_parity.main,
                                     vargs + ["--engine", "paired",
                                              "--seeds", "1"])
    paired = [ln for ln in text.splitlines() if ln.startswith("[paired]")]
    check(len(paired) == 3 and not nonzero(counts),
          f"validate_parity paired (eager engine): {paired}, launches "
          f"{nonzero(counts)}")
    for ln in ours + paired:
        log(f" (i) {ln}")
    log(f" (i) validate_parity --engine ours {wall:.1f} s, --engine paired "
        f"(the reference's recorded streams through mcem_run, its own half "
        f"skipped without the reference tree) {pwall:.1f} s")
    rec["validate_parity"] = {"ours_s": wall, "paired_s": pwall}
    return rec


def scripts_pesq_vpu(torch, dev, gpu):
    """(j) pesq_battery with the first-party engine against the committed
    expectations; (k) bench_vpu at its default --m and at VPU_M (HBM),
    every streamed share of the HBM peak at VPU_MAX_SHARE or under."""
    from guided_vae_nmf_torch.scripts import bench_vpu, pesq_battery

    rc, text = captured(pesq_battery.main, ["--engine", "first-party"])
    summary = json.loads(text.splitlines()[-1])
    check(rc == 0 and summary["pass"] and summary["n_cases"] == 18,
          f"pesq_battery: rc {rc}, {summary}")
    log(f" (j) pesq_battery --engine first-party: {summary}")
    rec = {"pesq_battery": summary}
    for m in (None, VPU_M):
        argv = ["--device", str(dev)] + ([] if m is None else
                                         ["--m", str(m), "--iters",
                                          str(VPU_ITERS)])
        out, _ = captured(bench_vpu.main, argv)
        if m is not None:
            check(max(out["hbm_share"].values()) <= VPU_MAX_SHARE,
                  f"bench_vpu shares {out['hbm_share']} past "
                  f"{VPU_MAX_SHARE}")
        log(f" (k) bench_vpu --m {out['m']} ({out['m'] * 4 / 2**20:.0f} MiB "
            f"a tensor; {gpu}): streamed Gelem/s {out['streamed_gelem_s']}, "
            f"share of 3.35 TB/s {out['hbm_share']}; chained (eager, "
            f"unfused) {out['fused_gelem_s']}")
        rec[f"bench_vpu_m{out['m']}"] = out
    return rec


def phase_scripts(torch, model, batch, dev, gpu, seed):
    """The remaining scripts, in-process through each `main(argv)` on the
    card with the shipped weights at full width, the launch counters read
    around each run: (a)-(k) above. Returns the record."""
    import guided_vae_nmf_torch as port

    t_phase = time.perf_counter()
    store_backend()
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        write_eval_root(batch[0], root)
        croot = os.path.join(tmp, "campaign_data")
        write_campaign_root(croot, seed, CAMPAIGN_SECONDS)
        for key, fn, args in (
                ("harness", scripts_harness, (model, root, dev)),
                ("long", scripts_long, (model, root, tmp, dev)),
                ("serving", scripts_serving, (dev,)),
                ("real_noise", scripts_real_noise, (root, tmp, dev)),
                ("warm_cache", scripts_warm_cache, (dev,)),
                ("campaign", scripts_campaign, (croot, tmp, dev))):
            t0 = time.perf_counter()
            rec[key] = fn(torch, port, *args)
            rec[key + "_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["pesq_vpu"] = scripts_pesq_vpu(torch, dev, gpu)
        rec["pesq_vpu_s"] = time.perf_counter() - t0
    rec["seconds"] = time.perf_counter() - t_phase
    log(f" remaining-scripts phase: {rec['seconds']:.1f} s in all ("
        + ", ".join(f"{k[:-2]} {v:.1f} s" for k, v in rec.items()
                    if k.endswith("_s")) + ")")
    return rec


# ---------------------------------------------------------------------------
# Multi-device: a mesh of the one card, and a virtual mesh of two shards
# ---------------------------------------------------------------------------

MD_LONG_SECONDS = 10.5     # the frame-sharded recording
MD_GRID_SECONDS = (4.0, 5.0)
MD_GRID_CFG = dict(niter=10)
MD_STREAMS = 3
MD_POOL_SECONDS = 1.0
MD_SWITCH_S = 1e-4         # the probe's interpreter switch interval
MD_TRAIN_SECONDS = (10.0,) * 16   # 10,016 frames (hop 256)
MD_TRAIN_FRAMES = 78 * 128        # the training phase's store: 78 batches
MD_TRAIN_EPOCHS = 3               # epochs 2-3 timed, as training_runs does
# a data-parallel epoch of the main batches' frames (14 steps) against the
# single-device one: the CPU test's tolerance (reading 1.64e-7, PR 12).
# Not held over the timed epochs: float sums' order flips the sign of
# Adam's near-zero gradients, and the weights drift apart (1.42e-3 after
# 234 steps)
MD_TRAIN_TOL = dict(loss_rtol=1e-6, weight_atol=1e-6)
VAR0_TOL = dict(rtol=2e-4, atol=1e-6)


@contextlib.contextmanager
def shards_in_one_thread():
    """`parallel.mesh.run_shards` with each shard run to its end in the
    caller's thread, one after another, as its thread would run it (its
    device, stream and launch counts): what the shard threads cost, for
    calls with no all-sum."""
    import threading
    import types

    from guided_vae_nmf_torch.parallel import mesh as mesh_mod

    class Inline:
        def __init__(self, target, args, **_):
            self.run = lambda: target(*args)

        def start(self):
            self.run()

        def join(self):
            pass

    mesh_mod.threading = types.SimpleNamespace(
        Thread=Inline, Barrier=threading.Barrier,
        BrokenBarrierError=threading.BrokenBarrierError)
    try:
        yield
    finally:
        mesh_mod.threading = threading


@contextlib.contextmanager
def switch_interval(seconds):
    """The interpreter's thread switch interval set to `seconds`."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def nonzero(counts):
    """The launched variants of `launch_counts()`-layout counts."""
    return {k: {v: n for v, n in d.items() if n}
            for k, d in counts.items() if any(d.values())}


def phase_multidevice(torch, mods, mean, std, meta, batch, seed, dev, gpu):
    """The multi-device layer on one card: (a) `enhance_files(mesh=
    make_mesh())`, a mesh of the one card, against the unsharded sweep,
    bit for bit; (b) the main batch through `enhance_waveform_sharded` on
    a virtual mesh of two shards on cuda:0 (each its own thread and
    stream): the fused engine's shards equal to their rows' unsharded
    runs with the same generators bit for bit, 100 / 1 / 100 / 100
    launches a shard, |s + n - x| <= 2 LSB; the eager engine's equal to
    the unsharded batch; what the threads cost (the shards one after
    another in one thread, and the threads at a shorter switch interval);
    (c) `frame_sharded_mcem` on one recording of
    MD_LONG_SECONDS at the virtual 2-mesh and `grid_sharded_mcem` at B=2 on
    a (2, 2) virtual mesh, both at var_RW=0 against single-device
    `mcem_run`; (d) `EnhancementService(mesh=)` and
    `MultiStreamM2Enhancer(mesh=)` on the virtual 2-mesh against their
    unsharded forms; (e) one data-parallel M2 epoch on the virtual 2-mesh
    against the single-device epoch, and steady epochs timed at the
    training phase's store size; (f) `multihost.initialize` at world
    size 1 with NCCL, an all-reduce and `shard_file_list`. Returns the
    record."""
    import socket

    import guided_vae_nmf_torch as port
    from guided_vae_nmf_torch.data import read_wav_int16, write_wav
    from guided_vae_nmf_torch.dsp import frame_count
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.parallel import make_mesh
    from guided_vae_nmf_torch.pipeline import (
        enhance_files, enhance_waveform, enhance_waveform_sharded,
        plan_batches)

    model, classifier = mods
    pairs, x_b, mask = batch
    audio_s = sum(len(x) for _, x in pairs) / 16000
    rec = {}
    main = nonzero(expected_launches(**MAIN_LAUNCHES))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) a mesh of the one card
    mesh1 = make_mesh()
    check(mesh1.shape == {"data": torch.cuda.device_count()},
          f"make_mesh() took {mesh1}")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        files = []
        for j, (_, x) in enumerate(pairs):
            write_wav(os.path.join(src, f"utt{j}_x.wav"), x, 16000)
            files.append(f"utt{j}.wav")
        kw = dict(classifier=classifier, mean=mean, std=std,
                  cfg=MCEMConfig(), seed=seed)
        outs, walls = {}, {}
        for tag in ("unsharded", "mesh1"):
            mesh1.reset_shard_launches()
            port.reset_launch_counts()
            _, walls[tag] = timed(lambda: enhance_files(
                files, src, os.path.join(tmp, tag), model,
                mesh=mesh1 if tag == "mesh1" else None,
                device=None if tag == "mesh1" else dev, **kw))
            outs[tag] = [read_wav_int16(os.path.join(
                tmp, tag, f"utt{j}_s_est.wav"))[0] for j in range(len(pairs))]
        counts = port.launch_counts()
        n_b = len(plan_batches(files, [frame_count(len(x)) for _, x in pairs],
                               n_dev=mesh1.shape["data"]))
        same = all(np.array_equal(a, b) for a, b in
                   zip(outs["unsharded"], outs["mesh1"]))
        log(f" (a) enhance_files(mesh=make_mesh()) {mesh1}: "
            f"{walls['mesh1']:.3f} s = {audio_s / walls['mesh1']:.2f}x "
            f"realtime (unsharded {walls['unsharded']:.3f} s); PCM equal to "
            f"the unsharded sweep: {same}; launches {nonzero(counts)} over "
            f"{n_b} batches; {gpu}")
        check(same, "enhance_files on a mesh of one card differs from the "
              "unsharded sweep")
        check(counts == expected_launches(n_batches=n_b, **MAIN_LAUNCHES),
              f"mesh-of-one sweep launches {counts}")
        rec["a"] = {"wall_s": walls["mesh1"], "unsharded_s":
                    walls["unsharded"], "x_realtime": audio_s /
                    walls["mesh1"], "equal": same, "batches": n_b}

    # (b) the main batch on a virtual mesh of two shards on cuda:0
    vmesh = make_mesh(devices=[dev, dev])
    seeds = [seed * 1000 + 7 * j + 1 for j in range(len(pairs))]
    common = dict(classifier=classifier, mean=mean, std=std,
                  label_mode="dnn", return_noise=True)
    vmesh.reset_shard_launches()
    port.reset_launch_counts()
    (s_sh, n_sh, _, _, ok_sh), wall_f = timed(lambda: enhance_waveform_sharded(
        vmesh, model, x_b, mask, MCEMConfig(), seeds=seeds, **common))
    shard_counts = vmesh.shard_launches
    total = port.launch_counts()
    s_sh, n_sh = s_sh.cpu().numpy(), n_sh.cpu().numpy()
    equal_rows, wall_halves = True, 0.0
    for lo in (0, 2):
        ref, w = timed(lambda: enhance_waveform(
            model, x_b[lo:lo + 2], mask[lo:lo + 2], MCEMConfig(),
            generator=torch.Generator(device=dev).manual_seed(seeds[lo]),
            seeds=seeds[lo:lo + 2], device=dev, **common))
        wall_halves += w
        equal_rows &= bool(np.array_equal(ref[0].cpu().numpy(),
                                          s_sh[lo:lo + 2]))
    worst = max(int(np.abs(s_sh[j][:len(x)].astype(np.int32)
                           + n_sh[j][:len(x)] - x).max())
                for j, (_, x) in enumerate(pairs))
    log(f" (b) main batch on a virtual 2-mesh {vmesh}, fused: {wall_f:.3f} "
        f"s = {sum(MAIN_SECONDS) / wall_f:.2f}x realtime (its two halves "
        f"one after another, unsharded: {wall_halves:.3f} s); shards equal to "
        f"their rows' unsharded runs: {equal_rows}; launches a shard "
        f"{shard_counts}; |s + n - x| max {worst} LSB; {gpu}")
    check(bool(ok_sh.cpu().all()), "non-finite sharded output")
    check(equal_rows, "a fused shard differs from its rows' unsharded run")
    check(shard_counts == [main, main],
          f"shard launches {shard_counts}, expected {main} each")
    check(total == expected_launches(n_batches=2, **MAIN_LAUNCHES),
          f"sharded batch launches {total}")
    check(worst <= 2, "sharded Wiener gains do not sum to one")
    eager = dict(common, engine="xla")
    port.reset_launch_counts()
    ref_e, wall_eu = timed(lambda: enhance_waveform(
        model, x_b, mask, MCEMConfig(), seeds=seeds, device=dev, **eager))
    sh_e, wall_e = timed(lambda: enhance_waveform_sharded(
        vmesh, model, x_b, mask, MCEMConfig(), seeds=seeds, **eager))
    diff = int(np.abs(ref_e[0].cpu().numpy().astype(np.int32)
                      - sh_e[0].cpu().numpy()).max())
    log(f" (b) eager engine (engine='xla'): sharded {wall_e:.3f} s, "
        f"unsharded {wall_eu:.3f} s; max |s16 diff| {diff} LSB (needs 0); "
        f"launches {nonzero(port.launch_counts())}")
    check(diff == 0, "the eager sharded batch differs from the unsharded")
    check_no_launches("the eager engine")
    # what the shard threads cost: the fused batch (median of three) and
    # the eager one with the shards one after another in the caller's
    # thread, and the fused batch with the threads at an interpreter
    # switch interval of MD_SWITCH_S (CPython's default 5 ms)
    def fused():
        return enhance_waveform_sharded(vmesh, model, x_b, mask,
                                        MCEMConfig(), seeds=seeds, **common)

    def eager_sh():
        return enhance_waveform_sharded(vmesh, model, x_b, mask,
                                        MCEMConfig(), seeds=seeds, **eager)

    probe = {}
    for tag, ctx in (("threads", contextlib.nullcontext),
                     ("one_thread", shards_in_one_thread),
                     ("switch", lambda: switch_interval(MD_SWITCH_S))):
        with ctx():
            runs = [timed(fused) for _ in range(3)]
            same = all(np.array_equal(out[0].cpu().numpy(), s_sh)
                       for out, _ in runs)
            e_wall = {"threads": wall_e, "switch": None}.get(tag)
            if tag == "one_thread":
                e_out, e_wall = timed(eager_sh)
                same &= bool(np.array_equal(e_out[0].cpu().numpy(),
                                            sh_e[0].cpu().numpy()))
        probe[tag] = {"fused_s": sorted(w for _, w in runs)[1],
                      "fused_runs_s": [w for _, w in runs],
                      "eager_s": e_wall, "same_pcm": same}
        check(same, f"the sharded batch changed under the probe's {tag}")
    port.reset_launch_counts()
    log(f" (b) what the shard threads cost, virtual 2-mesh, fused (median "
        f"of 3) / eager: threads {probe['threads']['fused_s']:.3f} / "
        f"{wall_e:.3f} s; shards one after another in one thread "
        f"{probe['one_thread']['fused_s']:.3f} / "
        f"{probe['one_thread']['eager_s']:.3f} s; threads at a "
        f"{MD_SWITCH_S * 1e3:g} ms switch interval, fused "
        f"{probe['switch']['fused_s']:.3f} s (unsharded: the halves "
        f"{wall_halves:.3f}, eager B=4 {wall_eu:.3f} s); PCM unchanged; "
        f"{gpu}")
    rec["b"] = {"fused_wall_s": wall_f, "halves_serial_s": wall_halves,
                "fused_x_realtime":
                sum(MAIN_SECONDS) / wall_f, "shard_launches": shard_counts,
                "rows_equal": equal_rows, "lsb": worst,
                "eager_wall_s": wall_e, "eager_unsharded_s": wall_eu,
                "eager_lsb": diff, "thread_probe": probe}

    # (c) frame- and grid-sharded MCEM at var_RW=0
    from guided_vae_nmf_torch.dsp import pad_signal_for_stft, \
        stft_batch_padded
    from guided_vae_nmf_torch.mcem.engine import mcem_run, pad_power
    from guided_vae_nmf_torch.parallel import (frame_sharded_mcem,
                                               grid_sharded_mcem)
    from guided_vae_nmf_torch.pipeline import make_labels

    def spectrum(x, n_pad):
        xp, nf = pad_signal_for_stft(x)
        X = stft_batch_padded(torch.tensor(xp[None], device=dev)
                              .float() / 32768.0)[0]
        P = (X.real**2 + X.imag**2)[:, :nf]
        yh = make_labels("dnn", P.cpu().numpy(), classifier=classifier,
                         mean=mean, std=std)[1]
        Pp, m = pad_power(P, n_pad)
        y = torch.zeros((yh.shape[0], n_pad), device=dev)
        y[:, :nf] = torch.tensor(yh, device=dev)
        return Pp, m, y, nf

    (_, long_x), = speech_like_mixtures(seed + 9, (MD_LONG_SECONDS,))
    nf_long = frame_count(len(long_x))
    Pp, m, y, _ = spectrum(long_x, -(-nf_long // 2) * 2)
    cfg0 = MCEMConfig(var_RW=0.0)
    out_f, wall_fs = timed(lambda: frame_sharded_mcem(
        vmesh, model, Pp, m, y, seed + 11, cfg0))
    ref_f, wall_f1 = timed(lambda: mcem_run(model, Pp[None], m[None],
                                            y[None], [seed + 11], cfg0))
    err_f = max(float(np.max(np.abs(out_f[k].cpu().numpy()
                                    - ref_f[k][0].cpu().numpy())
                             / (VAR0_TOL["atol"] + VAR0_TOL["rtol"]
                                * np.abs(ref_f[k][0].cpu().numpy()))))
                for k in ("WFs", "WFn", "g", "W", "H", "cost"))
    log(f" (c) frame_sharded_mcem, one {MD_LONG_SECONDS} s recording "
        f"({Pp.shape[1]} frames), virtual 2-mesh, MCEMConfig(var_RW=0): "
        f"{wall_fs:.3f} s = {MD_LONG_SECONDS / wall_fs:.2f}x realtime "
        f"(single-device mcem_run {wall_f1:.3f} s); worst element at "
        f"{err_f:.3f} of {VAR0_TOL}; {gpu}")
    check(err_f <= 1, "frame-sharded MCEM differs from single-device")
    check_no_launches("frame-sharded MCEM (the eager engine)")
    grid_pairs = speech_like_mixtures(seed + 12, MD_GRID_SECONDS)
    n_pad = -(-max(frame_count(len(x)) for _, x in grid_pairs) // 2) * 2
    specs = [spectrum(x, n_pad) for _, x in grid_pairs]
    Xg, mg, yg = (torch.stack([s[i] for s in specs]) for i in range(3))
    gmesh = make_mesh(devices=[dev] * 4, axis_names=("data", "frame"),
                      shape=(2, 2))
    cfg_g = MCEMConfig(var_RW=0.0, **MD_GRID_CFG)
    gseeds = [seed + 13, seed + 14]
    out_g, wall_g = timed(lambda: grid_sharded_mcem(
        gmesh, model, Xg, mg, yg, gseeds, cfg_g))
    err_g = 0.0
    for b in range(2):
        ref = mcem_run(model, Xg[b:b + 1], mg[b:b + 1], yg[b:b + 1],
                       [gseeds[b]], cfg_g)
        for k in ("WFs", "WFn", "g", "W", "H", "cost"):
            r = ref[k][0].cpu().numpy()
            err_g = max(err_g, float(np.max(np.abs(
                out_g[k][b].cpu().numpy() - r) / (
                VAR0_TOL["atol"] + VAR0_TOL["rtol"] * np.abs(r)))))
    log(f" (c) grid_sharded_mcem, B=2 of {MD_GRID_SECONDS} s on a (2, 2) "
        f"virtual mesh, {MD_GRID_CFG} at var_RW=0: {wall_g:.3f} s = "
        f"{sum(MD_GRID_SECONDS) / wall_g:.2f}x realtime; worst element at "
        f"{err_g:.3f} of {VAR0_TOL}; {gpu}")
    check(err_g <= 1, "grid-sharded MCEM differs from single-device")
    rec["c"] = {"frame_wall_s": wall_fs, "frame_single_s": wall_f1,
                "frame_frames": int(Pp.shape[1]),
                "frame_x_realtime": MD_LONG_SECONDS / wall_fs,
                "frame_err": err_f, "grid_wall_s": wall_g,
                "grid_err": err_g}

    # (d) the service and the stream pool on the virtual 2-mesh
    from guided_vae_nmf_torch.serving import EnhancementService, ServeConfig
    from guided_vae_nmf_torch.streaming import (MultiStreamM2Enhancer,
                                                StreamingM2Enhancer)

    reqs = [x.astype(np.float32) / 32768.0 for _, x in pairs]
    got = {}
    for tag, mesh in (("unsharded", None), ("mesh", vmesh)):
        with EnhancementService(model, classifier=classifier, mean=mean,
                                std=std, cfg=MCEMConfig(),
                                serve=ServeConfig(fast=True), mesh=mesh,
                                device=None if mesh else dev) as svc:
            port.reset_launch_counts()
            vmesh.reset_shard_launches()
            t0 = time.perf_counter()
            got[tag] = [svc.enhance(x)["s"] for x in reqs]
            got[tag + "_s"] = time.perf_counter() - t0
            got[tag + "_launches"] = nonzero(port.launch_counts())
    lsb = max(int(np.abs(pcm(a) - pcm(b)).max())
              for a, b in zip(got["unsharded"], got["mesh"]))
    log(f" (d) EnhancementService(ServeConfig(fast=True), mesh=virtual "
        f"2-mesh): {len(reqs)} requests one at a time in "
        f"{got['mesh_s']:.3f} s (unsharded {got['unsharded_s']:.3f} s); "
        f"max |diff| {lsb} LSB (needs <= 1); launches a shard "
        f"{vmesh.shard_launches}; {gpu}")
    check(lsb <= 1, "the sharded service differs from the unsharded")
    kw = stream_kwargs("real-noise", classifier, mean, std, meta)
    sxs = [x.astype(np.float32) / 32768.0 for _, x in speech_like_mixtures(
        seed + 15, (MD_POOL_SECONDS,) * MD_STREAMS)]
    pool = MultiStreamM2Enhancer(model, max_streams=4, mesh=vmesh, **kw)
    sids = [pool.open() for _ in sxs]
    outs = {s: [] for s in sids}
    piece = 2048
    port.reset_launch_counts()
    t0 = time.perf_counter()
    for lo in range(0, max(len(x) for x in sxs), piece):
        for s, x in zip(sids, sxs):
            if lo < len(x):
                pool.feed(s, x[lo:lo + piece])
        for s, o in pool.step().items():
            outs[s].append(o)
    for s in sids:
        outs[s].append(pool.flush(s))
    wall_p = time.perf_counter() - t0
    check_no_launches("the sharded stream pool")
    perr = 0.0
    for s, x in zip(sids, sxs):
        enh = StreamingM2Enhancer(model, device=dev, **kw)
        ref = np.concatenate([enh.push(x[lo:lo + piece])
                              for lo in range(0, len(x), piece)]
                             + [enh.flush()])
        o = np.concatenate(outs[s])
        check(len(o) == len(x), "pool lane length")
        perr = max(perr, float(np.max(np.abs(o - ref) / (
            POOL_TOL["atol"] + POOL_TOL["rtol"] * np.abs(ref)))))
    log(f" (d) MultiStreamM2Enhancer(max_streams=4, mesh=virtual 2-mesh), "
        f"{MD_STREAMS} streams of {MD_POOL_SECONDS} s, full-lane ticks: "
        f"{wall_p:.3f} s = {MD_STREAMS * MD_POOL_SECONDS / wall_p:.2f} "
        f"audio s per wall s; lanes against dedicated streams at "
        f"{perr:.3f} of {POOL_TOL}; {gpu}")
    check(perr <= 1, "a sharded pool lane differs from its dedicated stream")
    rec["d"] = {"service_lsb": lsb, "service_s": got["mesh_s"],
                "service_unsharded_s": got["unsharded_s"],
                "pool_wall_s": wall_p, "pool_err": perr}

    # (e) a data-parallel M2 epoch against the single-device one, then
    # steady epochs timed at the training phase's store size
    from guided_vae_nmf_torch.train import TrainConfig, train_m2

    def frames_of(pairs_):
        frames, labs = [], []
        for _, x in pairs_:
            P, _, yv, nf = spectrum(x, frame_count(len(x)))
            frames.append(P[:, :nf].T.cpu().numpy())
            labs.append(yv[:, :nf].T.cpu().numpy())
        X = np.concatenate(frames)
        X = (X / X.mean(axis=0, keepdims=True)).astype(np.float32)
        return X, np.concatenate(labs).astype(np.float32)

    def fits(X, Y, epochs, tags, tmp):
        out = {}
        for tag in tags:
            mesh = {"single": None, "mesh1": make_mesh(devices=[dev]),
                    "virtual2": vmesh}[tag]
            m, hist = train_m2(
                (X, Y), (X[:256], Y[:256]),
                cfg=TrainConfig(end_epoch=epochs),
                model_dir=os.path.join(tmp, f"{tag}{epochs}"), mesh=mesh,
                device=None if mesh else dev)
            out[tag] = ({k: v.detach().cpu() for k, v in
                         m.state_dict().items()}, hist)
        return out

    X, Y = frames_of(main_batch(seed + 16)[0] + pairs)
    Xs, Ys = frames_of(speech_like_mixtures(seed + 16, MD_TRAIN_SECONDS))
    check(len(Xs) >= MD_TRAIN_FRAMES, f"{len(Xs)} training frames")
    Xs, Ys = Xs[:MD_TRAIN_FRAMES], Ys[:MD_TRAIN_FRAMES]
    with tempfile.TemporaryDirectory() as tmp:
        # the mesh of one first: it also warms the single-device fit
        timed_runs = fits(Xs, Ys, MD_TRAIN_EPOCHS,
                          ("mesh1", "single", "virtual2"), tmp)
        short = fits(X, Y, 1, ("single", "virtual2"), tmp)
    (w1, h1), (w2, h2) = short["single"], short["virtual2"]
    loss_rel = max(abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(h1, h2)
                   for k in ("train", "valid"))
    w_abs = max(float((w1[k] - w2[k]).abs().max()) for k in w1)
    nb = len(X) // 128
    log(f" (e) data-parallel M2 epoch ({len(X)} frames, {nb} steps of 128, "
        f"full width), virtual 2-mesh against one device: losses "
        f"{loss_rel:.2e} apart (rel), weights {w_abs:.2e} (abs); "
        f"tolerance {MD_TRAIN_TOL}")
    check(loss_rel <= MD_TRAIN_TOL["loss_rtol"]
          and w_abs <= MD_TRAIN_TOL["weight_atol"],
          "the data-parallel epoch differs from the single-device one")
    (ws, hs), (wm, _), (wv, hv) = (timed_runs[k] for k in (
        "single", "mesh1", "virtual2"))
    exact = all(torch.equal(ws[k], wm[k]) for k in ws)
    t1, t2 = (float(np.mean([h["time_s"] for h in hist[1:]]))
              for hist in (hs, hv))
    drift = max(float((ws[k] - wv[k]).abs().max()) for k in ws)
    log(f" (e) data-parallel M2, {MD_TRAIN_EPOCHS} epochs of "
        f"{MD_TRAIN_FRAMES} frames ({MD_TRAIN_FRAMES // 128} steps of 128), "
        f"steady epochs 2-{MD_TRAIN_EPOCHS}: virtual 2-mesh {t2:.4f} s "
        f"({MD_TRAIN_FRAMES / t2:.0f} training frames/s), single device "
        f"{t1:.4f} s ({MD_TRAIN_FRAMES / t1:.0f}); mesh of one equal bit "
        f"for bit: {exact}; virtual 2-mesh weights {drift:.2e} from the "
        f"single device's (abs, not held); {gpu}")
    check(exact, "data-parallel epochs on a mesh of one differ")
    check(all(np.isfinite(h[k]) for h in hv for k in ("train", "valid")),
          "non-finite data-parallel losses")
    rec["e"] = {"frames": len(X), "loss_rel": loss_rel, "weight_abs": w_abs,
                "timed_frames": MD_TRAIN_FRAMES, "epochs": MD_TRAIN_EPOCHS,
                "steady_epoch_s": t2, "single_steady_epoch_s": t1,
                "frames_per_s": MD_TRAIN_FRAMES / t2,
                "single_frames_per_s": MD_TRAIN_FRAMES / t1,
                "mesh1_exact": exact, "timed_weight_drift": drift}

    # (f) the multi-process runtime at world size 1 with NCCL
    import torch.distributed as dist

    from guided_vae_nmf_torch.parallel import multihost, shard_file_list

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port_no}", num_processes=1,
                         process_id=0, timeout_s=60)
    try:
        backend = dist.get_backend()
        total = multihost.DistGroup().all_sum(
            torch.tensor([1.0, 2.0], device=dev))
        files = [f"u{i}" for i in range(5)]
        shard = [str(f) for f in shard_file_list(files)]
        ok = (backend == "nccl" and multihost.process_count() == 1
              and total.tolist() == [1.0, 2.0] and shard == files)
    finally:
        multihost.shutdown()
    wall_m = time.perf_counter() - t0
    log(f" (f) multihost.initialize at world size 1: backend {backend}, "
        f"all_reduce {total.tolist()}, shard_file_list at rank 0 of 1 "
        f"{shard}; {wall_m:.3f} s")
    check(ok, "the multi-process runtime at world size 1 failed")
    rec["f"] = {"backend": backend, "wall_s": wall_m}
    return rec


SOURCES = {
    "mh_chain": ("guided_vae_nmf_torch/csrc/mh_chain.cu",
                 "guided_vae_nmf_tpu/mcem/pallas_engine.py:494"),
    "nmf_sums": ("guided_vae_nmf_torch/csrc/nmf_sums.cu",
                 "guided_vae_nmf_tpu/mcem/pallas_engine.py:651"),
}


def l2_flush(torch):
    """A buffer whose zeroing writes 4x the card's 50 MB L2."""
    return torch.empty(50 * 2**20, device="cuda")


def time_sums(torch, c, vb, level, cfg, gpu):
    """K2 in both modes for one form and level on the inputs `c`, over the
    samples of one K1 E launch: device ms a launch (`graph_ms`) with the
    L2 as the main path leaves it (`ms`: right after the K1 E launch that
    wrote the samples), warm (the same buffer) and cold (after a write of
    4x the L2); beside them the CUDA-event time of `time_cuda`, the
    wrapper's host microseconds a call, the bound and the plain version's
    time. Returns rows by variant."""
    from guided_vae_nmf_torch.mcem import mh_chain, nmf_sums, nmf_sums_ref

    form = "vb" if vb else "wh"
    B, N, F = c["X2"].shape
    K, R = c["WH"][0].shape[1], cfg.nsamples_E_step
    kw = fast_kw(torch, level)

    def chain():
        return run_chain(c, mh_chain, "e", R, cfg.burnin_E_step, cfg.var_RW,
                         vb=vb, seed=2, **kw)[2][0]

    samples = chain()
    flush = l2_flush(torch)

    def cold():
        flush.zero_()
        return samples

    sums_kw = dict(approx_recip=True) if level else {}
    rows = {}
    for mode in ("h", "g"):
        def run(s):
            return run_sums(c, nmf_sums, s, mode, vb, **sums_kw)

        key = f"nmf_sums_{mode}_{form}{level}"
        bound, by, flops, nbytes = sums_bound(
            B, R, N, F, K, mode, vb=vb, sample_bytes=samples.element_size())
        rows[key] = dict(
            ms=graph_ms(torch, run, chain),
            warm_ms=graph_ms(torch, run, lambda: samples),
            cold_ms=graph_ms(torch, run, cold),
            event_ms=time_cuda(lambda: run(samples)),
            host_us=host_us(torch, lambda: run(samples)),
            plain_ms=time_cuda(lambda: run_sums(
                c, nmf_sums_ref, samples, mode, vb)),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)
        v = rows[key]
        log(f"  {key:<27s} B={B} N={N}: device {v['ms']:.4f} ms after K1 "
            f"(warm {v['warm_ms']:.4f}, cold {v['cold_ms']:.4f}), events "
            f"{v['event_ms']:.4f} ms, host {v['host_us']:.1f} us a call; "
            f"bound {bound:.4f} ms = {100 * bound / v['ms']:.1f}% after K1, "
            f"{100 * bound / v['cold_ms']:.1f}% cold; {gpu}")
    return rows


def phase_times(torch, model, cfg, B, N, dev, gpu, err, launches, k1d_past):
    """Per-launch times of every kernel variant (exact, K1c / K2c fast and
    trans levels, K1d) at the paths' shapes, beside bounds and the plain
    versions' times; returns the `kernels` entries. `launches` holds each
    variant's count on its path, `k1d_past` K1d's elements past TOL."""
    from guided_vae_nmf_torch.mcem import mh_chain, mh_chain_ref

    K = cfg.nmf_rank
    R = cfg.nsamples_E_step
    from guided_vae_nmf_torch.mcem.mh_chain import bf16_weights, pack_weights

    c = chain_inputs(torch, model, B, N, K, 7, dev)
    L, F, Hd = c["L"], c["X2"].shape[-1], c["ypre"].shape[-1]
    # the weights as mcem_batch_fused hands them to the kernel: packed
    # into the cluster's blocks once, rounded first for K1d
    packed = {"": pack_weights(c["dec_w"]),
              "mm16": pack_weights(bf16_weights(c["dec_w"]))}
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    log(f"  K1d bound at {sms} SMs, {clock / 1e6:.0f} MHz maximum SM clock")
    floor = graph_floor_ms(torch)
    log(f"  K2 device times hold the graph's step from its first event to "
        f"the kernel: {floor:.4f} ms between the two events with no kernel; "
        f"{gpu}")
    timed = {}
    for vb, form in ((False, "wh"), (True, "vb")):
        for level in ("", "_fast", "_trans", "_fast_mm16"):
            kw = fast_kw(torch, level)
            for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                                 ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
                extra = {}
                if level == "_fast_mm16":
                    bound, by, terms, binding, flops, nbytes = \
                        chain_bound_mm16(B, N, F, L, Hd, K, ns, ns + bi,
                                         mode, vb, sms, clock)
                    key = f"mh_chain_{mode}_{form}{level}"
                    extra = dict(bound_terms_ms=terms, binding=binding,
                                 past_tol=k1d_past[key][0],
                                 compared=k1d_past[key][1])
                else:
                    bound, by, flops, nbytes = chain_bound(
                        B, N, F, L, Hd, K, ns, ns + bi, mode, vb=vb,
                        sample_bytes=2 if level else 4)
                ck = dict(c, dec_w=packed[
                    "mm16" if level.endswith("_mm16") else ""])
                timed[f"mh_chain_{mode}_{form}{level}"] = dict(
                    ms=time_cuda(lambda: run_chain(
                        ck, mh_chain, mode, ns, bi, cfg.var_RW, vb=vb,
                        seed=1, **kw)),
                    plain_ms=time_cuda(lambda: run_chain(
                        c, mh_chain_ref, mode, ns, bi, cfg.var_RW, vb=vb,
                        generator=gen, **kw), launches=2, reps=3),
                    bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                    **extra)
        for level in ("", "_fast"):
            timed.update(time_sums(torch, c, vb, level, cfg, gpu))
    kernels = []
    for key in VARIANTS:
        v = timed[key]
        kern = key[:8]                           # mh_chain / nmf_sums
        by = v.get("binding", v["bound_by"])
        log(f"  {key:<27s}: {v['ms']:.4f} ms (plain {v['plain_ms']:.3f} "
            f"ms), bound {v['bound_ms']:.4f} ms by {by} "
            f"({v['flops'] / 1e9:.3f} GFLOP, {v['bytes'] / 1e6:.2f} MB) = "
            f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound; {gpu}")
        if "bound_terms_ms" in v:
            log("    K1d bound terms: " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in v["bound_terms_ms"].items())
                + f"; {v['past_tol']} of {v['compared']} elements past TOL "
                "against the plain version")
        source, replaces = SOURCES[kern]
        detail = dict(B=B, N=N, F=F, L=L, H=Hd, K=K, R=R, flops=v["flops"],
                      bytes=v["bytes"])
        detail.update({k: v[k] for k in (
            "bound_terms_ms", "binding", "past_tol", "compared", "warm_ms",
            "cold_ms", "event_ms", "host_us") if k in v})
        if kern == "nmf_sums":
            detail["graph_floor_ms"] = floor
        kernels.append(dict(
            name=key, route="cuda", source=source, replaces=replaces,
            launches=launches[kern][key[9:]],
            max_abs_err=err[key], ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"], library_ms=None,
            detail=detail))
    return kernels


# K1 at bench.py's shapes, beside the paths' B=4, N=384.
LARGE_SHAPE = (32, 512)


def phase_geometry(torch, dev):
    """K1's launch at the shipped decoder's widths (F=513, L=32, H=128,
    K=10, depth 2): cluster size, threads, shared memory and registers a
    CTA, resident clusters, and the clusters, CTAs and waves of a launch
    at B=4, N=384 and at LARGE_SHAPE."""
    from guided_vae_nmf_torch.mcem.mh_chain import launch_geometry

    geo = launch_geometry(513, 32, 128, 10, 2, dev)
    check(geo["max_active_clusters"] > 0, "K1's cluster launch cannot run")
    per = {}
    for B, N in ((4, 384), LARGE_SHAPE):
        clusters = B * -(-(N // geo["frames"]) // 2)
        per[f"B={B},N={N}"] = dict(
            clusters=clusters, ctas=clusters * geo["cluster"],
            waves=-(-clusters // geo["max_active_clusters"]))
    log(f"  K1 launch: clusters of {geo['cluster']} CTAs, 32 frames (two "
        f"16-frame tiles) a cluster, {geo['threads']} threads, "
        f"{geo['smem_bytes']} B of shared memory and {geo['registers']} "
        f"registers a thread, {geo['max_active_clusters']} clusters "
        f"resident; " + "; ".join(
            f"{k}: {v['clusters']} clusters, {v['ctas']} CTAs, "
            f"{v['waves']} waves" for k, v in per.items()))
    return dict(geo, launches=per)


def phase_sums_geometry(torch, dev, R=10, F=513, K=10):
    """K2's launch at R=10, F=513, K=10 in each mode and form over float32
    samples: CTAs, threads, shared memory and registers a CTA, ring stages,
    frames a tile, CTAs an SM, and the SMs a launch occupies at B=4, N=384
    and at LARGE_SHAPE."""
    from guided_vae_nmf_torch.mcem.nmf_sums import launch_geometry

    out = {}
    for B, N in ((4, 384), LARGE_SHAPE):
        for mode, vb in (("h", False), ("g", False), ("h", True),
                         ("g", True)):
            geo = launch_geometry(B, R, N, F, K, mode, vb, device=dev)
            key = f"{mode}_{'vb' if vb else 'wh'} B={B},N={N}"
            out[key] = geo
            log(f"  K2 launch {key}: {geo['ctas']} CTAs of "
                f"{geo['threads']} threads on {min(geo['ctas'], geo['sms'])}"
                f" of {geo['sms']} SMs ({geo['ctas_per_sm']} an SM), "
                f"{geo['smem_bytes']} B of shared memory, {geo['stages']} "
                f"stages, {geo['frames']} frames a tile, "
                f"{geo['segments']} segments a frame, {geo['registers']} "
                "registers a thread")
            check(geo["ctas"] >= geo["sms"], "K2 leaves SMs idle")
    return out


def phase_times_large(torch, model, cfg, dev, gpu):
    """K1a and K1b, E and WF, exact, at LARGE_SHAPE (bench.py's B and N)
    beside their bounds (no plain version: it takes seconds there)."""
    from guided_vae_nmf_torch.mcem import mh_chain
    from guided_vae_nmf_torch.mcem.mh_chain import pack_weights

    B, N = LARGE_SHAPE
    K, R = cfg.nmf_rank, cfg.nsamples_E_step
    c = chain_inputs(torch, model, B, N, K, 8, dev)
    c["dec_w"] = pack_weights(c["dec_w"])
    L, F, Hd = c["L"], c["X2"].shape[-1], c["ypre"].shape[-1]
    rows = {}
    for vb, form in ((False, "wh"), (True, "vb")):
        for mode, ns, bi in (("e", R, cfg.burnin_E_step),
                             ("wf", cfg.nsamples_WF, cfg.burnin_WF)):
            bound, by, flops, nbytes = chain_bound(
                B, N, F, L, Hd, K, ns, ns + bi, mode, vb=vb)
            ms = time_cuda(lambda: run_chain(c, mh_chain, mode, ns, bi,
                                             cfg.var_RW, vb=vb, seed=1),
                           launches=5, reps=3)
            key = f"mh_chain_{mode}_{form}"
            rows[key] = dict(B=B, N=N, ms=ms, bound_ms=bound, bound_by=by,
                             flops=flops, bytes=nbytes)
            log(f"  {key:<27s}: {ms:.4f} ms at B={B}, N={N}, bound "
                f"{bound:.4f} ms by {by} = {100 * bound / ms:.1f}% of "
                f"bound; {gpu}")
    rows.update(times_large_sums(torch, c, cfg, dev, gpu))
    return rows


def times_large_sums(torch, c, cfg, dev, gpu):
    """K2a and K2b, 'h' and 'g', exact, on the inputs `c` (LARGE_SHAPE)
    over seeded uniform samples (the buffer is several times the L2):
    checked against the plain version, then device ms a launch cold (after
    a write of 4x the L2) and warm, beside the byte bound."""
    from guided_vae_nmf_torch.mcem import nmf_sums

    B, N, F = c["X2"].shape
    K, R = c["WH"][0].shape[1], cfg.nsamples_E_step
    gen = torch.Generator(device=dev).manual_seed(9)
    samples = torch.empty((B, R, N, F), device=dev).uniform_(
        0.01, 2.0, generator=gen)
    flush = l2_flush(torch)

    def cold():
        flush.zero_()
        return samples

    rows = {}
    for vb, form in ((False, "wh"), (True, "vb")):
        err = check_sums(torch, c, vb, dev, samples=samples)
        for mode in ("h", "g"):
            def run(s):
                return run_sums(c, nmf_sums, s, mode, vb)

            key = f"nmf_sums_{mode}_{form}"
            bound, by, flops, nbytes = sums_bound(B, R, N, F, K, mode, vb=vb)
            cold_ms = graph_ms(torch, run, cold, launches=5)
            warm_ms = graph_ms(torch, run, lambda: samples, launches=5)
            rows[key] = dict(B=B, N=N, cold_ms=cold_ms, warm_ms=warm_ms,
                             max_abs_err=err[key], bound_ms=bound,
                             bound_by=by, flops=flops, bytes=nbytes)
            log(f"  {key:<27s}: device {cold_ms:.4f} ms cold (warm "
                f"{warm_ms:.4f}) at B={B}, N={N}, bound {bound:.4f} ms by "
                f"{by} = {100 * bound / cold_ms:.1f}% of bound cold; {gpu}")
    return rows


def ptxas_report(log_text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    `-Xptxas -v` build log."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "chip_smoke.json"),
                    help="where the full JSON record goes")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "guided_vae_nmf_torch")):
        print("chip_smoke: the guided_vae_nmf_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.train import (
        load_classifier_meta, load_model, load_norm_stats)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_name_and_limit()
    log(f"device: {gpu} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    build_s = _build.build_all()
    log(f"build: csrc/*.cu for sm_90a in {build_s:.1f} s")
    ptxas = {}
    for lib in ("mh_chain", "nmf_sums"):
        for kern, (regs, st, ld) in ptxas_report(_build.build_log(lib)).items():
            ptxas[kern] = dict(registers=regs, spill_stores=st, spill_loads=ld)
            log(f"  ptxas {lib}: {regs} registers, {st} B spill stores, "
                f"{ld} B spill loads: {kern[:90]}")
    if ptxas:
        log(f"  {len(ptxas)} kernels, largest {max(v['registers'] for v in ptxas.values())} "
            f"registers, spills in "
            f"{sum(1 for v in ptxas.values() if v['spill_stores'] or v['spill_loads'])}")

    geometry = phase_geometry(torch, dev)
    sums_geometry = phase_sums_geometry(torch, dev)

    art = os.path.join(root, "artifacts", "pretrained")
    model = load_model(os.path.join(art, "M2_ibm"), kind="dgm", y_dim=513,
                       device=dev)
    cdir = os.path.join(art, "classifier_ibm")
    classifier = load_model(cdir, kind="classifier", device=dev)
    mean, std = load_norm_stats(cdir)
    meta = load_classifier_meta(cdir)
    check(meta == {"features": "power", "threshold": 0.5},
          f"unexpected classifier protocol {meta}")

    batch = main_batch(args.seed)
    pairs, x_b, mask = batch
    log("native host loader (csrc/gvnmf_native.cpp, g++):")
    native = phase_native(pairs, gpu)
    log("kernels vs plain versions (full width, M2-IBM decoder):")
    err, k1d_past = phase_kernels(torch, model, dev, [(2, 256), mask.shape])
    log("main path (enhance_waveform, label_mode='dnn', MCEMConfig()):")
    cfg = MCEMConfig()
    main_res = phase_main(torch, model, classifier, mean, std, cfg, batch,
                          args.seed, dev, gpu)
    phase_files(torch, model, classifier, mean, std, pairs, cfg, args.seed,
                dev, MAIN_LAUNCHES, stages=True, gpu=gpu)
    phase_reference(torch, model, classifier, mean, std, pairs, dev)
    prof = phase_profile(torch, model, classifier, mean, std, x_b, mask, cfg,
                         dev, gpu)
    log("reference .pt import (load_model on .pt state dicts):")
    pt = phase_pt(torch, (model, classifier), mean, std, cfg, batch,
                  args.seed, dev, main_res)
    log("profiling hooks (ops.device_time_ms, ops.profile_trace):")
    profiling = phase_profiling(torch, (model, classifier), mean, std, x_b,
                                mask, cfg, dev, gpu, prof)

    log("fixed-noise path, real-noise profile (spp2, noise gain, soft "
        "guidance):")
    from guided_vae_nmf_torch.profiles import (
        apply_profile_cfg, offline_settings)

    paths = {}
    real_files_s = phase_files(torch, model, classifier, mean, std, pairs,
                               cfg, args.seed, dev, REAL_NOISE_LAUNCHES,
                               profile="real-noise")
    for name, launches, bursts in (("real-noise", REAL_NOISE_LAUNCHES, 0),
                                   ("impulse-noise", IMPULSE_LAUNCHES, 3)):
        noise_model, soft = offline_settings(name)
        settings = dict(noise_model=noise_model, soft_guidance=soft)
        pcfg = apply_profile_cfg(cfg, name)
        pbatch = main_batch(args.seed + 1, bursts) if bursts else batch
        log(f"{name} path (enhance_waveform, label_mode='dnn', "
            f"{settings}, noise_gain_bands={pcfg.noise_gain_bands}, "
            f"{bursts} noise bursts of 20 ms an utterance):")
        paths[name] = phase_main(torch, model, classifier, mean, std, pcfg,
                                 pbatch, args.seed, dev, gpu,
                                 launches=launches, label=f"{name} path",
                                 **settings)
        if name == "real-noise":
            paths[name]["enhance_files_s"] = real_files_s
            paths[name]["profile"] = phase_profile(
                torch, model, classifier, mean, std, x_b, mask, pcfg, dev,
                gpu, label="real-noise path", **settings)

    fast = phase_fast(torch, model, classifier, mean, std, cfg, batch,
                      args.seed, dev, gpu, main_res)

    rest = {}
    log("oracle path (enhance_waveform, label_mode='oracle', clean tracks "
        "as s_pad):")
    rest["oracle"] = phase_oracle(torch, model, mean, std, cfg, batch,
                                  args.seed, dev, gpu)
    log("Wiener-DNN baseline (enhance_files_wiener, shipped wiener "
        "checkpoint):")
    rest["wiener"] = phase_wiener(torch, batch, dev, gpu, art)
    log("enhance_batch (host spectrograms, dnn labels from make_labels):")
    rest["enhance_batch"] = phase_enhance_batch(
        torch, model, classifier, mean, std, cfg, batch, args.seed, dev, gpu)
    log("eager engine (enhance_waveform, engine='xla', MCEMConfig()):")
    rest["eager"] = phase_eager(torch, model, classifier, mean, std, cfg,
                                batch, args.seed, dev, gpu)
    log(f"eager engine on the card against the CPU (1 s, {EAGER_REF_CFG}, "
        "injected streams):")
    rest["eager"]["card_vs_cpu"] = phase_eager_reference(torch, model,
                                                         pairs, dev)
    log("serving on the eager engine (ServeConfig(engine='xla')):")
    rest["eager_serving"] = phase_eager_serving(
        torch, model, classifier, mean, std, cfg, args.seed, dev, gpu)
    log("serving (EnhancementService, ServeConfig(fast=True), spp noise "
        "model, dnn labels):")
    svc, serving = phase_serving(torch, model, classifier, mean, std, cfg,
                                 args.seed, dev, gpu)
    log("HTTP front end (EnhancementHTTPServer on port 0):")
    serving["http"] = phase_http(svc, pairs[0])
    log("streaming (the Wiener, SPP and M2 stream enhancers, the pool, its "
        "driver, the HTTP stream route; shipped weights):")
    streaming = phase_streaming(torch, (model, classifier), mean, std, meta,
                                dev, gpu, art, args.seed)
    log("evaluation protocol (gvnmf-torch enhance / metrics / stream / "
        "doctor, evaluate_M2_ibm, run_metrics_M2, run_metrics_mixture):")
    evaluation = phase_evaluation(torch, (model, classifier), mean, std,
                                  meta, batch, dev, gpu, art, args.seed)
    log("training (gvnmf-torch dataset / train at the shipped widths, one "
        "profiled M2 epoch, the card against the CPU, a resumed M2 run "
        "driving the main path):")
    training = phase_training(torch, classifier, mean, std, batch, dev, gpu,
                              args.seed)
    log("multi-device (parallel/: a mesh of the card, a virtual 2-mesh on "
        "cuda:0; sharded sweeps, frame- and grid-sharded MCEM, the service, "
        "the pool, a data-parallel epoch, the multi-process runtime):")
    t_md = time.perf_counter()
    multidevice = phase_multidevice(torch, (model, classifier), mean, std,
                                    meta, batch, args.seed, dev, gpu)
    multidevice["seconds"] = time.perf_counter() - t_md
    log(f" multi-device phase: {multidevice['seconds']:.1f} s")
    log("the remaining scripts (bench_niter500 + quality gate, bench_long, "
        "bench_serving, eval_real_noise, warm_cache, eval_campaign, "
        "campaign_tables, eval_classifier_context, pretrain_subset, "
        "bench_train, validate_parity, pesq_battery, bench_vpu):")
    scripts = phase_scripts(torch, model, batch, dev, gpu, args.seed)
    # the kernels' errors at the scripts' shapes join the kernel line's
    for run in ("harness", "long"):
        for key, (e, past, n) in scripts[run]["vs_plain"].items():
            err[key] = max(err[key], e)
            if key in k1d_past:
                k1d_past[key][0] += past
                k1d_past[key][1] += n

    hybrid = phase_hybrid(torch, model, classifier, mean, std, batch,
                          args.seed, dev, gpu)
    log("hybrid on the card against the CPU path:")
    hybrid["card_vs_cpu_lsb"] = phase_hybrid_reference(
        torch, model, classifier, mean, std, pairs, dev)
    log(f"paper-config harness (bench_niter500, {HARNESS_ARGS}):")
    harness = phase_harness(torch, dev)

    log("kernel times at the paths' shapes:")
    # each variant's launches on the first path that runs it
    runs = [main_res, paths["real-noise"], *fast.values(), serving,
            *(r for r in hybrid.values() if isinstance(r, dict)), harness]
    launches = {k: {v: next((r["launches"][k][v] for r in runs
                             if r["launches"][k][v]), 0)
                    for v in main_res["launches"][k]}
                for k in main_res["launches"]}
    idle = [v for v in VARIANTS
            if v not in OFF_PATH and not launches[v[:8]][v[9:]]]
    check(not idle, f"variants no path launched: {idle}")
    kernels = phase_times(torch, model, cfg, *mask.shape, dev, gpu, err,
                          launches, k1d_past)
    large = phase_times_large(torch, model, cfg, dev, gpu)

    for r in (main_res, *paths.values(), *fast.values(), rest["oracle"],
              rest["eager"],
              *(r for r in hybrid.values() if isinstance(r, dict))):
        r.pop("s16")
        r.pop("y_hard")
    record = {
        "gpu": gpu, "torch": torch.__version__, "build_s": build_s,
        "ptxas": ptxas, "k1_geometry": geometry,
        "k2_geometry": sums_geometry, "native_loader": native,
        "main_path": main_res, "profile": prof, "pt_import": pt,
        "profiling": profiling,
        "paths": paths, "fast": fast, "offline_rest": rest,
        "serving": serving, "streaming": streaming,
        "evaluation": evaluation, "training": training,
        "multidevice": multidevice, "scripts": scripts, "hybrid": hybrid,
        "harness": harness, "kernels": kernels, "kernels_b32_n512": large,
        "seconds": time.perf_counter() - t_start,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {record['seconds']:.1f} s; record in {args.out}")
    print(gpu)
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k != "detail"}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
