"""gvnmf-torch: the port's console entry point.

Counterpart of `guided_vae_nmf_tpu/cli.py` (the `gvnmf` command), with the
same subcommands, flags, choices and defaults, over the port's library:

    gvnmf-torch enhance  in.wav out.wav --model DIR [--classifier DIR] ...
    gvnmf-torch stream   in.wav out.wav --model DIR ...  # online, chunked
    gvnmf-torch metrics  --clean s.wav --enhanced sh.wav [--mixture x.wav]
    gvnmf-torch serve    --models DIR [--port 8571] ...  # HTTP front end
    gvnmf-torch doctor                                   # bounded check
    gvnmf-torch version

also run as `python -m guided_vae_nmf_torch.cli`. `enhance`, `stream` and
`serve` run on the GPU unless `--device` names another device (`--device
cpu` runs the kernels' plain versions); without a GPU they raise. `dataset`
and `train` take the JAX command's flags and exit nonzero: training comes
with ROADMAP Queue 1, item 4.
"""

import argparse
import os
import sys


def _device(a):
    from ._device import resolve_device

    return resolve_device(a.device)


# ---------------------------------------------------------------------------
# enhance (offline wav -> wav)
# ---------------------------------------------------------------------------

def _build_cfg(a):
    from .mcem import HybridConfig, MCEMConfig, PEEMConfig

    if a.algorithm == "hybrid":
        cfg = HybridConfig(niter=a.niter, refine=a.refine)
    elif a.algorithm == "peem":
        cfg = PEEMConfig(niter=a.niter, noise_gain=a.noise_gain,
                         noise_gain_bands=a.noise_gain_bands)
    else:
        cfg = MCEMConfig(niter=a.niter, noise_gain=a.noise_gain,
                         noise_gain_bands=a.noise_gain_bands)
    return cfg


def _load_guidance(a, device):
    """(classifier, mean, std, meta) for --label dnn, else Nones and the
    reference-protocol meta defaults. `meta` is the model dir's
    classifier_meta.json (input features and calibrated threshold), so the
    classifier always runs under its training protocol."""
    from .train import load_classifier_meta, load_model, load_norm_stats
    from .train.checkpoints import CLASSIFIER_META_DEFAULTS

    if a.label == "oracle" and not getattr(a, "s_ref", None):
        raise SystemExit("--s_ref <clean wav> is required with "
                         "--label oracle")
    if a.label != "dnn":
        return None, None, None, dict(CLASSIFIER_META_DEFAULTS)
    if not a.classifier:
        raise SystemExit("--classifier <ckpt-or-dir> is required with "
                         "--label dnn")
    cls = load_model(a.classifier, kind="classifier", device=device)
    cdir = (a.classifier if os.path.isdir(a.classifier)
            else os.path.dirname(a.classifier))
    mean, std = load_norm_stats(cdir)
    return cls, mean, std, load_classifier_meta(cdir)


def _read_wav_16k(path):
    """Read a wav for enhancement: first channel, resampled to 16 kHz when
    needed (data.noise.preprocess_noise, the reference's conversion
    conventions, qut_database.py:63-82)."""
    import numpy as np

    from .data import read_wav
    from .data.noise import preprocess_noise

    x, fs = read_wav(path)
    converted = np.asarray(x).ndim > 1 or fs != 16000
    x = preprocess_noise(x, fs)
    if converted:
        print(f"{path}: converted to 16 kHz mono")
    return x.astype(np.float32), 16000


def _to_16k_mono_file(path, tmpdir):
    """`path` unchanged if it is already 16 kHz mono, else a converted copy
    written under `tmpdir` (for library paths that read files themselves)."""
    import numpy as np

    from .data import read_wav, write_wav

    x, fs = read_wav(path)
    if fs == 16000 and np.asarray(x).ndim == 1:
        return path
    x, _ = _read_wav_16k(path)
    os.makedirs(tmpdir, exist_ok=True)
    out = os.path.join(tmpdir, os.path.basename(path))
    write_wav(out, x, 16000)
    return out


def _expand_inputs(pattern):
    """One wav path, a glob, or a directory -> (sorted wav list, multi-mode
    flag). Multi-mode is set by the form of the input (glob or directory),
    not the match count: a glob matching one file still writes per-file
    outputs into the output directory."""
    from glob import glob

    if os.path.isdir(pattern):
        files, multi = sorted(glob(os.path.join(pattern, "*.wav"))), True
    elif any(ch in pattern for ch in "*?["):
        files, multi = sorted(glob(pattern)), True
    else:
        files, multi = [pattern], False
    if not files:
        raise SystemExit(f"no wav files match {pattern!r}")
    return files, multi


def cmd_enhance(a):
    import tempfile

    import numpy as np
    import torch

    from .data import write_wav
    from .dsp import stft
    from .pipeline import enhance_to_audio, make_labels
    from .train import load_model

    files, multi = _expand_inputs(a.input)
    batch_out = (multi or os.path.isdir(a.output)
                 or a.output.endswith(("/", os.sep)))
    if len(files) > 1 and a.s_ref:
        raise SystemExit("--s_ref applies to a single input only")
    if len(files) > 1 and a.noise_out:
        raise SystemExit("--noise_out applies to a single input only")
    dev = _device(a)
    if batch_out:
        os.makedirs(a.output, exist_ok=True)

    cfg = _build_cfg(a)
    if a.profile:
        # a validated preset (profiles.py): authoritative for noise_model,
        # soft labels and the noise-gain knobs
        from .profiles import apply_profile_cfg, offline_settings

        a.noise_model, a.soft_labels = offline_settings(a.profile)
        cfg = apply_profile_cfg(cfg, a.profile)
    with tempfile.TemporaryDirectory(prefix="gvnmf_sref_") as tmp:
        if a.model_type == "m2":
            model = load_model(a.model, kind="dgm",
                               y_dim=1 if a.target == "vad" else 513,
                               device=dev)
            cls, mean, std, cmeta = _load_guidance(a, dev)
            if a.s_ref:
                # the oracle reference must match the (possibly converted)
                # mixture's rate so that label frames align
                a.s_ref = _to_16k_mono_file(a.s_ref, tmp)
        else:
            model = load_model(a.model, kind="vae", device=dev)

        waves, X_tfs = [], []
        ys = [] if a.model_type == "m2" else None
        for path in files:
            x, _ = _read_wav_16k(path)
            X_tf = stft(x)
            waves.append(x)
            X_tfs.append(X_tf)
            if ys is not None:
                y_soft, y_hard = make_labels(
                    a.label, np.abs(X_tf) ** 2, s_path=a.s_ref,
                    classifier=cls, mean=mean, std=std, target=a.target,
                    features=cmeta["features"],
                    dnn_threshold=cmeta["threshold"])
                ys.append(y_soft if a.soft_labels else y_hard)

    # every input runs in one padded batch; one generator seeds it
    s_list, n_list = enhance_to_audio(
        model, X_tfs, [len(x) for x in waves], ys=ys,
        generator=torch.Generator(device=dev).manual_seed(a.seed), cfg=cfg,
        noise_model=a.noise_model, fast=a.fast, device=dev)

    total_s = sum(len(x) for x in waves) / 16000.0
    for i, path in enumerate(files):
        if batch_out:
            base = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(a.output, base + "_enhanced.wav")
        else:
            out = a.output
        write_wav(out, np.asarray(s_list[i]), 16000)
        if a.noise_out:
            write_wav(a.noise_out, np.asarray(n_list[i]), 16000)
    dest = (a.output if not batch_out
            else f"{a.output.rstrip('/' + os.sep)}/ ({len(files)} files)")
    print(f"enhanced {a.input} -> {dest} "
          f"({total_s:.1f}s, {a.algorithm}/{a.noise_model}, "
          f"niter={a.niter})")
    return 0


# ---------------------------------------------------------------------------
# stream (online wav -> wav through the streaming flagship)
# ---------------------------------------------------------------------------

def cmd_stream(a):
    import numpy as np

    from .data import write_wav
    from .streaming import HOP, StreamingM2Enhancer
    from .train import load_model

    if a.profile:
        # a validated preset (profiles.py): authoritative for the managed
        # streaming knobs; the label source keeps its flag
        from .profiles import streaming_settings

        st = streaming_settings(a.profile)
        a.chunk_frames = st.get("chunk_frames", a.chunk_frames)
        a.context_frames = st.get("context_frames", a.context_frames)
        a.block_iters = st.get("block_iters", a.block_iters)
        a.e_steps = st.get("e_steps", a.e_steps)
        a.soft_labels = st.get("soft_guidance", a.soft_labels)
        a.stream_residual = st.get("residual_tracking", a.stream_residual)
        a.noise_gain = st.get("noise_gain", a.noise_gain)
        a.noise_gain_bands = st.get("noise_gain_bands",
                                    a.noise_gain_bands)
        a.adaptive_iters = st.get("adaptive_iters", a.adaptive_iters)
    dev = _device(a)
    x, fs = _read_wav_16k(a.input)
    dgm = load_model(a.model, kind="dgm",
                     y_dim=1 if a.target == "vad" else 513, device=dev)
    cls, mean, std, cmeta = _load_guidance(a, dev)
    enh = StreamingM2Enhancer(
        dgm, classifier=cls, mean=mean, std=std,
        chunk_frames=a.chunk_frames, context_frames=a.context_frames,
        block_iters=a.block_iters, e_steps=a.e_steps,
        label_mode=a.label, soft_guidance=a.soft_labels,
        residual_tracking=a.stream_residual, noise_gain=a.noise_gain,
        noise_gain_bands=a.noise_gain_bands,
        adaptive_iters=a.adaptive_iters, features=cmeta["features"],
        dnn_threshold=cmeta["threshold"], device=dev)
    chunk = a.chunk_frames * HOP
    outs = [enh.push(x[lo:lo + chunk]) for lo in range(0, len(x), chunk)]
    outs.append(enh.flush())
    y = np.concatenate(outs)
    write_wav(a.output, y, fs)
    latency_ms = (a.chunk_frames * HOP + 1024) / fs * 1000.0
    print(f"streamed {a.input} -> {a.output} "
          f"({len(x) / fs:.1f}s, chunk={a.chunk_frames} frames, "
          f"algorithmic latency ~{latency_ms:.0f} ms)")
    return 0


# ---------------------------------------------------------------------------
# metrics (pairwise quality report)
# ---------------------------------------------------------------------------

def cmd_metrics(a):
    from .data import read_wav
    from .metrics import energy_ratios, mos_lqo_wb, stoi
    from .metrics.pesq import pesq

    s, fs = read_wav(a.clean)
    sh, fs2 = read_wav(a.enhanced)
    if fs != fs2:
        raise SystemExit(f"sample-rate mismatch: {fs} vs {fs2}")
    x = None
    if a.mixture:
        x, _ = read_wav(a.mixture)
    ln = min(len(s), len(sh)) if x is None else min(len(s), len(sh),
                                                    len(x))
    s, sh = s[:ln], sh[:ln]
    rows = [
        ("ESTOI", f"{stoi(s, sh, fs, True):.4f}"),
        ("PESQ-wb (MOS-LQO)", f"{mos_lqo_wb(pesq(fs, s, sh, 'wb')):.3f}"),
    ]
    if x is not None:
        n = x[:ln] - s
        sdr, sir, sar = energy_ratios(sh, s, n)
        rows += [("SI-SDR", f"{sdr:+.2f} dB"),
                 ("SI-SIR", f"{sir:+.2f} dB"),
                 ("SI-SAR", f"{sar:+.2f} dB")]
    width = max(len(k) for k, _ in rows)
    for k, v in rows:
        print(f"{k:<{width}}  {v}")
    return 0


# ---------------------------------------------------------------------------
# serve (HTTP front end)
# ---------------------------------------------------------------------------

def cmd_serve(a):
    import time

    from .http_serving import build_server

    srv = build_server(
        a.models, host=a.host, port=a.port, niter=a.niter,
        noise_model=a.noise_model, noise_gain=a.noise_gain,
        noise_gain_bands=a.noise_gain_bands, soft_labels=a.soft_labels,
        fast=a.fast, wait_ms=a.wait_ms, warmup=a.warmup,
        stream=bool(a.stream), chunk_frames=a.chunk_frames,
        stream_residual=a.stream_residual,
        pooled_streams=bool(a.pooled_streams),
        max_streams=a.max_streams, tick_ms=a.tick_ms,
        data_parallel=a.data_parallel, profile=a.profile, device=a.device)
    srv.start()
    print(f"serving on http://{a.host}:{srv.port} "
          f"(niter={a.niter}, noise_model={a.noise_model}, "
          f"soft={a.soft_labels}, fast={a.fast})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close_all()
    return 0


# ---------------------------------------------------------------------------
# dataset / train: the training slice
# ---------------------------------------------------------------------------

def cmd_not_ported(a):
    print(f"gvnmf-torch {a.command}: training and its data layer are not "
          "ported yet (ROADMAP Queue 1, item 4)", file=sys.stderr)
    return 2


# ---------------------------------------------------------------------------
# doctor (bounded environment diagnostics)
# ---------------------------------------------------------------------------

_PROBE = ("import torch\n"
          "n = torch.cuda.device_count()\n"
          "print(n)\n"
          "print(torch.cuda.get_device_name(0) if n else '')\n")


def cuda_probe(timeout_s):
    """(device count, the first card's name) from a subprocess that gives
    up after `timeout_s`, so a wedged driver cannot hang the caller; raises
    subprocess.TimeoutExpired or RuntimeError."""
    import subprocess

    out = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, timeout=timeout_s)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or len(lines) < 1:
        raise RuntimeError(out.stderr.strip()[-200:] or "probe failed")
    return int(lines[0]), lines[1] if len(lines) > 1 else ""


def nvidia_smi(timeout_s):
    """`name, power.limit` of each card as nvidia-smi gives them, or None
    where nvidia-smi is absent or fails."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def cmd_doctor(a):
    """Reports torch and CUDA, the card (a probe in a subprocess bounded by
    --probe_s, and nvidia-smi's name and power limit), nvcc and the kernel
    libraries in the build directory. The port has no CPU fallback, so
    there is no fallback row; `scripts/doctor.py` is the variant that fails
    on a missing card or kernel build."""
    import subprocess

    import torch

    from . import _build

    def row(name, value, ok=True):
        print(f"  {'ok ' if ok else 'FAIL'} {name}: {value}")

    print("gvnmf-torch doctor")
    row("torch", f"{torch.__version__} (CUDA {torch.version.cuda})",
        ok=torch.version.cuda is not None)
    try:
        n, name = cuda_probe(a.probe_s)
        row("cuda", f"{n} device(s)" + (f", {name}" if n else ""), ok=n > 0)
    except subprocess.TimeoutExpired:
        row("cuda", f"probe unresponsive after {a.probe_s:.0f}s", ok=False)
    except RuntimeError as e:
        row("cuda", str(e), ok=False)
    smi = nvidia_smi(a.probe_s)
    row("nvidia-smi (name, power limit)", smi or "unavailable",
        ok=smi is not None)
    try:
        row("nvcc", _build._nvcc())
    except _build.KernelError as e:
        row("nvcc", str(e), ok=False)
    row("build dir", f"{_build.build_dir()} (GVNMF_TORCH_BUILD_DIR)")
    for src in sorted(_build.CSRC.glob("*.cu")):
        built = _build._lib_path(src).exists()
        row(f"kernel library {src.stem}", "built" if built else
            "not built (builds at first use)", ok=built)
    return 0


def cmd_version(a):
    try:
        from importlib.metadata import version

        print(version("guided-vae-nmf-tpu"))
    except Exception:
        print("0.1.0 (source tree)")
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def _add_device_flag(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu runs the "
                        "kernels' plain versions)")


def _add_engine_flags(p):
    from .profiles import PROFILE_NAMES

    p.add_argument("--profile", choices=PROFILE_NAMES, default=None,
                   help="validated operating-point preset (authoritative "
                        "for its managed knobs; profiles.py)")
    p.add_argument("--algorithm", choices=("mcem", "peem", "hybrid"),
                   default="mcem")
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--refine", type=int, default=150,
                   help="MCEM refinement iterations (--algorithm hybrid)")
    p.add_argument("--noise_model",
                   choices=("nmf", "spp", "spp2", "hybrid"), default="nmf")
    p.add_argument("--noise_gain", action="store_true")
    p.add_argument("--noise_gain_bands", type=int, default=1)
    p.add_argument("--soft_labels", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="bf16 dumps + approx reciprocal (fused engine)")


def _add_guidance_flags(p, label_default="dnn",
                        choices=("dnn", "oracle", "timo", "ones",
                                 "zeros")):
    p.add_argument("--label", default=label_default, choices=choices)
    p.add_argument("--target", choices=("ibm", "vad"), default="ibm")
    p.add_argument("--classifier", help="classifier ckpt/dir (--label dnn)")
    if "oracle" in choices:
        p.add_argument("--s_ref", help="clean wav (--label oracle)")


def build_parser():
    from .profiles import PROFILE_NAMES

    ap = argparse.ArgumentParser(
        prog="gvnmf-torch",
        description="guided-VAE + NMF speech enhancement on an NVIDIA GPU "
                    "(PyTorch + CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("enhance", help="offline wav -> enhanced wav")
    p.add_argument("input", help="wav file, glob, or directory "
                   "(multiple inputs run as one padded device batch)")
    p.add_argument("output", help="output wav (single input) or "
                   "directory (writes <name>_enhanced.wav per input)")
    p.add_argument("--model", required=True, help="M1/M2 ckpt or dir")
    p.add_argument("--model_type", choices=("m1", "m2"), default="m2")
    p.add_argument("--noise_out", help="also write the noise estimate")
    p.add_argument("--seed", type=int, default=0)
    _add_guidance_flags(p)
    _add_engine_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("stream", help="online chunked wav -> wav")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--model", required=True, help="M2 ckpt or dir")
    p.add_argument("--profile", choices=PROFILE_NAMES, default=None,
                   help="validated operating-point preset "
                        "(streaming-low-latency = 128 ms flagship; "
                        "streaming-192ms = balanced next latency step)")
    p.add_argument("--chunk_frames", type=int, default=8)
    p.add_argument("--context_frames", type=int, default=24)
    p.add_argument("--block_iters", type=int, default=6)
    p.add_argument("--e_steps", type=int, default=4)
    p.add_argument("--stream_residual", action="store_true")
    p.add_argument("--noise_gain", action="store_true")
    p.add_argument("--noise_gain_bands", type=int, default=1)
    p.add_argument("--adaptive_iters", type=int, default=0,
                   help="extra in-block EM iterations while the noise "
                        "gain still moves (impulse blocks escalate "
                        "their own budget; latency unchanged)")
    p.add_argument("--soft_labels", action="store_true")
    # causal label sources only: the stream has no oracle/constant modes
    _add_guidance_flags(p, label_default="timo", choices=("dnn", "timo"))
    _add_device_flag(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("metrics", help="quality report for a wav pair")
    p.add_argument("--clean", required=True)
    p.add_argument("--enhanced", required=True)
    p.add_argument("--mixture", help="adds the SI-SDR decomposition")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("serve", help="HTTP enhancement front end")
    p.add_argument("--models", default="artifacts/pretrained",
                   help="dir holding M2_ibm/ and classifier_ibm/")
    p.add_argument("--profile", choices=PROFILE_NAMES, default=None,
                   help="validated operating-point preset applied to "
                        "both serving paths (profiles.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--wait_ms", type=float, default=20.0)
    p.add_argument("--warmup", action="store_true")
    p.add_argument("--stream", type=int, default=1)
    p.add_argument("--pooled_streams", type=int, default=0)
    p.add_argument("--max_streams", type=int, default=8)
    p.add_argument("--tick_ms", type=float, default=5.0)
    p.add_argument("--data_parallel", action="store_true",
                   help="multi-GPU serving (not ported yet: ROADMAP "
                        "Queue 1, item 5)")
    p.add_argument("--chunk_frames", type=int, default=8)
    p.add_argument("--stream_residual", action="store_true")
    # the real-noise serving point, as build_server's defaults
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--noise_model",
                   choices=("nmf", "spp", "spp2", "hybrid"), default="spp")
    p.add_argument("--noise_gain", action="store_true")
    p.add_argument("--noise_gain_bands", type=int, default=1)
    p.add_argument("--soft_labels", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="bf16 dumps + approx reciprocal (fused engine)")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "dataset", help="synthesize a labeled-frames H5 from user wavs "
                        "(not ported yet: ROADMAP Queue 1, item 4)")
    p.add_argument("--clean", required=True,
                   help="clean-speech wavs (file, glob, or directory)")
    p.add_argument("--noise", required=True,
                   help="noise wavs (file, glob, or directory); each "
                        "file becomes one noise type")
    p.add_argument("--out", required=True, help="output H5 path")
    p.add_argument("--labels", default="noisy_labels",
                   choices=("noisy_labels", "noisy_vad_labels",
                            "noisy_wiener_labels"))
    p.add_argument("--snrs", default="-5,-2.5,0,2.5,5")
    p.add_argument("--val_fraction", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--augment", action="store_true",
                   help="speed/gain-augmented copies of the train split "
                        "(small-corpus recipe)")
    p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("train", help="train a model family from an H5 "
                                     "(not ported yet: ROADMAP Queue 1, "
                                     "item 4)")
    p.add_argument("family", choices=("m1", "m2", "classifier", "wiener"))
    p.add_argument("--h5", required=True,
                   help="labeled-frames H5 (create_*_train_set output)")
    p.add_argument("--out", required=True, help="checkpoint directory")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--z_dim", type=int, default=32)
    p.add_argument("--h_dim", default="128,128")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the frame batch over all devices")
    p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("doctor", help="bounded environment diagnostics")
    p.add_argument("--probe_s", type=float, default=30.0)
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("version", help="print the package version")
    p.set_defaults(fn=cmd_version)
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    raise SystemExit(main())
