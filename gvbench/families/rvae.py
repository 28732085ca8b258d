"""The RVAE family: the recurrent VAE of arXiv:1910.10942 (non-causal
BRNN decoder) with weights drawn from the configuration's seed, enhanced
by Langevin-dynamics MCEM with the NMF noise model (arXiv:2309.10439):
the program's `mcem.rvae_engine`, run through `pipeline.enhance_waveform`.

What decides `correct`: the armed batch, followed stage by stage from the
program's own state (the tap's record) by the plain reference
(`reference/rvae.py`) in float64. The chain has no accept test, so no
decision can flip on rounding, but each step scales the last one's
rounding by the gradient's Jacobian, and over 100 EM iterations the
program's and a float64 run drift apart as any two float32 orders would;
so each stage is checked from the state the program handed it:

- init: the NMF factors' and chain seeds' draws from the batch's
  generator, exact (mismatching values; limit 0);
- front: X2 from the raw PCM, the encoder's Z and the first decode's Vs
  (largest gap in a frame over the frame's largest value);
- e_gap: E chain `i_sel` from its input state with the same draws (drawn
  again from the chain's seed): Z and the R dumps;
- w_sums: the M-step's first sums (sum_r 1/Vx and 1/Vx^2 a bin, the W
  update's) over the chain's dumps, against the float64 sums over the
  float64 chain's dumps from the same state and draws: the sums hold no
  product, so over the same dumps the TF32 control would read what the
  program reads; from the float64 chain they take the chain's rounding
  with them, as the M-step does;
- mstep: W, H and g after the M-step against the reference's from the
  chain's dumps;
- wf_gap: the Wiener-filter chain from its input state: Z, and the
  averaged gains WFs and WFn (absolute: they lie in [0, 1]);
- out: the PCM16 each real row got back against the reference's ISTFT of
  the program's Wiener gains before rounding, in LSB beyond the half LSB
  that rounding to PCM16 may take.

The control is the reference in TF32 put in the program's place
(`readings(..., subject="tf32")`): its products' operands, and in the
gradient their incoming gradients, rounded to TF32.

Work (`batch_work`): every count is over valid frames and real rows;
`lstm_sweep_work` is what the two sweep kernels do, `chain_work` a
Langevin step's whole work (the sweeps, the output layer and its
transpose, the likelihood and update passes), "k2" the M-step's sums
kernels (`bounds.sums_work`). `sweep_work` and `pass_work` count one
launch of each kernel; `chip_smoke.py` and `bench_kernels.py` take their
bounds from them.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from gvbench.harness import bounds
from gvbench.harness.check import frame_gap, row_gap, worst_frame
from gvbench.reference import dsp
from gvbench.reference import rvae as ref_rvae
from gvbench.reference.precision import cast


def dims(config):
    m = config["model"]
    return [m["x_dim"], m["z_dim"], m["rnn"], list(m["dense_g"])]


# -- the system under test ---------------------------------------------------

def setup(root, config, device):
    """The port's kernels built, the RVAE drawn from the configuration's
    seed, and the chain settings."""
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem.rvae_engine import RVAEConfig
    from guided_vae_nmf_torch.models.rvae import rvae_init

    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build_all()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(config["model"]["seed"])
    model = rvae_init(gen, dims(config)).to(dev)
    return SimpleNamespace(
        dev=dev, model=model, classifier=None, mean=None, std=None,
        cfg=RVAEConfig(**config["mcem"]), build_s=build_s, config=config,
        label_mode=config["label_mode"])


def entry_kwargs(env, noise_model):
    return dict(label_mode=env.label_mode, noise_model=noise_model,
                return_noise=False, device=env.dev)


def warm_cfg(cfg):
    """The settings a shape is warmed up with: one EM iteration."""
    return dataclasses.replace(cfg, niter=1)


def pick_judged(cfg, rng):
    """The E chain the check follows (`i_sel`): one with an M-step and a
    chain after it."""
    return int(rng.integers(max(1, cfg.niter - 1)))


def install(tap):
    """Wrap the engine's chain (`rvae_engine.langevin_chain`), its M-step
    (`rvae_engine._nmf_m_step_batched`) and the M-step's sums
    (`fused_engine.nmf_sums`): for the armed call, keep references to the
    first chain's inputs and first decode, the inputs and results of E
    chain `i_sel` and of the Wiener-filter chain, the first M-step's
    inputs (the NMF init) and M-step `i_sel`'s inputs, first sums and
    results."""
    from guided_vae_nmf_torch.mcem import fused_engine, rvae_engine

    real_chain = rvae_engine.langevin_chain
    real_mstep = rvae_engine._nmf_m_step_batched
    real_sums = fused_engine.nmf_sums

    def chain(dec, X2, Vb, g, mask, lengths, Z, fwd, seed, mode, nsamples,
              burnin, eta, noise=rvae_engine.chain_noise):
        out = real_chain(dec, X2, Vb, g, mask, lengths, Z, fwd, seed, mode,
                         nsamples, burnin, eta, noise)
        rec = tap.armed_record()
        if rec is None:
            return out
        seeds = rec.setdefault("chain_seeds", [])
        j = len(seeds)
        seeds.append(int(seed))
        rec["last_chain"] = j
        i_sel = rec["i_sel"]
        judged = j == i_sel or mode == "wf"
        if j == 0 or judged:
            rec.setdefault("chains", []).append({
                "j": j, "mode": mode, "seed": int(seed), "X2": X2, "Vb": Vb,
                "g": g, "Z": Z, "Hout": fwd[0] if j == 0 else None,
                "wo": dec[3] if j == 0 else None,
                "bo": dec[4] if j == 0 else None,
                "nsamples": nsamples, "burnin": burnin, "eta": eta,
                "out": (out[0], out[2]) if judged else None})
        return out

    def mstep(X2, mask, W, H, g, Vs, *args, **kw):
        rec = tap.armed_record()
        j = None if rec is None else rec.get("last_chain")
        keep = j in (0, rec["i_sel"]) if rec is not None else False
        if keep:
            rec.setdefault("msteps", {})[j] = {"W": W, "H": H, "g": g}
        out = real_mstep(X2, mask, W, H, g, Vs, *args, **kw)
        if keep:
            rec["msteps"][j]["out"] = out
        return out

    def sums(samples, WH, g, X2=None, mode="h", Vb=None, approx_recip=False):
        out = real_sums(samples, WH, g, X2, mode=mode, Vb=Vb,
                        approx_recip=approx_recip)
        rec = tap.armed_record()
        if rec is not None:
            m = rec.get("msteps", {}).get(rec.get("last_chain"))
            if m is not None and "out" not in m and "sums" not in m:
                m["sums"] = out
        return out

    rvae_engine.langevin_chain = chain
    rvae_engine._nmf_m_step_batched = mstep
    fused_engine.nmf_sums = sums
    return [(rvae_engine, "langevin_chain", real_chain),
            (rvae_engine, "_nmf_m_step_batched", real_mstep),
            (fused_engine, "nmf_sums", real_sums)]


# -- the work ----------------------------------------------------------------

def sweep_work(V, L, Hn, U=1):
    """(flops, bytes) of one forward sweep ("fwd") and one backward sweep
    ("bwd") over V valid frames of U rows: per frame and direction a
    forward step's 2 * 4H (L + H) products and 10 H of gate math, a
    backward step's 2 * 4H (H + L) products and 15 H of gate-gradient
    math. Bytes: the forward sweep reads Z and writes Hout (2H) and the
    saved gates and cell (2 x 5H); the backward reads dL/dHout and the
    saved values and writes four dL/dz partials; each launch reads the
    weights once a row."""
    weights = U * 2 * 4 * Hn * (L + Hn + 1) * 4
    return {"fwd": (V * 2 * (2 * 4 * Hn * (L + Hn) + 10 * Hn),
                    V * 4 * (L + 2 * Hn + 2 * 5 * Hn) + weights),
            "bwd": (V * 2 * (2 * 4 * Hn * (Hn + L) + 15 * Hn),
                    V * 4 * (2 * Hn + 2 * 5 * Hn + 4 * L) + weights)}


def pass_work(V, F, L):
    """(flops, bytes) of one likelihood pass ("lik": exp, g Vs + Vb and the
    gradient, 8 F a frame; reads O, X2 and Vb, writes Vs and the gradient)
    and one update ("update": 6 L a frame; reads Z, eps and the four
    partials, writes Z) over V valid frames."""
    return {"lik": (V * 8 * F, V * 4 * 5 * F),
            "update": (V * 6 * L, V * 4 * 7 * L)}


def lstm_sweep_work(V, F, L, Hn, steps, U=1):
    """(flops, bytes) of `steps` forward and backward sweeps over V valid
    frames of U rows (:func:`sweep_work`)."""
    w = sweep_work(V, L, Hn, U)
    return (steps * (w["fwd"][0] + w["bwd"][0]),
            steps * (w["fwd"][1] + w["bwd"][1]))


def chain_work(V, F, L, Hn, steps, U=1):
    """(flops, bytes) of `steps` Langevin steps over V valid frames: the
    sweeps, the output layer 2 (2H) F and its transpose 2 F (2H), the
    likelihood and update passes (:func:`pass_work`). Bytes beyond the
    sweeps' and the passes': the products read Hout and write O, read the
    gradient and write dL/dHout."""
    f, b = lstm_sweep_work(V, F, L, Hn, steps, U)
    p = pass_work(V, F, L)
    f += steps * (V * 2 * 2 * (2 * Hn) * F + p["lik"][0] + p["update"][0])
    b += steps * (V * 4 * 2 * (2 * Hn + F) + p["lik"][1] + p["update"][1])
    return f, b


def batch_work(frames, rows, env, noise_model):
    """The work of one batch: {"flops": the whole batch's operations,
    "chain": (flops, bytes) of the Langevin chains, "lstm_sweep": (flops,
    bytes) of the sweep kernels, the first decode's forward sweep
    included, "k2": (flops, bytes) of the M-step's sums kernels (two 'h'
    passes and one 'g' pass an EM iteration at a given Vb)}."""
    return work_counts(frames, rows, env.config)


def work_counts(V, U, config):
    F, L, Hn, dense = dims(config)
    ms = config["mcem"]
    R, it, K = ms["nsamples_E_step"], ms["niter"], ms["nmf_rank"]
    steps = it * (R + ms["burnin_E_step"]) + ms["nsamples_WF"] + ms[
        "burnin_WF"]
    chain = chain_work(V, F, L, Hn, steps, U)
    sweeps = lstm_sweep_work(V, F, L, Hn, steps, U)
    # the first decode's forward sweep
    first = sweep_work(V, L, Hn, U)["fwd"]
    sweeps = (sweeps[0] + first[0], sweeps[1] + first[1])
    flops = chain[0] + first[0] + V * 2 * 2 * Hn * F
    # the encoder: x-BiLSTM, z-LSTM, dense layers and mean head
    sizes = [3 * Hn, *dense]
    flops += V * (2 * 2 * 4 * Hn * (F + Hn) + 2 * 4 * Hn * (L + Hn)
                  + 2 * sum(a * b for a, b in zip(sizes, sizes[1:]))
                  + 2 * sizes[-1] * L + 30 * Hn)
    # the M-step's three sums passes and the W / H / g updates, the cost
    h = bounds.sums_work(V, U, R, F, K, "h", True)
    g = bounds.sums_work(V, U, R, F, K, "g", True)
    k2 = (it * (2 * h[0] + g[0]), it * (2 * h[1] + g[1]))
    flops += k2[0] + it * (U * 6 * K * F + V * 10 * K + V * 6 * R * F)
    # one STFT and two ISTFTs of 1024 points a frame
    flops += V * 3 * 5 * 1024 * 10
    return {"flops": flops, "chain": chain, "lstm_sweep": sweeps, "k2": k2}


# -- the check ---------------------------------------------------------------

class Reference:
    """The reference RVAE's weights, from the configuration's seed, in
    float64 and in TF32 on a device."""

    def __init__(self, root, config, device):
        self.device = device
        w = ref_rvae.init_weights(config["model"]["seed"], dims(config))
        self.p = {pr: ref_rvae.Params(w, pr, device)
                  for pr in ("f64", "tf32")}
        self.mcem = config["mcem"]


def _front(ref, prec, x_pad, mask):
    """X2, the encoder's Z and the first decode's Vs from raw PCM, and the
    mixture's STFT."""
    dev = ref.device
    x = cast(torch.as_tensor(x_pad, device=dev), prec) / 32768.0
    m = torch.as_tensor(mask, device=dev)
    re, im = dsp.stft(x, prec)
    X2 = torch.where(m[..., None] > 0, re * re + im * im,
                     torch.ones_like(re))
    lengths = (m > 0).sum(-1)
    p = ref.p[prec]
    Z = ref_rvae.encode_mean(p, X2, lengths, prec)
    Vs = torch.exp(ref_rvae.decode_logvar(p, Z, lengths, prec))
    return {"X2": X2, "Z": Z, "Vs": Vs, "re": re, "im": im}


def _chain(ref, prec, c, lengths, mask):
    B, N, L = c["Z"].shape
    gen = torch.Generator(device=c["Z"].device).manual_seed(c["seed"])
    eps = torch.randn((c["burnin"] + c["nsamples"], B, N, L), generator=gen,
                      device=c["Z"].device)
    return ref_rvae.langevin_chain(
        ref.p[prec], c["X2"], c["Vb"], c["g"], mask, lengths, c["Z"], eps,
        c["mode"], c["nsamples"], c["burnin"], c["eta"], prec)


def readings(rec, ref, rows_s, subject="program"):
    """The check's numbers for the armed batch. rows_s: the PCM16 each
    real row got back, or None for the control."""
    dev = ref.device
    ms = ref.mcem
    real = rec["rows"]
    mask = torch.as_tensor(rec["mask"], device=dev)
    lengths = (mask > 0).sum(-1)
    valid = (mask > 0).clone()
    valid[real:] = False
    chains = {c["j"]: c for c in rec["chains"]}
    wf = next(c for c in rec["chains"] if c["mode"] == "wf")
    c0 = chains[0]
    i_sel = rec["i_sel"]
    steps = rec.get("msteps", {})
    nums, where = {}, {}

    # init: the generator's draws, exact
    bad = 0
    if subject == "program":
        gen = torch.Generator(device=dev).manual_seed(rec["gen_seed"])
        bad += int(rec["gen_seed"] != rec["seeds"][0] % 2**63)
        B, N = mask.shape
        F, K = c0["X2"].shape[-1], ms["nmf_rank"]
        W0 = torch.clamp_min(torch.rand((B, F, K), generator=gen,
                                        device=dev), ms["eps"])
        H0 = torch.clamp_min(torch.rand((B, K, N), generator=gen,
                                        device=dev), ms["eps"])
        m0 = steps.get(0)
        bad += (B * F * K + B * K * N if m0 is None else
                int((m0["W"] != W0).sum()) + int((m0["H"] != H0).sum()))
        s = torch.randint(0, 2**62, (ms["niter"] + 1,), generator=gen,
                          device=dev).tolist()
        bad += sum(a != b for a, b in zip(s, rec["chain_seeds"]))
        bad += abs(len(s) - len(rec["chain_seeds"]))
    nums["init"] = bad

    # front: from raw PCM
    r = _front(ref, "f64", rec["x_pad"], rec["mask"])
    if subject == "program":
        o = (c0["Hout"].double() @ c0["wo"].double() + c0["bo"].double())
        sub = {"X2": c0["X2"], "Z": c0["Z"], "Vs": torch.exp(o)}
    else:
        sub = _front(ref, "tf32", rec["x_pad"], rec["mask"])
    for k in ("X2", "Z", "Vs"):
        nums[f"front.{k}"] = frame_gap(sub[k], r[k], valid)
        where[f"front.{k}"] = worst_frame(sub[k], r[k], valid)
    nums["front"] = max(nums[f"front.{k}"] for k in ("X2", "Z", "Vs"))

    # E chain i_sel, the M-step's sums over its dumps, the M-step
    c = chains[i_sel]
    want = _chain(ref, "f64", c, lengths, mask)
    got = ({"Z": c["out"][0], "samples": c["out"][1]}
           if subject == "program" else _chain(ref, "tf32", c, lengths,
                                               mask))
    for k, a, b in (("Z", got["Z"], want["Z"]),
                    ("samples", got["samples"].transpose(1, 2),
                     want["samples"].transpose(1, 2))):
        nums[f"e_gap.{k}"] = frame_gap(a, b, valid)
        where[f"e_gap.{k}"] = worst_frame(a, b, valid)
    nums["e_gap"] = max(nums["e_gap.Z"], nums["e_gap.samples"])
    m = steps[i_sel]
    s_want = ref_rvae.h_sums(want["samples"], m["g"], c["Vb"], "f64")
    s_got = (m["sums"] if subject == "program" else
             ref_rvae.h_sums(got["samples"], m["g"], c["Vb"], "tf32"))
    nums["w_sums"] = max(frame_gap(s_got[0], s_want[0], valid),
                         frame_gap(s_got[1], s_want[1], valid))
    args = (got["samples"], m["W"].transpose(1, 2), m["H"], m["g"],
            c["X2"], mask)
    Wt, H, g = ref_rvae.mstep(*args, "f64")
    if subject == "program":
        W1, H1, g1 = m["out"]
        Wt1 = W1.transpose(1, 2)
    else:
        Wt1, H1, g1 = ref_rvae.mstep(*args, "tf32")
    nums["mstep"] = max(
        row_gap(Wt1[:real], Wt[:real]),
        frame_gap(H1.transpose(1, 2), H.transpose(1, 2), valid),
        frame_gap(g1[..., None], g[..., None], valid))

    # the Wiener-filter chain, then ISTFT and PCM16 of its gains
    R = ms["nsamples_WF"]
    want = _chain(ref, "f64", wf, lengths, mask)
    if subject == "program":
        Zw, (ws, wn) = wf["out"]
        got = {"Z": Zw, "ws": ws, "wn": wn}
    else:
        got = _chain(ref, "tf32", wf, lengths, mask)
    nums["wf_gap.Z"] = frame_gap(got["Z"], want["Z"], valid)
    for k in ("ws", "wn"):
        d = torch.abs(got[k].double() - want[k]).amax(-1) / R
        nums[f"wf_gap.{k}"] = float(d[valid].max()) if bool(
            valid.any()) else 0.0
    nums["wf_gap"] = max(nums["wf_gap.Z"], nums["wf_gap.ws"],
                         nums["wf_gap.wn"])
    WFs = cast(got["ws"], "f64") / R
    s_ref = torch.clamp(32768.0 * dsp.istft_masked(
        WFs * r["re"], WFs * r["im"], mask, "f64"), -32768, 32767)
    if subject == "program":
        outs = rows_s
    else:
        WFc = cast(got["ws"], "tf32") / R
        s_c = dsp.pcm16(dsp.istft_masked(WFc * sub["re"], WFc * sub["im"],
                                         mask, "tf32")).cpu().numpy()
        outs = [s_c[j, :len(rows_s[j])] for j in range(real)]
    worst = 0.0
    s_ref = s_ref.cpu().numpy()
    for j in range(real):
        got_j = np.asarray(outs[j], np.float64)
        want_j = s_ref[j, :len(got_j)]
        if len(want_j) != len(got_j):
            nums["where"] = where
            return nums, f"row {j}: {len(got_j)} samples returned"
        worst = max(worst, float(np.abs(got_j - want_j).max()))
    nums["out"] = worst - 0.5
    nums["where"] = where
    return nums, None
