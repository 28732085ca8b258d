"""The MH-MCEM family: the guided VAE (M2) and the unsupervised VAE (M1)
of arXiv:2102.06454, MLP nets loaded from the shipped checkpoints,
enhanced by the fused engine's Metropolis-Hastings chains inside the
NMF-noise EM. A configuration without a `family` key is of this family.

What decides `correct`: the armed batch, followed stage by stage from the
program's own state (the tap's record) by the plain reference, in
float64.

The MH chains accept or reject each proposal on a comparison that float32
rounding flips now and then, and a flipped frame follows another path from
then on; over 100 EM iterations, which couple the frames of an utterance
through W and H, every frame does. So the whole run cannot be replayed,
and each stage is checked from the state the program handed it:

- init: the NMF factors' and chain seeds' draws from the batch's generator,
  exact (mismatching values; limit 0);
- front: STFT, the label term, the encoder's Z, decode(Z) and, for the
  fixed-noise model, the SPP noise variance, against the reference's from
  the raw PCM (largest gap in a frame, relative to the frame's largest
  value);
- labels: the share of hard label bits that differ from the reference
  classifier's;
- div: the share of the valid frames of the judged chains (the E chains
  the tap kept and the Wiener-filter chain, pooled: a served batch holds
  some hundreds of frames, and one chain's share would count them one
  frame in a few hundred) whose chain left the reference's path,
  |dZ| > 0.01;
- e_gap / wf_gap: the largest relative gap of the chain's results in the
  frames that kept to the path;
- w_sums: the W update's sums against the reference's over the chain's own
  dumps;
- mstep: W, H and g after the M-step against the reference's from the
  chain's results (with a fixed noise variance only g updates, and its
  gap joins e_gap: the gain update has no product for the TF32 control to
  round);
- out: the PCM16 each real row got back against the reference's ISTFT of
  the program's Wiener gains before rounding, in LSB beyond the half LSB
  that rounding to PCM16 may take.

The control is the reference in TF32 put in the program's place: each
stage computed by the reference at TF32 from the same inputs, judged the
same way (`readings(..., subject="tf32")`).
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from gvbench.harness import bounds
from gvbench.harness.check import frame_gap, row_gap, worst_frame
from gvbench.reference import dsp, mcem, nets
from gvbench.reference.philox import streams
from gvbench.reference.precision import cast
from gvbench.reference.spp import spp_noise_psd

# E chains the check follows from the armed batch's state: E_CHAINS from
# chain i_sel on (a served batch holds some hundreds of frames, and one
# chain's diverged share would count them one frame in a few hundred)
E_CHAINS = 4

DIVERGED = 1e-2


# -- the system under test ---------------------------------------------------

def setup(root, config, device):
    """The port's kernels built (into its fixed build directory inside the
    checkout), its models and the classifier loaded from the shipped
    checkpoints, and its MCEM settings."""
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig
    from guided_vae_nmf_torch.train.checkpoints import (load_model,
                                                        load_norm_stats)

    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build_all()
    build_s = time.perf_counter() - t0
    m = config["model"]
    model = load_model(str(root / m["dir"]), kind=m["kind"],
                       y_dim=m.get("y_dim", 513), device=dev)
    cls = mean = std = None
    c = config.get("classifier")
    if c:
        cls = load_model(str(root / c["dir"]), kind="classifier",
                         device=dev)
        mean, std = load_norm_stats(str(root / c["dir"]))
    return SimpleNamespace(
        dev=dev, model=model, classifier=cls, mean=mean, std=std,
        cfg=MCEMConfig(**config["mcem"]), build_s=build_s, config=config,
        label_mode=config["label_mode"], shapes=shapes(config))


def shapes(config):
    m = config["model"]
    F, L, ws = m["x_dim"], m["z_dim"], list(m["h_dim"])
    y = m.get("y_dim", 0) if m["kind"] == "dgm" else 0
    out = {"F": F, "L": L, "ws": ws, "enc": [F + y] + ws, "cls": None}
    c = config.get("classifier")
    if c:
        out["cls"] = [F] + list(c["h_dim"]) + [c["y_dim"]]
    return out


def entry_kwargs(env, noise_model):
    """enhance_waveform's arguments besides the batch, as the sweep of
    `pipeline.enhance_files` passes them."""
    dnn = env.label_mode == "dnn"
    c = env.config.get("classifier") or {}
    return dict(classifier=env.classifier if dnn else None,
                mean=env.mean if dnn else None, std=env.std if dnn else None,
                label_mode=env.label_mode, noise_model=noise_model,
                return_noise=False, features=c.get("features", "power"),
                dnn_threshold=c.get("threshold", 0.5), device=env.dev)


def warm_cfg(cfg):
    """The settings a shape is warmed up with: one EM iteration."""
    return dataclasses.replace(cfg, niter=1)


def pick_judged(cfg, rng):
    """The first E chain the check follows (`i_sel`)."""
    return int(rng.integers(max(1, cfg.niter - E_CHAINS)))


def install(tap):
    """Wrap the fused engine's chain (`mcem.fused_engine.mh_chain`): for the
    armed call, keep references to the first E chain's inputs (the state
    the front end made), the inputs and results of E chains `i_sel` to
    `i_sel + E_CHAINS - 1` (the chain after `i_sel` also gives the state
    the M-step made) and the Wiener-filter chain's inputs and results.
    Returns the (object, name, original) the tap restores."""
    from guided_vae_nmf_torch.mcem import fused_engine

    real = fused_engine.mh_chain

    def chain(dec_w, X2, WH, g, ypre, Z, Vs, seed=0, **kw):
        out = real(dec_w, X2, WH, g, ypre, Z, Vs, seed, **kw)
        rec = tap.armed_record()
        if rec is None:
            return out
        chains = rec.setdefault("chains", [])
        chain_seeds = rec.setdefault("chain_seeds", [])
        j = len(chain_seeds)
        chain_seeds.append(int(seed))
        mode = kw.get("mode", "e")
        i_sel = rec["i_sel"]
        judged = i_sel <= j < i_sel + E_CHAINS
        keep_in = j in (0, i_sel + 1) or judged or mode == "wf"
        keep_out = judged or mode == "wf"
        if keep_in:
            chains.append({
                "j": j, "mode": mode, "seed": int(seed), "X2": X2, "WH": WH,
                "Vb": kw.get("Vb"), "g": g, "ypre": ypre, "Z": Z, "Vs": Vs,
                "mask": kw.get("mask"), "nsamples": kw.get("nsamples"),
                "burnin": kw.get("burnin"), "var_RW": kw.get("var_RW"),
                "out": out if keep_out else None})
        return out

    fused_engine.mh_chain = chain
    return [(fused_engine, "mh_chain", real)]


def batch_work(frames, rows, env, noise_model):
    """The work of one batch over its valid frames and real rows
    (`bounds.batch_work`)."""
    return bounds.batch_work(frames, rows, env.shapes, env.config["mcem"],
                             noise_model != "nmf", env.label_mode == "dnn")


# -- the check ---------------------------------------------------------------

class Reference:
    """The reference's models in float64 and in TF32 on a device."""

    def __init__(self, root, config, device):
        self.device = device
        self.arrays = nets.load_npz(str(root / config["model"]["dir"]))
        self.L = nets.z_dim(self.arrays)
        self.p = {pr: nets.Params(self.arrays, pr, device)
                  for pr in ("f64", "tf32")}
        self.cls = None
        cl = config.get("classifier")
        if cl:
            arr = nets.load_npz(str(root / cl["dir"]))
            self.cls = {pr: nets.Params(arr, pr, device)
                        for pr in ("f64", "tf32")}
            self.mean = np.load(str(root / cl["dir"] / "trainset_mean.npy"))
            self.std = np.load(str(root / cl["dir"] / "trainset_std.npy"))
            self.threshold = cl.get("threshold", 0.5)
        self.mcem = config["mcem"]


def unpack_labels(packed, y_dim):
    bits = np.unpackbits(np.asarray(packed.cpu()), axis=1)
    return torch.as_tensor(bits[:, :y_dim].astype(np.float64))


def _front(ref, prec, x_pad, mask, labels, vb):
    """The front end from raw PCM in a precision: X2 (B, N, F), the hard
    labels (B, N, y_dim) (from the reference's classifier), and, on the
    given `labels`, the label term, the encoder's Z and decode(Z); the SPP
    noise variance for the fixed-noise model."""
    dev = ref.device
    x = torch.as_tensor(x_pad, device=dev)
    x = cast(x, prec) / 32768.0
    m = torch.as_tensor(mask, device=dev)
    re, im = dsp.stft(x, prec)
    X2 = torch.where(m[..., None] > 0, re * re + im * im,
                     torch.ones_like(re))
    p = ref.p[prec]
    out = {"X2": X2, "re": re, "im": im}
    y = None
    if ref.cls is not None:
        c = ref.cls[prec]
        xn = (X2 - cast(ref.mean, prec).to(dev)) / (
            cast(ref.std, prec).to(dev) + 1e-8)
        out["y_hard"] = (nets.classifier(c, xn) > ref.threshold).to(
            X2.dtype)
        y = cast(labels if labels is not None else out["y_hard"],
                 prec).to(dev)
    out["ypre"] = nets.label_term(p, y, ref.L).expand(
        *X2.shape[:2], -1)
    enc_in = X2 if y is None else torch.cat([X2, y], dim=-1)
    out["Z"] = nets.encoder_mu(p, enc_in)
    out["Vs"] = nets.decode(p, out["Z"], out["ypre"])
    if vb:
        out["Vb"] = torch.clamp_min(
            spp_noise_psd(X2.transpose(1, 2)), 1e-6).transpose(1, 2)
    return out


def _run_chain(ref, prec, c, streams_, vb):
    ms = ref.mcem
    e = c["mode"] == "e"
    R = ms["nsamples_E_step"] if e else ms["nsamples_WF"]
    burn = ms["burnin_E_step"] if e else ms["burnin_WF"]
    Vb = c["Vb"] if vb else mcem.noise_var(cast(c["WH"][0], prec),
                                           cast(c["WH"][1], prec), prec)
    return mcem.chain(ref.p[prec], c["X2"], Vb, c["g"], c["ypre"], c["Z"],
                      c["Vs"], *streams_, c["mode"], R, burn,
                      float(np.float32(np.sqrt(ms["var_RW"]))), prec)


def _chain_out(c, vb):
    """The program's chain results as the reference names them."""
    Z, Vs, extra = c["out"]
    if c["mode"] == "wf":
        return {"Z": Z, "Vs": Vs, "ws": extra[0], "wn": extra[1]}
    d = {"Z": Z, "Vs": Vs, "samples": extra[0]}
    d.update({"s1": extra[1], "s2": extra[2]} if vb else
             {"numW": extra[1], "denW": extra[2]})
    return d


def readings(rec, ref, rows_s, subject="program"):
    """The check's numbers for the armed batch. rows_s: the PCM16 each
    real row got back (int arrays of its utterance's length), or None for
    the control, whose output the reference computes itself."""
    dev = ref.device
    vb = rec["kw"].get("noise_model", "nmf") != "nmf"
    real = rec["rows"]
    mask = torch.as_tensor(rec["mask"], device=dev)
    valid = (mask > 0).clone()
    valid[real:] = False
    chains = {c["j"]: c for c in rec["chains"]}
    wf = next(c for c in rec["chains"] if c["mode"] == "wf")
    c0 = chains[0]
    i_sel = rec["i_sel"]
    if i_sel not in chains or chains[i_sel]["mode"] != "e":
        i_sel = None
    judged = sorted(j for j, c in chains.items()
                    if c["mode"] == "e" and c["out"] is not None)
    nums = {}
    where = {}              # diagnostics: the frame behind each gap

    # init: the generator's draws, exact
    bad = 0
    if subject == "program":
        gen = torch.Generator(device=dev).manual_seed(rec["gen_seed"])
        bad += int(rec["gen_seed"] != rec["seeds"][0] % 2**63)
        B, N = mask.shape
        F = c0["X2"].shape[-1]
        if not vb:
            K = ref.mcem["nmf_rank"]
            W0 = torch.clamp_min(torch.rand((B, F, K), generator=gen,
                                            device=dev), ref.mcem["eps"])
            H0 = torch.clamp_min(torch.rand((B, K, N), generator=gen,
                                            device=dev), ref.mcem["eps"])
            bad += int((c0["WH"][0] != W0.transpose(1, 2)).sum())
            bad += int((c0["WH"][1] != H0).sum())
        s = torch.randint(0, 2**62, (ref.mcem["niter"] + 1,), generator=gen,
                          device=dev).tolist()
        bad += sum(a != b for a, b in zip(s, rec["chain_seeds"]))
        bad += abs(len(s) - len(rec["chain_seeds"]))
    nums["init"] = bad

    # front: labels from the program's bits; the rest from raw PCM
    prog_labels = None
    if ref.cls is not None:
        prog_labels = unpack_labels(rec["out"][3], ref.cls["f64"].t[
            "out.b"].shape[0]).transpose(1, 2).to(dev)
    if subject == "program":
        sub = {"X2": c0["X2"], "ypre": c0["ypre"], "Z": c0["Z"],
               "Vs": c0["Vs"], "Vb": c0["Vb"], "y_hard": prog_labels}
    else:
        sub = _front(ref, "tf32", rec["x_pad"], rec["mask"], None, vb)
    r = _front(ref, "f64", rec["x_pad"], rec["mask"], sub.get("y_hard"), vb)
    gaps = [frame_gap(sub[k], r[k], valid) for k in ("X2", "ypre", "Z",
                                                      "Vs")]
    if vb:
        gaps.append(frame_gap(sub["Vb"], r["Vb"], valid))
    nums["front"] = max(gaps)
    if ref.cls is not None:
        flips = (sub["y_hard"].to(dev) != r["y_hard"]).double().sum(-1)
        nums["labels"] = float(flips[valid].sum()) / (
            float(valid.sum()) * r["y_hard"].shape[-1])

    def judge_chain(c, name, div_acc):
        B, N, L = c["Z"].shape
        R = (ref.mcem["nsamples_E_step"] + ref.mcem["burnin_E_step"]
             if c["mode"] == "e" else
             ref.mcem["nsamples_WF"] + ref.mcem["burnin_WF"])
        st = streams(c["seed"], B, N, L, R, dev)
        want = _run_chain(ref, "f64", c, st, vb)
        got = (_chain_out(c, vb) if subject == "program"
               else _run_chain(ref, "tf32", c, st, vb))
        div = torch.abs(got["Z"].double() - want["Z"]).amax(-1) > DIVERGED
        div_acc.append(div[valid])
        kept = valid & ~div
        keys = ["Z", "samples", "s1", "s2"] if c["mode"] == "e" else [
            "Z", "ws", "wn"]
        for k in keys:
            if k in want and k in got:
                a, b = got[k], want[k]
                if k == "samples":
                    a, b = a.transpose(1, 2), b.transpose(1, 2)
                if k in ("ws", "wn"):
                    # sums of R gains in [0, 1]: their absolute gap over R
                    # (a gain near 0 is a difference of nearly equal terms)
                    d = torch.abs(a.double() - b).amax(-1) / ref.mcem[
                        "nsamples_WF"]
                    nums[f"{name}_gap.{k}"] = (float(d[kept].max())
                                               if bool(kept.any()) else 0.0)
                else:
                    nums[f"{name}_gap.{k}"] = frame_gap(a, b, kept)
                    where[f"{name}_gap.{k}"] = worst_frame(a, b, kept)
        nums[name + "_gap"] = max(v for k, v in nums.items()
                                  if k.startswith(name + "_gap."))
        return got

    # E chain i_sel, the W sums over its dumps, and the M-step after it
    divs = []
    if i_sel is not None:
        gaps = {}
        for j in judged:
            g = judge_chain(chains[j], "e", divs)
            for k in [k for k in nums if k.startswith("e_gap.")]:
                gaps[k] = max(gaps.get(k, 0.0), nums.pop(k))
            if j == i_sel:
                got = g
        nums.update(gaps)
        nums["e_gap"] = max(gaps.values())
        nums["div.e"] = float(torch.cat(divs).double().mean())
        c = chains[i_sel]
        nxt = chains.get(i_sel + 1, wf)
        if vb:
            want_g = mcem.mstep_vb(got["samples"], c["g"], c["Vb"], c["X2"],
                                   "f64")
            got_g = (nxt["g"] if subject == "program" else mcem.mstep_vb(
                got["samples"], c["g"], c["Vb"], c["X2"], "tf32"))
            # the gain update alone has no product for TF32 to round, so
            # the control cannot separate it: it joins the E-step's number
            nums["e_gap.g_next"] = frame_gap(got_g[..., None],
                                             want_g[..., None], valid)
            where["e_gap.g_next"] = worst_frame(got_g[..., None],
                                                want_g[..., None], valid)
            nums["e_gap"] = max(nums["e_gap"], nums["e_gap.g_next"])
        else:
            Wt, H = c["WH"]
            if subject != "program":
                got["numW"], got["denW"] = mcem.w_sums(
                    got["samples"], Wt, H, c["g"], c["X2"], c["mask"],
                    "tf32")
            nW, dW = mcem.w_sums(got["samples"], Wt, H, c["g"], c["X2"],
                                 c["mask"], "f64")
            nums["w_sums"] = max(row_gap(got["numW"][:real], nW[:real]),
                                 row_gap(got["denW"][:real], dW[:real]))
            args = (got["samples"], got["numW"], got["denW"], Wt, H, c["g"],
                    c["X2"])
            want = mcem.mstep_nmf(*args, "f64")
            have = ((nxt["WH"][0], nxt["WH"][1], nxt["g"])
                    if subject == "program" else mcem.mstep_nmf(*args,
                                                                "tf32"))
            nums["mstep"] = max(
                row_gap(have[0][:real], want[0][:real]),
                frame_gap(have[1].transpose(1, 2), want[1].transpose(1, 2),
                          valid),
                frame_gap(have[2][..., None], want[2][..., None], valid))

    # the Wiener-filter chain, then ISTFT and PCM16 of its gains
    got = judge_chain(wf, "wf", divs)
    nums["div.wf"] = float(divs[-1].double().mean())
    nums["div"] = float(torch.cat(divs).double().mean())
    WFs = cast(got["ws"], "f64") / ref.mcem["nsamples_WF"]
    s_ref = torch.clamp(32768.0 * dsp.istft_masked(
        WFs * r["re"], WFs * r["im"], mask, "f64"), -32768, 32767)
    if subject == "program":
        outs = rows_s
    else:
        WFc = cast(got["ws"], "tf32") / ref.mcem["nsamples_WF"]
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
