"""The work a batch needs, from the algorithm's shapes over its valid
frames (SURVEY section 2.4), and the least time the card could take for
it: the larger of operations over the float32 peak and bytes over the
memory bandwidth. Padded frames and duplicated rows are work the program
chose to do, not work the inputs need, so none is counted; a change that
skips them then reads as the same work in less time.

`chain_work` and `sums_work` are `chip_smoke.chain_bound` and `sums_bound`
(frozen here) with their B N frames replaced by the valid frames V and
their B utterances by the real rows U.
"""

# NVIDIA H100 SXM, data sheet, dense: float32 outside the tensor cores,
# and HBM3 bandwidth; at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def seconds(flops, nbytes):
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def chain_work(V, U, F, L, ws, K, R, n_steps, mode, vb):
    """(flops, bytes) of one K1 launch over V valid frames of U
    utterances: per frame and step the decoder's 2 (L H1 + sum H_i H_i+1 +
    Hd F) multiply-adds, sum H_i tanh and F exp, 8 F for the data term and
    6 L for the proposal; with the NMF factors 2 K F a frame for Vb and, in
    E-mode, 4 K F for the W-update sums. Bytes: every input read once and
    every output written once."""
    mids = sum(a * b for a, b in zip(ws, ws[1:]))
    per_step = (2 * (L * ws[0] + mids + ws[-1] * F) + sum(ws) + F + 8 * F
                + 6 * L)
    flops = V * n_steps * per_step
    if vb:
        in_noise = V * F
        e_out = 2 * V * F
    else:
        flops += V * 2 * K * F + (4 * K * V * F if mode == "e" else 0)
        in_noise = U * K * F + K * V + (V if mode == "e" else 0)
        e_out = 2 * U * K * F
    if mode == "e":
        out_bytes = 4 * (V * L + V * F + e_out) + 4 * R * V * F
    else:
        out_bytes = 4 * (V * L + 3 * V * F)
    in_bytes = 4 * (2 * V * F + in_noise + V + V * ws[0] + V * L
                    + L * ws[0] + mids + sum(ws[1:]) + ws[-1] * F + F)
    return flops, in_bytes + out_bytes


def sums_work(V, U, R, F, K, mode, vb):
    """(flops, bytes) of one K2 launch: 6 operations a sample, 2 a bin in
    'g' mode for X2, and with the NMF factors 2 K a bin for Vb plus 4 K a
    bin in 'h' mode for the H contraction."""
    samples = 4 * R * V * F
    if vb:
        flops = V * F * (6 * R + (2 if mode == "g" else 0))
        in_bytes = samples + 4 * (V * F + V + (V * F if mode == "g" else 0))
        out_bytes = 8 * (V * F if mode == "h" else V)
    else:
        flops = V * F * (2 * K + 6 * R + (4 * K if mode == "h" else 2))
        in_bytes = samples + 4 * (V * F + U * K * F + K * V + V)
        out_bytes = 8 * V * (K if mode == "h" else 1)
    return flops, in_bytes + out_bytes


def batch_work(V, U, shapes, mcem, vb, classifier):
    """The work of one batch of MCEM over V valid frames of U utterances.
    `shapes`: F, L, ws (the decoder's hidden widths), enc (the encoder's
    input and hidden widths), cls (the classifier's widths or None).
    Returns {"k1": (flops, bytes, launches), "k2": (...), "flops": the
    whole step's operations}."""
    F, L, ws = shapes["F"], shapes["L"], shapes["ws"]
    K = 0 if vb else mcem["nmf_rank"]
    R, it = mcem["nsamples_E_step"], mcem["niter"]
    e = chain_work(V, U, F, L, ws, K, R,
                   R + mcem["burnin_E_step"], "e", vb)
    wf = chain_work(V, U, F, L, ws, K, 0,
                    mcem["nsamples_WF"] + mcem["burnin_WF"], "wf", vb)
    k1 = (it * e[0] + wf[0], it * e[1] + wf[1])
    passes = ["g"] if vb else ["h", "g"]
    k2 = [sums_work(V, U, R, F, K, m, vb) for m in passes]
    k2 = (it * sum(f for f, _ in k2), it * sum(b for _, b in k2))
    enc = shapes["enc"]
    flops = k1[0] + k2[0]
    # encoder (mu and log-variance heads) and the first decode
    flops += V * (2 * sum(a * b for a, b in zip(enc, enc[1:]))
                  + 2 * 2 * enc[-1] * L + sum(enc[1:]))
    mids = sum(a * b for a, b in zip(ws, ws[1:]))
    flops += V * (2 * (L * ws[0] + mids + ws[-1] * F) + sum(ws) + F)
    if classifier:
        cls = shapes["cls"]
        flops += V * (2 * sum(a * b for a, b in zip(cls, cls[1:]))
                      + sum(cls[1:]))
    # one STFT and two ISTFTs of 1024 points a frame (5 n log2 n each)
    flops += V * 3 * 5 * 1024 * 10
    if vb:
        flops += V * 20 * F                      # the SPP tracker
    else:
        flops += it * (U * 6 * K * F + V * 10 * K)    # W, H, g updates
    return {"k1": k1, "k2": k2, "flops": flops}
