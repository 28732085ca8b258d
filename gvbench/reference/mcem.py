"""One Metropolis-Hastings chain over the VAE latent and the NMF / gain
M-step of MCEM (Sadeghi and Alameda-Pineda, arXiv:2102.06454; SURVEY
section 2.4), written out in plain PyTorch, frames-major: X2, Vs, Vb
(B, N, F); Z (B, N, L); g, mask (B, N); Wt (B, K, F); H (B, K, N).

Chain: Vx = max(g Vs + Vb, 1e-10); the data term of a frame is
sum_f log Vx + X2 / Vx; a proposal Zp = Z + sqrt(var) n is accepted where
log u < (s - sp) + (|Z|^2 - |Zp|^2) / 2. After the burn-in Vs is decode(Z)
again, and each later step dumps Vs (E-mode) or adds Vb / Vx and 1 - Vb / Vx
(WF-mode).
"""

import torch

from .nets import decode
from .precision import cast, dtype, mm

VX_FLOOR = 1e-10


def bmm(a, b, prec):
    return mm(a, b, prec)


def noise_var(Wt, H, prec):
    """Vb = (W H)^T, frames-major (B, N, F)."""
    return bmm(H.transpose(1, 2), Wt, prec)


def chain(p, X2, Vb, g, ypre, Z, Vs, zn, u, mode, nsamples, burnin,
          sqrt_var, prec):
    """Returns dict(Z, Vs, and samples (B, R, N, F), s1, s2 in 'e' mode or
    ws, wn in 'wf' mode). Every input is cast to the precision's dtype."""
    if burnin < 1:
        raise ValueError("the chain needs a burn-in")
    X2, Vb, g, ypre, Z, Vs, zn = (cast(t, prec) for t in
                                  (X2, Vb, g, ypre, Z, Vs, zn))
    logu = torch.log(u.to(torch.float64)).to(dtype(prec))
    G = g[..., None]

    def mix(vs):
        return torch.clamp_min(G * vs + Vb, VX_FLOOR)

    def rowsum(vx):
        return torch.sum(torch.log(vx) + X2 / vx, dim=-1)

    s = rowsum(mix(Vs))
    acc1 = torch.zeros_like(X2)
    acc2 = torch.zeros_like(X2)
    samples = []
    for m in range(nsamples + burnin):
        Zp = Z + sqrt_var * zn[:, m]
        Vsp = decode(p, Zp, ypre)
        Vxp = mix(Vsp)
        sp = rowsum(Vxp)
        ok = logu[:, m] < (s - sp) + 0.5 * torch.sum(Z * Z - Zp * Zp, dim=-1)
        Z = torch.where(ok[..., None], Zp, Z)
        s = torch.where(ok, sp, s)
        if m < burnin:
            if m == burnin - 1:
                Vs = decode(p, Z, ypre)
            continue
        Vs = torch.where(ok[..., None], Vsp, Vs)
        inv = 1.0 / mix(Vs)
        if mode == "wf":
            acc2 = acc2 + Vb * inv
            acc1 = acc1 + (1.0 - Vb * inv)
        else:
            samples.append(Vs)
            acc1 = acc1 + inv
            acc2 = acc2 + inv * inv
    out = {"Z": Z, "Vs": Vs}
    if mode == "wf":
        out.update(ws=acc1, wn=acc2)
    else:
        out.update(samples=torch.stack(samples, dim=1), s1=acc1, s2=acc2)
    return out


def _inv(samples, g, Vb):
    return 1.0 / torch.clamp_min(g[:, None, :, None] * samples
                                 + Vb[:, None], VX_FLOOR)


def w_sums(samples, Wt, H, g, X2, mask, prec):
    """The W update's sums over an E chain's dumps: (numW, denW) (B, K, F),
    sum_n H (X2 sum_r Vx^-2) and sum_n H sum_r Vx^-1 over valid frames."""
    samples, Wt, H, g, X2, mask = (cast(t, prec) for t in
                                   (samples, Wt, H, g, X2, mask))
    inv = _inv(samples, g, noise_var(Wt, H, prec))
    m3 = mask[..., None]
    s1 = torch.sum(inv, dim=1)
    s2 = torch.sum(inv * inv, dim=1)
    return bmm(H, X2 * s2 * m3, prec), bmm(H, s1 * m3, prec)


def _g_update(samples, g, Vb, X2):
    inv = _inv(samples, g, Vb)
    num = torch.sum(X2 * torch.sum(samples * inv * inv, dim=1), dim=-1)
    den = torch.sum(samples * inv, dim=(1, 3))
    return g * torch.sqrt(num / den)


def mstep_nmf(samples, numW, denW, Wt, H, g, X2, prec):
    """W from the chain's sums, then H, the columns' L1 normalisation and
    g, as one EM iteration of the NMF noise model. Returns (Wt, H, g)."""
    samples, numW, denW, Wt, H, g, X2 = (
        cast(t, prec) for t in (samples, numW, denW, Wt, H, g, X2))
    Wt2 = Wt * torch.sqrt(numW / denW)
    inv = _inv(samples, g, noise_var(Wt2, H, prec))
    s1 = torch.sum(inv, dim=1)
    s2 = torch.sum(inv * inv, dim=1)
    numH = bmm(X2 * s2, Wt2.transpose(1, 2), prec)          # (B, N, K)
    denH = bmm(s1, Wt2.transpose(1, 2), prec)
    H2 = H * torch.sqrt(numH / denH).transpose(1, 2)
    norm = torch.sum(torch.abs(Wt2), dim=2)                 # (B, K)
    Wt3 = Wt2 / norm[..., None]
    H3 = H2 * norm[..., None]
    return Wt3, H3, _g_update(samples, g, noise_var(Wt3, H3, prec), X2)


def mstep_vb(samples, g, Vb, X2, prec):
    """The gain update at a fixed noise variance. Returns g."""
    samples, g, Vb, X2 = (cast(t, prec) for t in (samples, g, Vb, X2))
    return _g_update(samples, g, Vb, X2)
