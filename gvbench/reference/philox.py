"""The chains' random streams as the algorithm defines them on the card:
Philox4x32-10 keyed on the chain's 64-bit seed, one counter (frame, step,
draw group, utterance) per four proposal normals (two Box-Muller pairs) and
one (frame, step, 2^32 - 1, utterance) per accept uniform. On the CPU the
program draws its streams from a `torch.Generator` seeded with the chain's
seed, normals first; :func:`streams` follows whichever the device uses.

Integers are held in int64 tensors: a 32 x 32-bit product is split into
16-bit halves so that nothing overflows.
"""

import math

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m):
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    hi = ((p1 >> 16) + p2) >> 16
    lo = (p1 + ((p2 & 0xFFFF) << 16)) & MASK
    return hi, lo


def philox4x32_10(c, k0, k1):
    """c: four int64 tensors (or ints) of 32-bit counters; k0, k1 the key.
    Returns the four 32-bit outputs."""
    c0, c1, c2, c3 = (torch.as_tensor(v, dtype=torch.int64) for v in c)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def uniform01(x):
    """24 random bits -> a float uniform strictly inside (0, 1) (exact in
    float32), as float64."""
    return (x >> 8).to(torch.float64) * 2.0**-24 + 2.0**-25


def philox_streams(seed, B, N, L, n_steps, device):
    """(Zn (B, n_steps, N, L), U (B, n_steps, N)) float32 of the card's
    chain for `seed`."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & MASK, seed >> 32
    i64 = dict(dtype=torch.int64, device=device)
    Q = (L + 3) // 4
    b = torch.arange(B, **i64)[:, None, None, None]
    m = torch.arange(n_steps, **i64)[None, :, None, None]
    n = torch.arange(N, **i64)[None, None, :, None]
    q = torch.arange(Q, **i64)[None, None, None, :]
    shape = (B, n_steps, N, Q)
    r = philox4x32_10((n.expand(shape), m.expand(shape), q.expand(shape),
                       b.expand(shape)), k0, k1)
    ra = torch.sqrt(-2.0 * torch.log(uniform01(r[0]).float()).double())
    rb = torch.sqrt(-2.0 * torch.log(uniform01(r[2]).float()).double())
    ta = math.pi * (2.0 * uniform01(r[1]))
    tb = math.pi * (2.0 * uniform01(r[3]))
    zn = torch.stack([ra * torch.cos(ta), ra * torch.sin(ta),
                      rb * torch.cos(tb), rb * torch.sin(tb)], dim=-1)
    zn = zn.reshape(B, n_steps, N, 4 * Q)[..., :L].float()
    r = philox4x32_10((n[..., 0].expand(B, n_steps, N),
                       m[..., 0].expand(B, n_steps, N), MASK,
                       b[..., 0].expand(B, n_steps, N)), k0, k1)
    return zn, uniform01(r[0]).float()


def streams(seed, B, N, L, n_steps, device):
    """The chain's streams on `device`: the card's Philox draws, or on the
    CPU the generator draws of the program's CPU path."""
    device = torch.device(device)
    if device.type == "cuda":
        return philox_streams(seed, B, N, L, n_steps, device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    zn = torch.randn((B, n_steps, N, L), generator=gen)
    u = torch.rand((B, n_steps, N), generator=gen)
    return zn, u
