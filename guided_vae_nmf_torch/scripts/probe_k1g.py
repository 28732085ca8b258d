"""Where a step of K1g, the chain's general form, spends its time on the
card, by clock64() stamps, at the main path's B=4, N=384 with
MCEMConfig()'s E chain (NMF form), on the (512, 512) decoder (the M2 of
`dgm_init` h_dim (512, 512), which no cluster holds) and the (128, 256)
one (h_dim (256, 128), forced onto K1g by a plan's `form="general"`),
seeded as `chip_smoke.py` seeds them.

The stamps run on a copy of a checkout's `csrc/mh_chain_general.cu` that
this script writes into that checkout's build directory and builds with
its nvcc flags; the checkout's own library is not touched. Thread 0 of
each CTA reads clock64() at the end of each phase and adds the cycles
since the last stamp to that phase: the proposal and prior term, each
hidden layer, the output layer's sums, its data term (exp, log, the
partials), the waits for weights in the ring (the streaming kernel only),
the CTA's barrier waits, the accept test and draws, the updates, and the
work outside the steps. Cycles are summed over a launch, averaged over
CTAs and divided by the chain's steps (the phase boundary's decode falls
on the hidden layers and "outside"). The copy is first held against the
plain version (Z equal under decisive noise, the rest within atol 2e-5 /
rtol 2e-4). Both layouts of the source are known: the streaming kernel
and the earlier one that read its weights from L2 (a parent checkout's).

For the streaming kernel the script also builds design variants, each a
copy that changes one choice (with the wrapper's mirror of the geometry
set to match): `slot4k`, stages of 4096 floats where 8192 fit;
`stages3`, a ring of 3 stages in place of 4; `cols8`, register tiles of
8 units x 8 frames in place of 4 x 8. Each is
held against the plain
version like the stamped copy, then timed beside the kernel (CUDA-event
ms a launch, E and WF, two rounds in alternating order).

Usage: python3 guided_vae_nmf_torch/scripts/probe_k1g.py
       [--tree <checkout root>] [--out <json>]
Prints one JSON line: the card, its power limit, the checkout, the
checks, the ms and the stamps.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

# (dgm_init h_dim, chip_smoke's seed offset in times_domain)
DECODERS = (((512, 512), 23), ((256, 128), 20))
PHASES = ("propose", "hidden 1", "hidden 2", "hidden 3", "hidden 4",
          "output layer", "data term", "weight waits", "barrier waits",
          "accept and draws", "updates", "outside steps")
TOL = dict(atol=2e-5, rtol=2e-4)

PRELUDE = '''#include "chain_common.cuh"

__device__ unsigned long long g_stamp[4096][12];
__shared__ unsigned long long st_acc[12];
__shared__ long long st_last;
__shared__ int st_cur;
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    const long long n = clock64();
    st_acc[k] += (unsigned long long)(n - st_last);
    st_last = n;
  }
}
__device__ __forceinline__ void stamp_begin() {
  if (threadIdx.x == 0) {
    for (int k = 0; k < 12; ++k) st_acc[k] = 0;
    st_cur = 11;
    st_last = clock64();
  }
}
__device__ __forceinline__ void stamp_end() {
  if (threadIdx.x == 0 && blockIdx.x < 4096)
    for (int k = 0; k < 12; ++k) g_stamp[blockIdx.x][k] = st_acc[k];
}
'''

EXPORTS = '''extern "C" {

int gvnmf_k1g_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
'''

# the streaming kernel: stamps around the ring's waits, each layer, the
# barriers and the step's phases
STREAMING = [
    ('#include "chain_common.cuh"\n', PRELUDE),
    ('extern "C" {\n', EXPORTS),
    ('''      mbar_wait(sm.full + s, (j / STAGES) & 1);
      if (on) {''', '''      stamp(st_cur);
      mbar_wait(sm.full + s, (j / STAGES) & 1);
      stamp(7);
      if (on) {'''),
    ('''    if (on) epi(q, fg * FG, a);''', '''    stamp(st_cur);
    if (on) epi(q, fg * FG, a);
    stamp(st_cur == 5 ? 6 : st_cur);'''),
    ('''    const Layer l = layer_geo(p, d);
    const float* bias''', '''    if (threadIdx.x == 0) st_cur = 1 + d;
    const Layer l = layer_geo(p, d);
    const float* bias'''),
    ('''    consumers_sync(p.nc);
    src = dst;''', '''    stamp(1 + d);
    consumers_sync(p.nc);
    stamp(8);
    src = dst;'''),
    ('''  consumers_sync(nc);
  latent_prior_terms(p, sm);
  const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.zp);''',
     '''  stamp(0);
  consumers_sync(nc);
  stamp(8);
  latent_prior_terms(p, sm);
  stamp(0);
  const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.zp);
  if (threadIdx.x == 0) st_cur = 5;'''),
    ('''  consumers_sync(nc);                   // red and dz complete; zn read''',
     '''  stamp(6);
  consumers_sync(nc);                   // red and dz complete; zn read
  stamp(8);'''),
    ('''  if (m + 1 < p.n_steps) draw(p, sm, tl, m + 1);
  consumers_sync(nc);                   // acc complete''',
     '''  if (m + 1 < p.n_steps) draw(p, sm, tl, m + 1);
  stamp(9);
  consumers_sync(nc);                   // acc complete
  stamp(8);'''),
    ('''  consumers_sync(nc);                   // z updated before the next proposal
}''', '''  stamp(10);
  consumers_sync(nc);                   // z updated before the next proposal
  stamp(8);
}'''),
    ('''    if (tid == nc) produce(p, sm);
    return;
  }
''', '''    if (tid == nc) produce(p, sm);
    return;
  }
  stamp_begin();
'''),
    ('''  uint32_t j = 0;                       // ring stages consumed''',
     '''  stamp(11);
  uint32_t j = 0;                       // ring stages consumed'''),
    ('''    const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.z);''',
     '''    const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.z);
    if (threadIdx.x == 0) st_cur = 11;'''),
    ('''  consumers_sync(nc);                   // the activations are read''',
     '''  stamp(11);
  consumers_sync(nc);                   // the activations are read
  stamp(8);'''),
    ('''      p.part2[po] = den;
    }
  }
}''', '''      p.part2[po] = den;
    }
  }
  stamp(11);
  stamp_end();
}'''),
]

# the earlier kernel (weights by __ldg from L2, one CTA a 16-frame tile)
FROM_L2 = [
    ('#include "chain_common.cuh"\n', PRELUDE),
    ('extern "C" {\n', EXPORTS),
    ('''  hidden_layer<RND, RND>(zin, p.L, p.w1, p.hw[0], nullptr, sm.ypre, sm.hA);
  __syncthreads();''', '''  hidden_layer<RND, RND>(zin, p.L, p.w1, p.hw[0], nullptr, sm.ypre, sm.hA);
  stamp(1);
  __syncthreads();
  stamp(8);'''),
    ('''                             p.bm[d - 1], nullptr, dst);
    __syncthreads();''', '''                             p.bm[d - 1], nullptr, dst);
    stamp(1 + d);
    __syncthreads();
    stamp(8);'''),
    ('''  __syncthreads();
  latent_prior_terms(p, sm);
  const float* hsrc = decoder_hidden(p, sm, sm.zp);''', '''  stamp(0);
  __syncthreads();
  stamp(8);
  latent_prior_terms(p, sm);
  stamp(0);
  const float* hsrc = decoder_hidden(p, sm, sm.zp);'''),
    ('''    out_item(p, hsrc, mi, v);
    item_terms(p, sm, tl, mi, v, nq);''', '''    out_item(p, hsrc, mi, v);
    stamp(5);
    item_terms(p, sm, tl, mi, v, nq);
    stamp(6);'''),
    ('''  __syncthreads();                      // red and dz complete; zn read''',
     '''  stamp(6);
  __syncthreads();                      // red and dz complete; zn read
  stamp(8);'''),
    ('''  if (m + 1 < p.n_steps) draw(p, sm, tl, m + 1);
  __syncthreads();                      // acc complete''',
     '''  if (m + 1 < p.n_steps) draw(p, sm, tl, m + 1);
  stamp(9);
  __syncthreads();                      // acc complete
  stamp(8);'''),
    ('''  __syncthreads();                      // z updated before the next proposal
}''', '''  stamp(10);
  __syncthreads();                      // z updated before the next proposal
  stamp(8);
}'''),
    ('''  const int h1 = p.hw[0];
''', '''  const int h1 = p.hw[0];
  stamp_begin();
'''),
    ('''  for (int m = 0; m < p.burnin; ++m) mh_step<MODE, false>(p, sm, tl, m, 0);''',
     '''  stamp(11);
  for (int m = 0; m < p.burnin; ++m) mh_step<MODE, false>(p, sm, tl, m, 0);'''),
    ('''  __syncthreads();                      // the activations are read''',
     '''  stamp(11);
  __syncthreads();                      // the activations are read
  stamp(8);'''),
    ('''      p.part2[po] = den;
    }
  }
}''', '''      p.part2[po] = den;
    }
  }
  stamp(11);
  stamp_end();
}'''),
]


def _sub(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"mh_chain_general.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def stamped(src):
    """The source with clock64() stamps, for either layout."""
    return _sub(src, STREAMING if "produce(p, sm)" in src else FROM_L2)


# design variants of the streaming kernel, each undoing or changing one
# choice, with the wrapper's mirror of the geometry set to match
VARIANTS = {
    "slot4k": ([("constexpr int SLOT_BIG = 8192;",
                 "constexpr int SLOT_BIG = 4096;")],
               dict(GEN_SLOTS=(4096, 4096))),
    "stages3": ([("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
                dict(GEN_STAGES=3)),
    "cols8": ([("constexpr int CC = 4;", "constexpr int CC = 8;")],
              dict(GEN_COLS=8)),
}


def build_copies(_build, variants):
    """Write and build the stamped copy of the checkout's K1g and, for the
    streaming kernel, its `variants`, one nvcc each, all started together.
    Returns ({name: library}, the stamped copy's nvcc output)."""
    src = (_build.CSRC / "mh_chain_general.cu").read_text()
    out = _build.build_dir() / "probe_k1g"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"stamp": stamped(src)}
    sources.update({k: _sub(src, VARIANTS[k][0]) for k in variants})
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise _build.KernelError(f"nvcc failed for {name}:\n"
                                     f"{logs[name]}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs, logs


def _held(torch, run, ref_run, noise):
    """Z equal to the plain version's under decisive noise and the rest
    within TOL: the number of elements past TOL per output."""
    got, ref = run(noise), ref_run(noise)
    past = [int(((x - y).abs() > TOL["atol"] + TOL["rtol"] * y.abs()).sum())
            for x, y in zip((got[1],) + got[2], (ref[1],) + ref[2])]
    return torch.equal(got[0], ref[0]) and not any(past), past


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k1g needs an NVIDIA GPU")
    import chip_smoke as cs
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig, mh_chain, mh_chain_ref
    mc = sys.modules["guided_vae_nmf_torch.mcem.mh_chain"]

    dev = torch.device("cuda", 0)
    streaming = hasattr(mc, "pack_general")
    _build.build_all()
    libs, logs = build_copies(_build, list(VARIANTS) if streaming else [])
    libs["k1g"] = _build.library("mh_chain_general")
    mirror = {k: getattr(mc, k) for k in ("GEN_STAGES", "GEN_SLOTS",
                                          "GEN_COLS") if hasattr(mc, k)}

    def use(name):
        _build._libs["mh_chain_general"] = libs[name]
        for k, v in dict(mirror, **VARIANTS.get(name, ((), {}))[1]).items():
            setattr(mc, k, v)

    cfg = MCEMConfig()
    B, N, K = 4, 384, cfg.nmf_rank
    chains = {"e": (cfg.nsamples_E_step, cfg.burnin_E_step),
              "wf": (cfg.nsamples_WF, cfg.burnin_WF)}
    rec = {"gpu": cs.gpu_name_and_limit(), "tree": tree,
           "ptxas": {k: cs.ptxas_report(v) for k, v in logs.items()},
           "checks": {}, "ms": {}, "stamps": {}}
    cases = {}
    for h_dim, off in DECODERS:
        m = cs.domain_model(torch, h_dim, off, dev)
        c = cs.chain_inputs(torch, m, B, N, K, 7, dev)
        if streaming and not hasattr(mc, "plan_chain"):
            # a checkout before the plan: K1g's block packed once here
            c["dec_w"] = mc.pack_general(c["dec_w"])
        cases[mc.widths(c["dec_w"])] = c
    # every copy against the plain version, E and WF
    for name in ("stamp", *(VARIANTS if streaming else ())):
        use(name)
        for ws, c in cases.items():
            for mode, (ns, bi) in chains.items():
                noise = cs.decisive_noise(torch, 12, B, N, c["L"], ns + bi,
                                          dev)
                ok, past = _held(
                    torch,
                    lambda nz: cs.run_chain(c, mh_chain, mode, ns, bi, 0.01,
                                            noise=nz, form="general"),
                    lambda nz: cs.run_chain(c, mh_chain_ref, mode, ns, bi,
                                            0.01, noise=nz), noise)
                rec["checks"][f"{name} {ws} {mode}"] = ok
                if not ok:
                    raise SystemExit(f"{name} K1g {ws} {mode}: disagrees "
                                     f"with the plain version ({past})")
    # the variants beside the kernel, two rounds in alternating order
    names = ["k1g", *(VARIANTS if streaming else ())]
    for rnd in range(2):
        for ws, c in cases.items():
            for mode, (ns, bi) in chains.items():
                row = rec["ms"].setdefault(f"{ws} {mode}", {})
                for name in (names if rnd == 0 else names[::-1]):
                    use(name)
                    row.setdefault(name, []).append(cs.time_cuda(
                        lambda: cs.run_chain(c, mh_chain, mode, ns, bi,
                                             cfg.var_RW, seed=1,
                                             form="general")))
    use("stamp")
    lib = libs["stamp"]
    lib.gvnmf_k1g_stamps.argtypes = [ctypes.c_void_p]
    ns, bi = chains["e"]
    for ws, c in cases.items():
        cs.run_chain(c, mh_chain, "e", ns, bi, cfg.var_RW, seed=1,
                     form="general")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4096 * 12))()
        _build.check(lib.gvnmf_k1g_stamps(buf), "stamps")
        a = np.frombuffer(buf, dtype=np.uint64).reshape(4096, 12)
        tile = mc.general_tile(513, c["L"], ws, K) if streaming else 16
        per = a[:B * (N // tile)].astype(np.float64) / (ns + bi)
        mean = per.mean(axis=0)
        step = float(mean[:11].sum())
        rec["stamps"][str(ws)] = dict(
            frames=tile, ctas=B * (N // tile), cycles_a_step=step,
            outside_a_step=float(mean[11]),
            cycles={p: float(v) for p, v in zip(PHASES, mean)},
            share={p: float(v / step) for p, v in zip(PHASES[:11],
                                                       mean[:11])})
    use("k1g")
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return rec


if __name__ == "__main__":
    main()
