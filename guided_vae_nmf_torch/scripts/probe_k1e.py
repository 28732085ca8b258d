"""K1e's design on the card: where a step's time goes, by clock64()
stamps, and each design choice against the variant that undoes it, at the
main path's B=4, N=384 on the three decoders K1e takes at F=513 (those of
`dgm_init` h_dim (256, 128), 128 x 4 and (256, 256), seeded as
`chip_smoke.py` seeds them), MCEMConfig()'s chains, E and WF, NMF form.

The stamps and the variants run on copies of `csrc/mh_chain_ext.cu` that
this script writes into the kernels' build directory and builds with the
package's nvcc flags; the package's own library is not touched. The
stamped copy reads clock64() around each phase of a step (thread 0 of
each CTA, summed over the steps of a launch, averaged over CTAs). The
variant copies each undo one choice:

- `no_tail`: the last 1-3 columns of a rank's slice (F=513 leaves 64 + 1
  or 128 + 1 a rank) taken by full 4-column items, as the cluster form
  takes them;
- `nt64`: blocks of at least 64 threads (the cluster form's) in place of
  256;
- `cl16`: 16-CTA clusters (non-portable) for the two decoders that run on
  8;

and 128 x 4 on 8-CTA clusters, where 4 fit, needs no copy. Every variant
is first held against the plain version (Z equal under decisive noise,
the rest within atol 2e-5 / rtol 2e-4); times are CUDA-event ms a launch,
two rounds in alternating order, beside K1g (a plan's `form="general"`).
Each run's decoder is planned (`mh_chain.plan_chain`) at the variant's
clusters before its first launch, by `chip_smoke.run_chain`. Last, the
shipped M2's decoder on K1e's 4-CTA clusters beside the cluster form
(K1a) that runs it.

Usage: python3 -m guided_vae_nmf_torch.scripts.probe_k1e [--out <json>]
Prints one JSON line: the card, its power limit, the launch geometries,
the checks, the ms and the stamps.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

# (dgm_init h_dim, chip_smoke's seed offset) of the decoders K1e takes
DECODERS = (((256, 128), 20), ((128,) * 4, 21), ((256, 256), 22))
PHASES = ("propose", "hidden layers", "output layer", "data term",
          "barrier and draws", "accept", "updates", "hidden compute",
          "hidden barriers")
TOL = dict(atol=2e-5, rtol=2e-4)


def _sub(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"mh_chain_ext.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def stamped(src):
    """The source with clock64() stamps: phases 0-6 of mh_step in order,
    7 and 8 the hidden layers' compute and barrier waits."""
    return _sub(src, [
        ('#include "chain_common.cuh"\n', '''#include "chain_common.cuh"

__device__ unsigned long long g_stamp[4096][10];
__device__ __forceinline__ void stamp(int k, long long& t) {
  const long long n = clock64();
  if (threadIdx.x == 0 && blockIdx.x < 4096)
    atomicAdd(&g_stamp[blockIdx.x][k], (unsigned long long)(n - t));
  t = n;
}
'''),
        ('''  int hsl = unit_slice(p.hw[0], CL);
  hidden_layer<RND, RND>''', '''  long long th = clock64();
  int hsl = unit_slice(p.hw[0], CL);
  hidden_layer<RND, RND>'''),
        ('''                         rank * hsl, CL);
  cluster_arrive();
  if (prior) latent_prior_terms(sm.z, sm.zp, p.L, sm.dz, nw);
  cluster_wait();''', '''                         rank * hsl, CL);
  stamp(7, th);
  cluster_arrive();
  if (prior) latent_prior_terms(sm.z, sm.zp, p.L, sm.dz, nw);
  cluster_wait();
  stamp(8, th);'''),
        ('''    w += kin * hsp + hsp;
    cluster_arrive();
    cluster_wait();''', '''    w += kin * hsp + hsp;
    stamp(7, th);
    cluster_arrive();
    cluster_wait();
    stamp(8, th);'''),
        ('''  propose(p, sm);
  __syncthreads();
  float v[CC][FG];
  out_layer<OPTS>(p, g, sm,
                  decoder_hidden<OPTS>(p, sm, sm.zp, rank, g.nw, true), ps,
                  v);''', '''  long long ts = clock64();
  propose(p, sm);
  __syncthreads();
  stamp(0, ts);
  float v[CC][FG];
  const float* hs = decoder_hidden<OPTS>(p, sm, sm.zp, rank, g.nw, true);
  stamp(1, ts);
  out_layer<OPTS>(p, g, sm, hs, ps, v);
  stamp(2, ts);'''),
        ('''    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw, p.CL);
  }
  cluster_arrive();
  if (m + 1 < p.n_steps) draw<OPTS>(p, sm, fr, m + 1);
  cluster_wait();''', '''    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw, p.CL);
  }
  stamp(3, ts);
  cluster_arrive();
  if (m + 1 < p.n_steps) draw<OPTS>(p, sm, fr, m + 1);
  cluster_wait();
  stamp(4, ts);'''),
        ('''    if (accept) sm.s[t] = sp;
  }
  __syncthreads();''', '''    if (accept) sm.s[t] = sp;
  }
  __syncthreads();
  stamp(5, ts);'''),
        ('''    sample_update<MODE, OPTS>(p, g, sm, bn, fr, c0, ps, r, v, vs, inv);
}''', '''    sample_update<MODE, OPTS>(p, g, sm, bn, fr, c0, ps, r, v, vs, inv);
  stamp(6, ts);
}'''),
        ('extern "C" {\n', '''extern "C" {

int gvnmf_ext_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}

int gvnmf_ext_stamps_reset() {
  static unsigned long long zero[4096 * 10];
  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
''')])


VARIANTS = {
    "no_tail": [("const int nqf = g.Fsl / CC,", "const int nqf = g.nq,")],
    "nt64": [("constexpr int MIN_NT = 256;", "constexpr int MIN_NT = 64;")],
    "cl16": [("bool valid_cluster(int CL) { return CL == 4 || CL == 8; }",
              "bool valid_cluster(int CL) { return CL == 4 || CL == 8 || "
              "CL == 16; }"),
             ('''  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);''',
              '''  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);''')],
}


def build_copies(_build):
    """Write and build the stamped copy and the variants, one nvcc each,
    all started together. Returns {name: library}."""
    src = (_build.CSRC / "mh_chain_ext.cu").read_text()
    out = _build.build_dir() / "probe_k1e"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"stamp": stamped(src)}
    sources.update({k: _sub(src, v) for k, v in VARIANTS.items()})
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise _build.KernelError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_k1e needs an NVIDIA GPU")
    import chip_smoke as cs
    from guided_vae_nmf_torch import _build
    from guided_vae_nmf_torch.mcem import MCEMConfig, mh_chain, mh_chain_ref
    mc = sys.modules["guided_vae_nmf_torch.mcem.mh_chain"]

    dev = torch.device("cuda", 0)
    _build.build_all()
    libs = {"k1e": _build.library("mh_chain_ext"), **build_copies(_build)}
    cfg = MCEMConfig()
    B, N, K = 4, 384, cfg.nmf_rank
    chains = {"e": (cfg.nsamples_E_step, cfg.burnin_E_step),
              "wf": (cfg.nsamples_WF, cfg.burnin_WF)}
    own_packed, own_clusters = mc._ext_packed, mc.EXT_CLUSTERS
    # (variant, library, clusters, decoders it applies to)
    runs = [("k1e", "k1e", own_clusters, None),
            ("no_tail", "no_tail", own_clusters, None),
            ("nt64", "nt64", own_clusters, None),
            ("cl16", "cl16", (16,), ((128, 256), (256, 256))),
            ("cl8", "k1e", (8,), ((128,) * 4,))]

    def use(lib_name, clusters):
        _build._libs["mh_chain_ext"] = libs[lib_name]
        mc.EXT_CLUSTERS = clusters
        # the nt64 copy carves another block than the wrapper's mirror
        mc._ext_packed = own_packed if lib_name != "nt64" else (
            lambda F, L, ws, K_, cl: mc._lib_ext().gvnmf_mh_chain_ext_packed(
                F, L, mc._ints(ws), len(ws), cl))

    cases = {}
    for h_dim, off in DECODERS:
        m = cs.domain_model(torch, h_dim, off, dev)
        c = cs.chain_inputs(torch, m, B, N, K, 7, dev)
        cases[mc.widths(c["dec_w"])] = c
    rec = {"gpu": cs.gpu_name_and_limit(), "geometry": {}, "checks": {},
           "ms": {}, "stamps": {}}
    for name, lib, clusters, only in runs:
        use(lib, clusters)
        for ws, c in cases.items():
            if only is not None and ws not in only:
                continue
            geo = mc.ext_geometry(513, 32, ws, K, dev)
            geo["waves"] = -(-B * (N // 32) // geo["max_active_clusters"])
            rec["geometry"][f"{name} {ws}"] = geo
            c.pop("plans", None)        # planned anew at these clusters
            for mode, (ns, bi) in chains.items():
                noise = cs.decisive_noise(torch, 12, B, N, c["L"], ns + bi,
                                          dev)
                got = cs.run_chain(c, mh_chain, mode, ns, bi, 0.01,
                                   noise=noise, form="ext")
                ref = cs.run_chain(c, mh_chain_ref, mode, ns, bi, 0.01,
                                   noise=noise)
                past = [int(((x - y).abs() > TOL["atol"] + TOL["rtol"]
                             * y.abs()).sum())
                        for x, y in zip((got[1],) + got[2],
                                        (ref[1],) + ref[2])]
                ok = torch.equal(got[0], ref[0]) and not any(past)
                rec["checks"][f"{name} {ws} {mode}"] = ok
                if not ok:
                    raise SystemExit(f"{name} {ws} {mode}: disagrees with "
                                     f"the plain version ({past})")
    for rnd in range(2):
        order = runs if rnd == 0 else runs[::-1]
        for ws, c in cases.items():
            for mode, (ns, bi) in chains.items():
                def time(**kw):
                    return cs.time_cuda(lambda: cs.run_chain(
                        c, mh_chain, mode, ns, bi, cfg.var_RW, seed=1, **kw))

                row = rec["ms"].setdefault(f"{ws} {mode}", {})
                row.setdefault("k1g", []).append(time(form="general"))
                for name, lib, clusters, only in order:
                    if only is not None and ws not in only:
                        continue
                    use(lib, clusters)
                    c.pop("plans", None)
                    row.setdefault(name, []).append(time(form="ext"))
    use("stamp", own_clusters)
    stamps = libs["stamp"]
    stamps.gvnmf_ext_stamps.argtypes = [ctypes.c_void_p]
    for ws, c in cases.items():
        cl = mc.ext_cluster(513, 32, ws, K)
        c.pop("plans", None)
        for mode, (ns, bi) in chains.items():
            stamps.gvnmf_ext_stamps_reset()
            cs.run_chain(c, mh_chain, mode, ns, bi, cfg.var_RW, seed=1,
                         form="ext")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (4096 * 10))()
            _build.check(stamps.gvnmf_ext_stamps(buf), "stamps")
            a = np.frombuffer(buf, dtype=np.uint64).reshape(4096, 10)
            per = a[:B * (N // 32) * cl, :9].astype(np.float64) / (ns + bi)
            mean = per.mean(axis=0)
            rec["stamps"][f"{ws} {mode}"] = dict(
                cluster=cl, cycles_a_step=float(mean[:7].sum()),
                **{p: float(v) for p, v in zip(PHASES, mean)})
    use("k1e", own_clusters)
    from guided_vae_nmf_torch.train import load_model

    shipped = load_model(str(_build.CSRC.parent.parent / "artifacts"
                             / "pretrained" / "M2_ibm"), kind="dgm",
                         y_dim=513, device=dev)
    c = cs.chain_inputs(torch, shipped, B, N, K, 7, dev)
    for rnd in range(2):
        for mode, (ns, bi) in chains.items():
            row = rec["ms"].setdefault(f"shipped {mode}", {})
            for form in (("cluster", "ext") if rnd == 0
                         else ("ext", "cluster")):
                row.setdefault(form, []).append(cs.time_cuda(
                    lambda: cs.run_chain(c, mh_chain, mode, ns, bi,
                                         cfg.var_RW, seed=1, form=form)))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return rec


if __name__ == "__main__":
    main()
