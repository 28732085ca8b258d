// One-pass NMF M-step sums over the MH sample buffer (K2).
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: nmf_sums_pallas (body
// _make_sums_kernel), modes 'h' and 'g', with the NMF factors (WH=, K2a) or
// a given noise variance (Vb=, K2b), over float32 samples in exact math or,
// in fast mode (K2c), over the chain's bfloat16 sample dumps (converted
// with __bfloat162float) with every 1/Vx from the hardware approximate
// reciprocal (rcp.approx, within 1 ulp) and each product feeding a sum as
// one FMA. The sample type and the reciprocal are template parameters, so
// the exact kernels carry none of it.
//
// With Vb = H^T Wt (K2a) or the (B, N, F) input (K2b) and
// inv_r = 1 / max(g Vs_r + Vb, 1e-10) over the R samples of a frame:
//   'h', WH: numH[k] = sum_f X2 (sum_r inv_r^2) Wt[k, f],
//            denH[k] = sum_f (sum_r inv_r) Wt[k, f]        -> (B, N, K) x2
//   'h', Vb: s1 = sum_r inv_r, s2 = sum_r inv_r^2           -> (B, N, F) x2
//   'g':     num = sum_f X2 sum_r Vs_r inv_r^2,
//            den = sum_{r, f} Vs_r inv_r                     -> (B, N) x2
//
// What bounds it on an H100: bytes, once the issue of ~15 instructions a
// sample keeps up. A frame reads R F samples plus F of X2 (and F of Vb in
// the Vb form), so the kernel is a stream that has to keep about 25 KB in
// flight per SM to feed HBM at 3.35 TB/s. A warp-per-frame pass with
// scalar loads keeps a few KB in flight and, with K loads of Wt per bin,
// reaches a sixth of the rate.
//
// The design: a streaming pass with bulk asynchronous copies.
//   * The B N frames are split evenly over a grid of (CTAs an SM) x SMs
//     CTAs; a CTA walks its rows in tiles of T consecutive frames of one
//     utterance (tile_frames: 4 at F = 513). At F = 513 a CTA is 320
//     threads (9 consumer warps and a producer warp) with 33-65 KB of
//     shared memory, and the 1024-thread launch bound holds every
//     instantiation to 64 registers, so an SM holds 3 CTAs.
//   * For one tile the inputs are contiguous runs: the Vb rows (Vb form),
//     then for each r the T F samples of sample r, then the X2 rows. A
//     producer warp copies each run with one cp.async.bulk (the TMA's 1D
//     copy) into a ring of STAGES shared-memory stages, each with a full
//     and an empty mbarrier, running ahead across tiles. A run that does
//     not start or end on 16 bytes is copied with its enclosing 16-byte
//     granules and read at its offset, so any N, F and storage offset
//     stream the same way.
//   * Each consumer thread owns bins f and f + NC (NC = 32 ceil(F / 64)
//     threads, 288 at F = 513) for the T frames of every tile: it sums
//     over r in registers in order r = 0 .. R-1, with no index arithmetic
//     or branch per element. R is a loop over stages, so no R is special.
//   * Wt (K F) comes by one bulk copy once per utterance a CTA meets; g and
//     H of the next tile are prefetched during the current one. Each
//     thread forms Vb = H^T Wt for its bins, k = 0 .. K-1, every Wt value
//     serving the T frames.
//   * 'h' with Vb stores s1 and s2 from registers, coalesced. 'g' reduces
//     each frame in registers: a thread's two bins, a butterfly over the
//     warp, the warps in order. 'h' with WH writes X2 s2 (into the X2
//     stage) and s1 to shared memory and contracts with Wt by hand: per
//     segment of bins one warp, a lane per (quantity, k) summing the bins
//     in order for the tile's frames at once; the segments are added in
//     order.
// Every sum has one order that depends on F and K only, not on the tile,
// the CTA or the grid: two launches give equal outputs, and an utterance
// in a batch gives what it gives alone. No atomics.
//
// Ranks past KMAX (the WH form): nmf_sums_wide_kernel, the same stream with
// three changes, none of which a rank up to KMAX reaches. Wt (K F floats,
// past a CTA's shared memory at large K) is read through L1 / L2, not
// copied; a tile's H comes into shared memory KCH ranks at a time, and Vb
// sums each chunk's ranks in order after the last; the 'h' contraction
// runs KMAX ranks at a time, lane q KMAX + k for rank k0 + k. Each rank's
// sums keep the order the narrow kernel gives them (Vb over k in order, a
// segment's bins in order, the segments in order), and its shared memory
// does not grow with K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int KMAX = 16;                  // largest rank of the narrow
                                          // kernel; the wide one's chunk
constexpr int KCH = 64;                   // ranks of H a wide tile stages
constexpr int BPT = 2;                    // bins a consumer thread owns
constexpr int MIN_CONSUMERS = 96;         // TMAX (KMAX + 1) prefetch slots
constexpr int MAX_CONSUMERS = 992;        // + a producer warp <= 1024
constexpr int FMAX = BPT * MAX_CONSUMERS;
constexpr int TMAX = 4;                   // frames a tile
constexpr int TILE_ELEMS = 2560;          // T F at most, where T > 1
constexpr int STAGES = 4;
constexpr int SEG_BINS = 64;              // bins a reduction segment, about
constexpr int MAXSEG = 8;
constexpr int MAX_THREADS = 1024;
constexpr float VX_FLOOR = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_H = 0, MODE_G = 1 };

// The launch's shape: functions of F (and K) only.
__host__ __device__ inline int consumers(int F) {
  const int n = 32 * ((F + 2 * 32 - 1) / (2 * 32));
  return n < MIN_CONSUMERS ? MIN_CONSUMERS : n;
}

__host__ __device__ inline int tile_frames(int F) {
  const int t = TILE_ELEMS / F;
  return t < 1 ? 1 : (t > TMAX ? TMAX : t);
}

__host__ __device__ inline int segments(int F) {
  const int s = (F + SEG_BINS - 1) / SEG_BINS;
  return s < MAXSEG ? s : MAXSEG;
}

// a stage: a tile's float32 run and its enclosing 16-byte granules
__host__ __device__ inline size_t stage_bytes(int F) {
  return ((size_t)tile_frames(F) * F * 4 + 32 + 15) / 16 * 16;
}

struct Params {
  const void* samples;
  const float *vb, *wt, *h, *g, *x2;
  float *o1, *o2;
  int B, R, N, F, K;
};

// shared-memory layout (bytes from the dynamic base): the ring, Wt (its
// enclosing granules), the full / empty / Wt mbarriers and each stage's
// offset of its run, g and H of a tile,
// s1 of a tile ('h' with WH; X2 s2 stays in the X2 chunk's stage) and the
// partial sums ('h' with WH: a frame's segments; 'g': a frame's warps)
struct Layout {
  size_t stage, wts, bars, gs, hs, sc, part, total;
};

__host__ __device__ inline Layout layout(int F, int K, bool wh, int mode) {
  Layout l;
  l.stage = stage_bytes(F);
  l.wts = STAGES * l.stage;
  l.bars = l.wts + (wh ? ((size_t)K * F * 4 + 32 + 15) / 16 * 16 : 0);
  l.gs = l.bars + (2 * STAGES + 1) * sizeof(uint64_t) + STAGES * 4;
  l.hs = l.gs + TMAX * 4;
  l.sc = l.hs + (wh ? KMAX * TMAX * 4 : 0);
  const bool hwh = mode == MODE_H && wh;
  l.part = l.sc + (hwh ? (size_t)TMAX * F * 4 : 0);
  const size_t part = hwh ? (size_t)TMAX * segments(F) * 2 * K
                          : (mode == MODE_G ? (size_t)TMAX * 2 *
                             (consumers(F) / 32) : 0);
  l.total = l.part + part * 4;
  return l;
}

// the wide kernel's layout: the ring, the full / empty mbarriers and each
// stage's offset, g and a chunk of H of a tile, s1 of a tile ('h') and the
// partial sums ('h': a frame's segments for KMAX ranks; 'g': a frame's
// warps)
__host__ __device__ inline Layout layout_wide(int F, int mode) {
  Layout l;
  l.stage = stage_bytes(F);
  l.wts = STAGES * l.stage;
  l.bars = l.wts;
  l.gs = l.bars + 2 * STAGES * sizeof(uint64_t) + STAGES * 4;
  l.hs = l.gs + TMAX * 4;
  l.sc = l.hs + KCH * TMAX * 4;
  l.part = l.sc + (mode == MODE_H ? (size_t)TMAX * F * 4 : 0);
  const size_t part = mode == MODE_H ? (size_t)TMAX * segments(F) * 2 * KMAX
                                     : (size_t)TMAX * 2 * (consumers(F) / 32);
  l.total = l.part + part * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one bulk copy of [src, src + bytes) (both 16-byte aligned) into dst,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// [src, src + bytes) by its enclosing 16-byte granules; returns the offset
// of src in dst
__device__ __forceinline__ uint32_t bulk_load_any(void* dst, const void* src,
                                                  size_t bytes,
                                                  uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t beg = a & ~(uintptr_t)15;
  const uintptr_t end = (a + bytes + 15) & ~(uintptr_t)15;
  bulk_load(dst, reinterpret_cast<const void*>(beg), (uint32_t)(end - beg),
            bar);
  return (uint32_t)(a - beg);
}

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rcp.approx: at most 1 ulp from 1/x; Vx >= 1e-10 is a normal float.
// Exact: the approximation and one Newton step on the FMA, which is the
// correctly rounded reciprocal (1.0f / x bit for bit) wherever x and 1/x
// are normal, as Vx >= 1e-10 is; so no slow path (a call that would spill
// registers) is compiled.
template <bool APPROX>
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  if (APPROX) return r;
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// x y + c: rounded twice, as the plain version rounds it, in the exact
// kernels; one FMA in fast mode (APPROX), whose results are held to the
// plain version within the tolerance only.
template <bool APPROX>
__device__ __forceinline__ float mul_add(float x, float y, float c) {
  return APPROX ? fmaf(x, y, c) : __fadd_rn(__fmul_rn(x, y), c);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// A tile: `tc` frames of utterance b from frame n (global row `row`).
struct Tile {
  long long row;
  int b, n, tc;
};

__device__ __forceinline__ Tile make_tile(long long row, long long end,
                                          int T, const Params& p) {
  Tile t;
  t.row = row;
  t.b = (int)(row / p.N);
  t.n = (int)(row - (long long)t.b * p.N);
  long long tc = end - row;
  if (tc > T) tc = T;
  if (tc > p.N - t.n) tc = p.N - t.n;
  t.tc = (int)tc;
  return t;
}

// Chunk c of a tile's stream: its global start and bytes.
template <bool WH, typename S>
__device__ __forceinline__ const void* chunk(const Params& p, const Tile& t,
                                             int c, size_t* bytes) {
  const size_t run = (size_t)t.tc * p.F;
  if (!WH) {
    if (c == 0) {
      *bytes = run * 4;
      return p.vb + (size_t)t.row * p.F;
    }
    --c;
  }
  if (c < p.R) {
    *bytes = run * sizeof(S);
    return static_cast<const S*>(p.samples)
        + (((size_t)t.b * p.R + c) * p.N + t.n) * p.F;
  }
  *bytes = run * 4;
  return p.x2 + (size_t)t.row * p.F;
}

template <int MODE, bool WH, typename S, bool APPROX>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    nmf_sums_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int F = p.F, K = p.K, T = tile_frames(F);
  const Layout lo = layout(F, K, WH, MODE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;
  uint32_t* offs = reinterpret_cast<uint32_t*>(wbar + 1);
  float* gs = reinterpret_cast<float*>(smem + lo.gs);
  float* hs = reinterpret_cast<float*>(smem + lo.hs);
  float* sc1 = reinterpret_cast<float*>(smem + lo.sc);
  float* part = reinterpret_cast<float*>(smem + lo.part);

  const int nc = blockDim.x - 32, ncw = nc / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = (long long)p.B * p.N;
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  const int nchunks = (WH ? 0 : 1) + p.R + ((MODE == MODE_H && !WH) ? 0 : 1);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, ncw);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == ncw) {                       // producer
    if (lane != 0) return;
    uint32_t j = 0;
    for (long long row = r0; row < r1;) {
      const Tile t = make_tile(row, r1, T, p);
      for (int c = 0; c < nchunks; ++c, ++j) {
        size_t bytes;
        const void* src = chunk<WH, S>(p, t, c, &bytes);
        const int slot = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + slot, ((j / STAGES) + 1) & 1);
        // the run's offset in its stage, published by the arrive below
        offs[slot] = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15);
        bulk_load_any(smem + slot * lo.stage, src, bytes, full + slot);
      }
      row += t.tc;
    }
    return;
  }

  // consumers. Bins: f0 = tid and f1 = tid + nc, clamped into [0, F) for
  // loads (a clamped bin computes and is never stored or summed).
  const int f0 = tid, f1 = tid + nc;
  const bool on0 = f0 < F, on1 = f1 < F;
  const int c0 = on0 ? f0 : F - 1, c1 = on1 ? f1 : F - 1;

  // the g / H values of a tile, one a thread: slot tid holds g of frame
  // tid for tid < TMAX, else H[k][t] with tid - TMAX = k TMAX + t
  auto prefetch = [&](const Tile& t) -> float {
    if (tid < TMAX)
      return tid < t.tc ? __ldg(p.g + t.row + tid) : 0.0f;
    if (WH) {
      const int i = tid - TMAX, k = i / TMAX, fr = i - k * TMAX;
      if (k < K && fr < t.tc)
        return __ldg(p.h + ((size_t)t.b * K + k) * p.N + t.n + fr);
    }
    return 0.0f;
  };

  // Wt of utterance b: one bulk copy, by thread 0 once every consumer is
  // done with the last one
  uint32_t wt_off = 0;
  auto load_wt = [&](int b) {
    const float* src = p.wt + (size_t)b * K * F;
    wt_off = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15);
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load_any(smem + lo.wts, src, (size_t)K * F * 4, wbar);
    }
  };

  uint32_t j = 0, wphase = 0;
  int wt_b = -1;
  if (WH && r0 < r1) load_wt(make_tile(r0, r1, T, p).b);
  float pre = r0 < r1 ? prefetch(make_tile(r0, r1, T, p)) : 0.0f;
  for (long long row = r0; row < r1;) {
    const Tile t = make_tile(row, r1, T, p);
    consumers_sync(nc);                    // last tile's reads are done
    if (tid < TMAX) gs[tid] = pre;
    else if (WH && tid < TMAX * (KMAX + 1)) hs[tid - TMAX] = pre;
    if (WH && t.b != wt_b) {
      if (wt_b >= 0) load_wt(t.b);
      mbar_wait(wbar, wphase);
      wphase ^= 1;
      wt_b = t.b;
    }
    consumers_sync(nc);
    if (row + t.tc < r1) pre = prefetch(make_tile(row + t.tc, r1, T, p));
    const float* wts =
        reinterpret_cast<const float*>(smem + lo.wts + wt_off);

    // [frame][bin] of this thread; frames past tc compute and are dropped
    float vb[TMAX][BPT], a[TMAX][BPT], d[TMAX][BPT];
#pragma unroll
    for (int fr = 0; fr < TMAX; ++fr) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) a[fr][i] = d[fr][i] = vb[fr][i] = 0.0f;
    }
    if (WH) {                              // Vb = H^T Wt, k in order
      for (int k = 0; k < K; ++k) {
        const float w0 = wts[k * F + c0], w1 = wts[k * F + c1];
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          const float hk = hs[k * TMAX + fr];
          vb[fr][0] = fmaf(hk, w0, vb[fr][0]);
          vb[fr][1] = fmaf(hk, w1, vb[fr][1]);
        }
      }
    }

    int x2_slot = -1;
    float* sc0 = nullptr;                  // X2 s2, in the X2 chunk's stage
    for (int c = 0; c < nchunks; ++c, ++j) {
      const int slot = j % STAGES;
      mbar_wait(full + slot, (j / STAGES) & 1);
      unsigned char* buf = smem + slot * lo.stage + offs[slot];
      const int cs = WH ? c : c - 1;       // sample index, or -1 for Vb
      if (cs < 0) {
        const float* vp = reinterpret_cast<const float*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            vb[fr][0] = vp[fr * F + c0];
            vb[fr][1] = vp[fr * F + c1];
          }
        }
      } else if (cs < p.R) {
        const S* sp = reinterpret_cast<const S*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            const float gf = gs[fr];
            const float v[BPT] = {to_float(sp[fr * F + c0]),
                                  to_float(sp[fr * F + c1])};
#pragma unroll
            for (int i = 0; i < BPT; ++i) {
              const float vs = v[i];
              const float vx =
                  fmaxf(mul_add<APPROX>(gf, vs, vb[fr][i]), VX_FLOOR);
              const float inv = recip<APPROX>(vx);
              if (MODE == MODE_H) {
                d[fr][i] = __fadd_rn(d[fr][i], inv);                  // s1
                a[fr][i] = mul_add<APPROX>(inv, inv, a[fr][i]);       // s2
              } else {
                const float vi = __fmul_rn(vs, inv);
                a[fr][i] = mul_add<APPROX>(vi, inv, a[fr][i]);
                d[fr][i] = __fadd_rn(d[fr][i], vi);
              }
            }
          }
        }
      } else if (MODE == MODE_H) {         // X2 s2 in place, s1 beside it
        float* xp = reinterpret_cast<float*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            if (on0) {
              xp[fr * F + f0] = __fmul_rn(xp[fr * F + f0], a[fr][0]);
              sc1[fr * F + f0] = d[fr][0];
            }
            if (on1) {
              xp[fr * F + f1] = __fmul_rn(xp[fr * F + f1], a[fr][1]);
              sc1[fr * F + f1] = d[fr][1];
            }
          }
        }
        sc0 = xp;                          // released after the epilogue
        x2_slot = slot;
        continue;
      } else {                             // 'g': X2 sum Vs inv^2, per frame
        const float* xp = reinterpret_cast<const float*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            const float n0 =
                on0 ? __fmul_rn(xp[fr * F + c0], a[fr][0]) : 0.0f;
            const float n1 =
                on1 ? __fmul_rn(xp[fr * F + c1], a[fr][1]) : 0.0f;
            a[fr][0] = __fadd_rn(n0, n1);
            d[fr][0] = __fadd_rn(on0 ? d[fr][0] : 0.0f,
                                 on1 ? d[fr][1] : 0.0f);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    if (MODE == MODE_H && !WH) {           // s1, s2 (B, N, F)
#pragma unroll
      for (int fr = 0; fr < TMAX; ++fr) {
        if (fr < t.tc) {
          const size_t o = (size_t)(t.row + fr) * F;
          if (on0) {
            p.o1[o + f0] = d[fr][0];
            p.o2[o + f0] = a[fr][0];
          }
          if (on1) {
            p.o1[o + f1] = d[fr][1];
            p.o2[o + f1] = a[fr][1];
          }
        }
      }
    } else if (MODE == MODE_G) {           // a frame: warp, then warps
#pragma unroll
      for (int fr = 0; fr < TMAX; ++fr) {
        if (fr < t.tc) {
          const float sn = warp_sum(a[fr][0]), sd = warp_sum(d[fr][0]);
          if (lane == 0) {
            part[(fr * ncw + warp) * 2] = sn;
            part[(fr * ncw + warp) * 2 + 1] = sd;
          }
        }
      }
      consumers_sync(nc);
      if (tid < 2 * t.tc) {
        const int fr = tid >> 1, q = tid & 1;
        const float* s = part + fr * ncw * 2 + q;
        float v = s[0];
        for (int w = 1; w < ncw; ++w) v = __fadd_rn(v, s[w * 2]);
        (q ? p.o2 : p.o1)[t.row + fr] = v;
      }
    } else {                               // 'h' with WH: the contraction
      consumers_sync(nc);
      const int nseg = segments(F), seg = (F + nseg - 1) / nseg;
      for (int s = warp; s < nseg; s += ncw) {
        const int g0 = s * seg, g1 = min(F, g0 + seg);
        // lane q K + k: numH (q = 0) or denH (q = 1) of rank k over the
        // segment's bins in order, for the tile's frames at once (2 K <= 32
        // lanes; a Wt value serves every frame)
        if (lane < 2 * K) {
          const int q = lane >= K, k = lane - q * K;
          const float* src = q ? sc1 : sc0;
          const float* w = wts + (size_t)k * F;
          float acc[TMAX];
#pragma unroll
          for (int fr = 0; fr < TMAX; ++fr) acc[fr] = 0.0f;
          for (int f = g0; f < g1; ++f) {
            const float wf = w[f];
#pragma unroll
            for (int fr = 0; fr < TMAX; ++fr)
              if (fr < t.tc) acc[fr] = fmaf(src[fr * F + f], wf, acc[fr]);
          }
#pragma unroll
          for (int fr = 0; fr < TMAX; ++fr)
            if (fr < t.tc)
              part[((size_t)s * TMAX + fr) * 2 * K + lane] = acc[fr];
        }
      }
      // the stage held products written here: order them before the
      // producer's next copy into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + x2_slot);
      consumers_sync(nc);
      for (int i = tid; i < t.tc * K; i += nc) {
        const int fr = i / K, k = i - fr * K;
        const float* q = part + (size_t)fr * 2 * K;
        const size_t step = (size_t)TMAX * 2 * K;     // the next segment
        float sn = q[k], sd = q[K + k];
        for (int s = 1; s < nseg; ++s) {
          sn = __fadd_rn(sn, q[s * step + k]);
          sd = __fadd_rn(sd, q[s * step + K + k]);
        }
        p.o1[(size_t)(t.row + fr) * K + k] = sn;
        p.o2[(size_t)(t.row + fr) * K + k] = sd;
      }
    }
    row += t.tc;
  }
}

// The WH form at ranks past KMAX (see the file comment). The producer and
// the sample loop are the narrow kernel's with WH; g and H come in at the
// start of a tile, Wt through L1 / L2.
template <int MODE, typename S, bool APPROX>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    nmf_sums_wide_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int F = p.F, K = p.K, T = tile_frames(F);
  const Layout lo = layout_wide(F, MODE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bars);
  uint64_t* empty = full + STAGES;
  uint32_t* offs = reinterpret_cast<uint32_t*>(empty + STAGES);
  float* gs = reinterpret_cast<float*>(smem + lo.gs);
  float* hs = reinterpret_cast<float*>(smem + lo.hs);
  float* sc1 = reinterpret_cast<float*>(smem + lo.sc);
  float* part = reinterpret_cast<float*>(smem + lo.part);

  const int nc = blockDim.x - 32, ncw = nc / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = (long long)p.B * p.N;
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  const int nchunks = p.R + 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, ncw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == ncw) {                       // producer
    if (lane != 0) return;
    uint32_t j = 0;
    for (long long row = r0; row < r1;) {
      const Tile t = make_tile(row, r1, T, p);
      for (int c = 0; c < nchunks; ++c, ++j) {
        size_t bytes;
        const void* src = chunk<true, S>(p, t, c, &bytes);
        const int slot = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + slot, ((j / STAGES) + 1) & 1);
        offs[slot] = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15);
        bulk_load_any(smem + slot * lo.stage, src, bytes, full + slot);
      }
      row += t.tc;
    }
    return;
  }

  const int f0 = tid, f1 = tid + nc;
  const bool on0 = f0 < F, on1 = f1 < F;
  const int c0 = on0 ? f0 : F - 1, c1 = on1 ? f1 : F - 1;

  uint32_t j = 0;
  for (long long row = r0; row < r1;) {
    const Tile t = make_tile(row, r1, T, p);
    const float* wt = p.wt + (size_t)t.b * K * F;

    // Vb = H^T Wt, k in order, H a chunk of KCH ranks at a time
    float vb[TMAX][BPT], a[TMAX][BPT], d[TMAX][BPT];
#pragma unroll
    for (int fr = 0; fr < TMAX; ++fr) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) a[fr][i] = d[fr][i] = vb[fr][i] = 0.0f;
    }
    for (int k0 = 0; k0 < K; k0 += KCH) {
      const int kn = min(KCH, K - k0);
      consumers_sync(nc);                  // the last reads of gs / hs are done
      for (int i = tid; i < TMAX * (kn + 1); i += nc) {
        if (i < TMAX) {
          if (k0 == 0) gs[i] = i < t.tc ? __ldg(p.g + t.row + i) : 0.0f;
        } else {
          const int q = i - TMAX, k = q / TMAX, fr = q - k * TMAX;
          hs[q] = fr < t.tc
                      ? __ldg(p.h + ((size_t)t.b * K + k0 + k) * p.N + t.n + fr)
                      : 0.0f;
        }
      }
      consumers_sync(nc);
      for (int k = 0; k < kn; ++k) {
        const float w0 = __ldg(wt + (size_t)(k0 + k) * F + c0);
        const float w1 = __ldg(wt + (size_t)(k0 + k) * F + c1);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          const float hk = hs[k * TMAX + fr];
          vb[fr][0] = fmaf(hk, w0, vb[fr][0]);
          vb[fr][1] = fmaf(hk, w1, vb[fr][1]);
        }
      }
    }

    int x2_slot = -1;
    float* sc0 = nullptr;                  // X2 s2, in the X2 chunk's stage
    for (int c = 0; c < nchunks; ++c, ++j) {
      const int slot = j % STAGES;
      mbar_wait(full + slot, (j / STAGES) & 1);
      unsigned char* buf = smem + slot * lo.stage + offs[slot];
      if (c < p.R) {
        const S* sp = reinterpret_cast<const S*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            const float gf = gs[fr];
            const float v[BPT] = {to_float(sp[fr * F + c0]),
                                  to_float(sp[fr * F + c1])};
#pragma unroll
            for (int i = 0; i < BPT; ++i) {
              const float vs = v[i];
              const float vx =
                  fmaxf(mul_add<APPROX>(gf, vs, vb[fr][i]), VX_FLOOR);
              const float inv = recip<APPROX>(vx);
              if (MODE == MODE_H) {
                d[fr][i] = __fadd_rn(d[fr][i], inv);                  // s1
                a[fr][i] = mul_add<APPROX>(inv, inv, a[fr][i]);       // s2
              } else {
                const float vi = __fmul_rn(vs, inv);
                a[fr][i] = mul_add<APPROX>(vi, inv, a[fr][i]);
                d[fr][i] = __fadd_rn(d[fr][i], vi);
              }
            }
          }
        }
      } else if (MODE == MODE_H) {         // X2 s2 in place, s1 beside it
        float* xp = reinterpret_cast<float*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            if (on0) {
              xp[fr * F + f0] = __fmul_rn(xp[fr * F + f0], a[fr][0]);
              sc1[fr * F + f0] = d[fr][0];
            }
            if (on1) {
              xp[fr * F + f1] = __fmul_rn(xp[fr * F + f1], a[fr][1]);
              sc1[fr * F + f1] = d[fr][1];
            }
          }
        }
        sc0 = xp;                          // released after the epilogue
        x2_slot = slot;
        continue;
      } else {                             // 'g': X2 sum Vs inv^2, per frame
        const float* xp = reinterpret_cast<const float*>(buf);
#pragma unroll
        for (int fr = 0; fr < TMAX; ++fr) {
          if (fr < t.tc) {
            const float n0 =
                on0 ? __fmul_rn(xp[fr * F + c0], a[fr][0]) : 0.0f;
            const float n1 =
                on1 ? __fmul_rn(xp[fr * F + c1], a[fr][1]) : 0.0f;
            a[fr][0] = __fadd_rn(n0, n1);
            d[fr][0] = __fadd_rn(on0 ? d[fr][0] : 0.0f,
                                 on1 ? d[fr][1] : 0.0f);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    if (MODE == MODE_G) {                  // a frame: warp, then warps
#pragma unroll
      for (int fr = 0; fr < TMAX; ++fr) {
        if (fr < t.tc) {
          const float sn = warp_sum(a[fr][0]), sd = warp_sum(d[fr][0]);
          if (lane == 0) {
            part[(fr * ncw + warp) * 2] = sn;
            part[(fr * ncw + warp) * 2 + 1] = sd;
          }
        }
      }
      consumers_sync(nc);
      if (tid < 2 * t.tc) {
        const int fr = tid >> 1, q = tid & 1;
        const float* s = part + fr * ncw * 2 + q;
        float v = s[0];
        for (int w = 1; w < ncw; ++w) v = __fadd_rn(v, s[w * 2]);
        (q ? p.o2 : p.o1)[t.row + fr] = v;
      }
    } else {                               // 'h': the contraction
      const int nseg = segments(F), seg = (F + nseg - 1) / nseg;
      const size_t step = (size_t)TMAX * 2 * KMAX;   // the next segment
      for (int k0 = 0; k0 < K; k0 += KMAX) {
        const int kn = min(KMAX, K - k0);
        consumers_sync(nc);                // sc0 / sc1 written, part free
        for (int s = warp; s < nseg; s += ncw) {
          const int g0 = s * seg, g1 = min(F, g0 + seg);
          // lane q KMAX + k: numH (q = 0) or denH (q = 1) of rank k0 + k
          // over the segment's bins in order, for the tile's frames at once
          const int q = lane >= KMAX, k = lane - q * KMAX;
          if (k < kn) {
            const float* src = q ? sc1 : sc0;
            const float* w = wt + (size_t)(k0 + k) * F;
            float acc[TMAX];
#pragma unroll
            for (int fr = 0; fr < TMAX; ++fr) acc[fr] = 0.0f;
            for (int f = g0; f < g1; ++f) {
              const float wf = __ldg(w + f);
#pragma unroll
              for (int fr = 0; fr < TMAX; ++fr)
                if (fr < t.tc) acc[fr] = fmaf(src[fr * F + f], wf, acc[fr]);
            }
#pragma unroll
            for (int fr = 0; fr < TMAX; ++fr)
              if (fr < t.tc)
                part[((size_t)s * TMAX + fr) * 2 * KMAX + lane] = acc[fr];
          }
        }
        consumers_sync(nc);
        for (int i = tid; i < t.tc * kn; i += nc) {
          const int fr = i / kn, k = i - fr * kn;
          const float* q = part + (size_t)fr * 2 * KMAX;
          float sn = q[k], sd = q[KMAX + k];
          for (int s = 1; s < nseg; ++s) {
            sn = __fadd_rn(sn, q[s * step + k]);
            sd = __fadd_rn(sd, q[s * step + KMAX + k]);
          }
          p.o1[(size_t)(t.row + fr) * K + k0 + k] = sn;
          p.o2[(size_t)(t.row + fr) * K + k0 + k] = sd;
        }
      }
      // the stage held products written here: order them before the
      // producer's next copy into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + x2_slot);
    }
    row += t.tc;
  }
}

// Per instantiation: the shared memory its attribute allows and the CTAs
// an SM holds at that size and block, on the device last seen.
struct Plan {
  int device = -1, threads = 0, sms = 0, blocks = 0;
  size_t smem = 0;
};

std::mutex plan_lock;

template <int MODE, bool WH, typename S, bool APPROX>
auto kernel_of(bool wide) {
  return wide && WH ? nmf_sums_wide_kernel<MODE, S, APPROX>
                    : nmf_sums_kernel<MODE, WH, S, APPROX>;
}

template <bool WIDE, int MODE, bool WH, typename S, bool APPROX>
cudaError_t plan(int threads, size_t smem, Plan* out) {
  static Plan cached;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> guard(plan_lock);
  if (cached.device != dev || cached.smem != smem ||
      cached.threads != threads) {
    auto kern = kernel_of<MODE, WH, S, APPROX>(WIDE);
    Plan q;
    q.device = dev;
    q.threads = threads;
    q.smem = smem;
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &q.blocks, kern, threads, smem)) != cudaSuccess)
      return e;
    if (q.blocks < 1) return cudaErrorInvalidConfiguration;
    cached = q;
  }
  *out = cached;
  return cudaSuccess;
}

template <bool WIDE, int MODE, bool WH, typename S, bool APPROX>
cudaError_t launch_t(const Params& p, cudaStream_t st, int* geo) {
  const Layout lo = WIDE ? layout_wide(p.F, MODE) : layout(p.F, p.K, WH, MODE);
  const int threads = consumers(p.F) + 32, T = tile_frames(p.F);
  Plan q;
  cudaError_t e = plan<WIDE, MODE, WH, S, APPROX>(threads, lo.total, &q);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.N;
  const long long tiles = (rows + T - 1) / T;
  const long long cap = (long long)q.blocks * q.sms;
  const int grid = (int)(tiles < cap ? tiles : cap);
  if (geo != nullptr) {
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, kernel_of<MODE, WH, S, APPROX>(WIDE)))
        != cudaSuccess)
      return e;
    const int vals[] = {grid, threads, (int)lo.total, STAGES, T,
                        segments(p.F), q.blocks, q.sms, fa.numRegs};
    for (int i = 0; i < 9; ++i) geo[i] = vals[i];
    return cudaSuccess;
  }
  if (grid == 0) return cudaSuccess;
  if (WIDE && WH)
    nmf_sums_wide_kernel<MODE, S, APPROX><<<grid, threads, lo.total, st>>>(p);
  else
    nmf_sums_kernel<MODE, WH, S, APPROX><<<grid, threads, lo.total, st>>>(p);
  return cudaGetLastError();
}

template <typename S, bool APPROX>
cudaError_t launch(const Params& p, int mode, cudaStream_t st, int* geo) {
  const bool wh = p.vb == nullptr, wide = wh && p.K > KMAX;
  if (wide)
    return mode == MODE_H ? launch_t<true, MODE_H, true, S, APPROX>(p, st, geo)
                          : launch_t<true, MODE_G, true, S, APPROX>(p, st, geo);
  if (mode == MODE_H)
    return wh ? launch_t<false, MODE_H, true, S, APPROX>(p, st, geo)
              : launch_t<false, MODE_H, false, S, APPROX>(p, st, geo);
  return wh ? launch_t<false, MODE_G, true, S, APPROX>(p, st, geo)
            : launch_t<false, MODE_G, false, S, APPROX>(p, st, geo);
}

int dispatch(const Params& p, int mode, int samples_bf16, int approx_recip,
             void* stream, int* geo) {
  if ((mode != MODE_H && mode != MODE_G) || p.F < 1 || p.F > FMAX ||
      p.R < 0 || (p.vb == nullptr && p.K < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (samples_bf16 && approx_recip)
    e = launch<__nv_bfloat16, true>(p, mode, st, geo);
  else if (samples_bf16)
    e = launch<__nv_bfloat16, false>(p, mode, st, geo);
  else if (approx_recip)
    e = launch<float, true>(p, mode, st, geo);
  else
    e = launch<float, false>(p, mode, st, geo);
  return (int)e;
}

Params params(const void* samples, const float* vb, const float* wt,
              const float* h, const float* g, const float* x2, float* o1,
              float* o2, int B, int R, int N, int F, int K) {
  Params p;
  p.samples = samples;
  p.vb = vb;
  p.wt = wt;
  p.h = h;
  p.g = g;
  p.x2 = x2;
  p.o1 = o1;
  p.o2 = o2;
  p.B = B;
  p.R = R;
  p.N = N;
  p.F = F;
  p.K = vb == nullptr ? K : 0;
  return p;
}

}  // namespace

extern "C" {

// The largest rank of the narrow kernel: past it the wide kernel runs,
// KMAX ranks of the contraction at a time.
int gvnmf_nmf_sums_narrow_rank() { return KMAX; }

// The largest F the kernel takes: BPT bins a consumer thread.
int gvnmf_nmf_sums_fmax() { return FMAX; }

// mode 0 = 'h', mode 1 = 'g'. With WH (vb null): 'h' -> o1 / o2 =
// numH / denH (B, N, K), 'g' -> o1 / o2 = num / den (B, N). With vb
// (wt, h unused, K ignored): 'h' -> o1 / o2 = s1 / s2 (B, N, F), 'g' ->
// num / den (B, N). samples_bf16: the samples are bfloat16, else float32.
// approx_recip: 1/Vx from rcp.approx. Returns the cudaError_t of the launch.
int gvnmf_nmf_sums(const void* samples, const float* vb, const float* wt,
                   const float* h, const float* g, const float* x2,
                   float* o1, float* o2, int B, int R, int N, int F, int K,
                   int mode, int samples_bf16, int approx_recip,
                   void* stream) {
  return dispatch(params(samples, vb, wt, h, g, x2, o1, o2, B, R, N, F, K),
                  mode, samples_bf16, approx_recip, stream, nullptr);
}

// The launch gvnmf_nmf_sums would make at these shapes on the current
// device (vb: nonzero for the Vb form), without launching: out[0..8] =
// CTAs, threads a CTA, dynamic shared memory bytes a CTA, stages, frames a
// tile, reduction segments a frame, CTAs an SM, SMs, registers a thread.
int gvnmf_nmf_sums_geometry(int B, int R, int N, int F, int K, int mode,
                            int vb, int samples_bf16, int approx_recip,
                            int* out) {
  static const float dummy = 0.0f;
  return dispatch(params(nullptr, vb ? &dummy : nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, B, R, N, F, K),
                  mode, samples_bf16, approx_recip, nullptr, out);
}

}  // extern "C"
