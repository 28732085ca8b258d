// The MH chain (K1) for every decoder the TPU kernel takes: K1g, the
// general form.
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: mh_chain_pallas (:336,
// body _make_chain_kernel :121-320) where neither cluster form takes the
// decoder (mh_chain.cu, K1a-K1d: one hidden width whose column slices fit
// 4 CTAs; mh_chain_ext.cu, K1e: slices of every layer on 4 or 8 CTAs):
// decoders of 1 to 4 hidden layers of any widths, such as (512, 512),
// (2048,) or (2048, 2048) at F = 513, at any F and NMF rank. It computes
// what mh_chain_ref computes, in both modes (E with the sample dump and
// s1 / s2 or numW / denW; WF with the Wiener sums), both noise forms (WH=,
// Vb=), with the recorded streams and every fast option (bfloat16 dumps,
// approx_recip, approx_trans, bfloat16 decoder products).
//
// What bounds it on an H100: float32 arithmetic. Per frame and step the
// decoder costs 2 (L H1 + sum H_i H_i+1 + H_d F) FLOP (1.08 MFLOP for the
// (512, 512) decoder at F = 513: 0.9986 ms a B = 4, N = 384 E launch at
// 67 TFLOP/s, 1.37 ms on the 96 SMs its 96 tiles take). The weights (2.17
// MB there) pass a CTA's shared memory, so every decode reads them again
// from L2, where they stay: with T = 16 frames sharing each read, 96 tiles
// x 41 decodes x 2.17 MB = 8.5 GB an E launch (two CTAs multicasting each
// copy to both would halve it). The first K1g read each weight from L2 per
// thread per use (__ldg, 4 FMAs a load, each frame group of a tile reading
// it again), 4-8 times those bytes, with 96 registers a thread: it ran at
// 11 % of the operations bound, its weight-bound layers 89 % of a step.
//
// The design: one CTA a tile of T frames of one utterance, a producer warp
// streaming the weights through shared memory and consumer warps holding
// register tiles.
//   * The frame tile T is 16, or 8 or 4 where a 16-frame tile does not
//     fit the CTA's 227 KB, and the ring's stages hold 8192 floats where
//     they fit beside it, else 4096: a function of the shapes alone (plan;
//     the wrapper mirrors it). The hidden activations live in shared
//     memory in two buffers [rows][T], as tall as the widest even and the
//     widest odd hidden layer (one buffer at depth 1); the first layer's
//     bias term ypre is read from global memory.
//   * Weights: the wrapper packs each layer's matrix with its rows padded
//     to a multiple of 8 floats (pack_general in mcem/mh_chain.py), so
//     every run it copies is 16-byte aligned. A producer warp (one thread)
//     walks the layers of every decode of the chain in the consumers'
//     order and copies each k-tile (rows of a column chunk) with
//     cp.async.bulk into a ring of STAGES shared-memory stages, each with
//     a full and an empty mbarrier; every weight crosses L2 once per CTA
//     per decode and all T frames read it from shared memory.
//   * Register tiles: a consumer thread owns 4 units (columns) x 8 frames
//     of a layer (4 x 4 at T = 4), lanes alternating over the two frame
//     halves of a 16-frame tile: three 16-byte shared-memory loads a row
//     (one of weights, two of activations) for 32 FMAs. At most 288
//     consumers and a producer warp (10 warps) leave 168 registers a
//     thread (8 x 8 tiles would take 64 accumulators and spill there). A layer wider than the consumers'
//     items is taken in column chunks, each streamed on its own. Each
//     unit's sum runs over its input in order, k-tile after k-tile, one
//     FMA after another.
//   * The per-(frame, bin) state (X2, Vb, the proposal, the accepted Vs
//     and 1/Vx, the two accumulators) lives in global memory (L2): a
//     thread reads and writes only the elements of its own output items,
//     which never change owner, so no barrier guards them.
//   * A frame's data term: each output item writes its frames' partial
//     sums over its columns to shared memory, and one warp a frame adds
//     them in column order, then over the warp's lanes by a fixed
//     butterfly: the order depends on F only, so a batch equals each
//     utterance run alone, at every frame tile.
//   * Draws: the cluster form's Philox4x32-10 counters (chain_common.cuh),
//     keyed on (seed, utterance, frame, step, draw): the same streams at
//     every frame tile.
//   * numW / denW: each CTA writes its tile's (K, F) partials and a second
//     kernel adds them over tiles in order, as the cluster form does. No
//     float atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 4;           // hidden layers
constexpr int CC = 4;             // units (columns) an item
constexpr int PAD = 8;            // packed rows: a multiple of PAD floats,
                                  // so an item of up to 8 units is in its row
constexpr int STAGES = 4;         // weight ring stages
constexpr int SLOT_BIG = 8192;    // floats a stage (32 KB) where it fits,
constexpr int SLOT_SMALL = 4096;  // else 16 KB
constexpr int NC_MAX = 288;       // consumer threads a CTA at most: with
constexpr int MAX_NT = NC_MAX + 32;  // the producer 10 warps, 168 registers
constexpr long long SMEM_MAX = 232448;  // dynamic shared memory a CTA
constexpr float VX_FLOOR = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_E = 0, MODE_WF = 1 };

#include "chain_common.cuh"

struct GParams {
  const float* x2;    // (B, N, F)
  const float* vb;    // (B, N, F): the Vb form's input or the WH form's
                      // scratch (written here first)
  const float* wt;    // (B, K, F), WH form
  const float* h;     // (B, K, N), WH form
  const float* mask;  // (B, N), E-mode of the WH form
  const float* g;     // (B, N)
  const float* ypre;  // (B, N, H1)
  const float* z;     // (B, N, L)
  const float* vs;    // (B, N, F), decode(Z)
  const float* zn;    // (B, n_steps, N, L), inject only
  const float* u;     // (B, n_steps, N), inject only
  const float* wpk;   // the packed weights (pack_general)
  const float* bm[MAXD - 1];  // hidden layer d + 1's bias (H_d+1)
  const float* bo;    // (F)
  float* z_out;       // (B, N, L)
  float* vs_out;      // (B, N, F): the accepted Vs throughout the chain
  float* samples;     // E: float32 samples (B, R, N, F), or null
  __nv_bfloat16* samples_h;  // E: bfloat16 samples, or null
  float* vbw;         // WH form: Vb scratch (B, N, F)
  float* vp;          // proposal Vs scratch (B, N, F)
  float* inv;         // accepted 1/Vx scratch (B, N, F)
  float* a1;          // s1 (E) or acc_s (WF), (B, N, F)
  float* a2;          // s2 (E) or acc_n (WF), (B, N, F)
  float* part1;       // E, WH form: numW partials (B, N / T, K, F)
  float* part2;       // E, WH form: denW partials
  int B, N, F, L, K, depth, n_steps, burnin;
  int hw[MAXD];       // hidden widths H1 .. H_depth
  int T, nfg, nc;     // frames a tile, frame groups, consumer threads
  int slot;           // floats a ring stage
  float sqrt_var;
  uint32_t seed_lo, seed_hi;
  int approx_recip, approx_trans, mm_bf16;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }
__host__ __device__ inline int round_pad(int a) {
  return (a + PAD - 1) / PAD * PAD;
}

// Frames an item (of a register tile) at frame tile T, and the frame groups
// a tile has.
__host__ __device__ inline int item_frames(int T) { return T < 8 ? T : 8; }
__host__ __device__ inline int frame_groups(int T) {
  return T / item_frames(T);
}

// Consumer threads a CTA: an output item (CC columns x a frame group) a
// thread, in warps, at least 64 and at most NC_MAX (wider F takes the
// output layer in column chunks; NC_MAX holds F = 513 at 16 frames, and
// keeps 168 registers a thread, where 544 threads left 96 and spilled).
__host__ __device__ inline int consumers(int F, int T) {
  const int nt = 32 * cdiv(frame_groups(T) * cdiv(F, CC), 32);
  return nt < 64 ? 64 : (nt > NC_MAX ? NC_MAX : nt);
}

// The widest hidden layer of one parity (0: layers 1, 3; 1: layers 2, 4).
__host__ __device__ inline int widest(const int* hw, int depth, int parity) {
  int m = 0;
  for (int d = parity; d < depth; d += 2) m = hw[d] > m ? hw[d] : m;
  return m;
}

// Shared memory (floats) at frame tile T and ring stages of `slot` floats:
// the weight ring [STAGES][slot];
// hA [rows_a][T], hB [rows_b][T]; z, zp, zn [L][T]; hk [K][T]; red [T][nq]
// (the output items' frame partials); g, mask, s, acc, dz [T]; logu [2][T];
// the full / empty mbarriers.
__host__ __device__ inline long long smem_floats(int F, int L, const int* hw,
                                                 int depth, int K, int T,
                                                 int slot) {
  const long long rows = round4(widest(hw, depth, 0)) +
                         round4(widest(hw, depth, 1));
  return (long long)STAGES * slot +
         (long long)T * (rows + 3 * round4(L) + round4(K) +
                         round4(cdiv(F, CC)) + 7) +
         4 * STAGES;
}

// The launch's frame tile and ring stage: the largest tile of 16, 8 and 4
// frames whose CTA fits SMEM_MAX, with stages of SLOT_BIG floats where they
// fit beside it, else SLOT_SMALL; {0, 0} where no tile fits.
struct Plan {
  int T, slot;
};

__host__ __device__ inline Plan plan(int F, int L, const int* hw, int depth,
                                     int K) {
  for (int T = 16; T >= 4; T >>= 1)
    for (int slot = SLOT_BIG; slot >= SLOT_SMALL; slot /= 2)
      if (4 * smem_floats(F, L, hw, depth, K, T, slot) <= SMEM_MAX)
        return {T, slot};
  return {0, 0};
}

// Inputs of layer d (d == depth: the output layer) and its outputs.
__host__ __device__ inline int layer_in(int L, const int* hw, int d) {
  return d == 0 ? L : hw[d - 1];
}
__host__ __device__ inline int layer_out(int F, const int* hw, int depth,
                                         int d) {
  return d < depth ? hw[d] : F;
}

// Offset (floats) of layer d's packed weights: layer after layer, each
// [inputs][round_pad(outputs)]; at d = depth + 1 the block's size.
__host__ __device__ inline long long layer_offset(int F, int L,
                                                  const int* hw, int depth,
                                                  int d) {
  long long off = 0;
  for (int i = 0; i < d; ++i)
    off += (long long)layer_in(L, hw, i) *
           round_pad(layer_out(F, hw, depth, i));
  return off;
}

// A layer's streaming geometry: its outputs in groups of CC units, taken
// in nch column chunks of qpc groups (cw = CC qpc
// columns, the last chunk narrower), each chunk's weight rows in k-tiles
// of kt rows.
struct Layer {
  const float* w;
  int kin, n, P, groups, qpc, cw, nch, kt;
};

__device__ inline Layer layer_geo(const GParams& p, int d) {
  Layer l;
  l.kin = layer_in(p.L, p.hw, d);
  l.n = layer_out(p.F, p.hw, p.depth, d);
  l.P = round_pad(l.n);
  l.w = p.wpk + layer_offset(p.F, p.L, p.hw, p.depth, d);
  l.groups = cdiv(l.n, CC);
  const int qmax = p.nc / p.nfg;
  l.qpc = cdiv(l.groups, cdiv(l.groups, qmax));
  l.nch = cdiv(l.groups, l.qpc);
  l.cw = CC * l.qpc;
  l.kt = min(l.kin, p.slot / l.cw);
  return l;
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* q) {
  return (uint32_t)__cvta_generic_to_shared(q);
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

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one bulk copy of [src, src + bytes) (both 16-byte aligned, bytes a
// multiple of 16) into dst, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the consumer warps (threads 0 .. nc - 1) only
__device__ __forceinline__ void consumers_sync(int nc) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(nc) : "memory");
}

// ---------------------------------------------------------------------------
// Shared memory
// ---------------------------------------------------------------------------

struct Smem {
  float *ring, *hA, *hB, *z, *zp, *zn, *hk, *red;
  float *g, *mask, *s, *acc, *dz, *logu;
  uint64_t *full, *empty;
};

__device__ inline Smem carve(float* base, const GParams& p) {
  Smem s;
  const int T = p.T;
  s.ring = base;
  s.hA = s.ring + STAGES * p.slot;
  s.hB = s.hA + round4(widest(p.hw, p.depth, 0)) * T;
  s.z = s.hB + round4(widest(p.hw, p.depth, 1)) * T;
  s.zp = s.z + round4(p.L) * T;
  s.zn = s.zp + round4(p.L) * T;
  s.hk = s.zn + round4(p.L) * T;
  s.red = s.hk + round4(p.K) * T;
  s.g = s.red + round4(cdiv(p.F, CC)) * T;
  s.mask = s.g + T;
  s.s = s.mask + T;
  s.acc = s.s + T;
  s.dz = s.acc + T;
  s.logu = s.dz + T;
  s.full = reinterpret_cast<uint64_t*>(s.logu + 2 * T);
  s.empty = s.full + STAGES;
  return s;
}

// ---------------------------------------------------------------------------
// The weight stream
// ---------------------------------------------------------------------------

// The producer: every k-tile of every column chunk of every layer of each
// of the chain's n_steps + 1 decodes, in the consumers' order, into the
// ring. Slot j % STAGES is refilled once the consumer warps have released
// its last use.
__device__ void produce(const GParams& p, const Smem& sm) {
  uint32_t j = 0;
  for (int dec = 0; dec <= p.n_steps; ++dec) {
    for (int d = 0; d <= p.depth; ++d) {
      const Layer l = layer_geo(p, d);
      for (int c = 0; c < l.nch; ++c) {
        const int c0 = c * l.cw, w = min(l.cw, l.P - c0);
        for (int k0 = 0; k0 < l.kin; k0 += l.kt, ++j) {
          const int kt = min(l.kt, l.kin - k0);
          const int s = j % STAGES;
          if (j >= STAGES) mbar_wait(sm.empty + s, ((j / STAGES) + 1) & 1);
          float* dst = sm.ring + s * p.slot;
          mbar_expect(sm.full + s, (uint32_t)(kt * w * 4));
          if (w == l.P) {
            bulk_copy(dst, l.w + (size_t)k0 * l.P, (uint32_t)(kt * w * 4),
                      sm.full + s);
          } else {
            for (int r = 0; r < kt; ++r)
              bulk_copy(dst + r * w, l.w + (size_t)(k0 + r) * l.P + c0,
                        (uint32_t)(w * 4), sm.full + s);
          }
        }
      }
    }
  }
}

// This CTA's tile: frames n0 .. n0 + T - 1 of utterance b.
struct Tile {
  int b, tile, n0;
  __device__ size_t row(int t, int N) const {
    return (size_t)b * N + n0 + t;
  }
};

// FG consecutive floats from shared memory (16-byte aligned): the frames
// of a row of an activation tile ([k][T]) or an item's weights of a row.
template <int FG>
__device__ __forceinline__ void load_frames(const float* x, float (&xs)[FG]) {
#pragma unroll
  for (int h = 0; h < FG / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(x + 4 * h);
    xs[4 * h] = v.x;
    xs[4 * h + 1] = v.y;
    xs[4 * h + 2] = v.z;
    xs[4 * h + 3] = v.w;
  }
}

// One layer over the [kin][T] input tile `in`: each consumer thread's item
// (CC units of column chunk c x FG frames) summed over k in order from the
// ring, then epi(q, t0, acc) (q the item's group, t0 its first frame). Every
// consumer warp waits for and releases every stage, with or without an
// item in the chunk. RND_IN rounds the input to bfloat16 as it is read.
template <int FG, bool RND_IN, class Epi>
__device__ __forceinline__ void layer(const GParams& p, const Smem& sm,
                                      uint32_t& j, const float* in,
                                      const Layer& l, Epi epi) {
  const int i = threadIdx.x, lane = i & 31, T = p.T;
  const int fg = i % p.nfg, qi = i / p.nfg;
  for (int c = 0; c < l.nch; ++c) {
    const int q = c * l.qpc + qi;
    const bool on = qi < l.qpc && q < l.groups;
    const int c0 = c * l.cw, w = min(l.cw, l.P - c0);
    float a[CC][FG];
#pragma unroll
    for (int u = 0; u < CC; ++u)
#pragma unroll
      for (int t = 0; t < FG; ++t) a[u][t] = 0.0f;
    for (int k0 = 0; k0 < l.kin; k0 += l.kt, ++j) {
      const int kt = min(l.kt, l.kin - k0);
      const int s = j % STAGES;
      mbar_wait(sm.full + s, (j / STAGES) & 1);
      if (on) {
        const float* wr = sm.ring + s * p.slot + (CC * q - c0);
        const float* x = in + k0 * T + fg * FG;
#pragma unroll 4
        for (int r = 0; r < kt; ++r) {
          float wv[CC], xs[FG];
          load_frames<CC>(wr + r * w, wv);
          load_frames<FG>(x + r * T, xs);
          if (RND_IN) {
#pragma unroll
            for (int t = 0; t < FG; ++t) xs[t] = bf16_round(xs[t]);
          }
#pragma unroll
          for (int t = 0; t < FG; ++t)
#pragma unroll
            for (int u = 0; u < CC; ++u) a[u][t] = fmaf(xs[t], wv[u], a[u][t]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + s);
    }
    if (on) epi(q, fg * FG, a);
  }
}

// The hidden stack on the [L][T] latent tile `zin`: each layer's units
// tanh(sum_k in[k] w[k][j] + bias), bias ypre[j] for the first layer (from
// global memory), into hA (layers 1, 3) or hB (layers 2, 4). RND rounds the
// first layer's input and every output to bfloat16 (bfloat16 products).
// Returns the buffer holding the last layer, complete after the barrier.
template <int FG, bool RND>
__device__ const float* hidden_stack(const GParams& p, const Smem& sm,
                                     uint32_t& j, const Tile& tl,
                                     const float* zin) {
  const float* src = zin;
  for (int d = 0; d < p.depth; ++d) {
    float* dst = (d & 1) ? sm.hB : sm.hA;
    const Layer l = layer_geo(p, d);
    const float* bias = d == 0 ? nullptr : p.bm[d - 1];
    auto epi = [&](int q, int t0, float (&a)[CC][FG]) {
#pragma unroll
      for (int u = 0; u < CC; ++u) {
        const int jn = CC * q + u;
        if (jn < l.n) {
          float hv[FG];
#pragma unroll
          for (int t = 0; t < FG; ++t) {
            const float bv =
                bias ? __ldg(bias + jn)
                     : __ldg(p.ypre + tl.row(t0 + t, p.N) * p.hw[0] + jn);
            float v = tanhf(__fadd_rn(a[u][t], bv));
            if (RND) v = bf16_round(v);
            hv[t] = v;
          }
#pragma unroll
          for (int h = 0; h < FG / 4; ++h)
            *reinterpret_cast<float4*>(dst + jn * p.T + t0 + 4 * h) =
                make_float4(hv[4 * h], hv[4 * h + 1], hv[4 * h + 2],
                            hv[4 * h + 3]);
        }
      }
    };
    if (d == 0)
      layer<FG, RND>(p, sm, j, src, l, epi);
    else
      layer<FG, false>(p, sm, j, src, l, epi);
    consumers_sync(p.nc);
    src = dst;
  }
  return src;
}

template <int FG>
__device__ __forceinline__ const float* decoder_hidden(const GParams& p,
                                                       const Smem& sm,
                                                       uint32_t& j,
                                                       const Tile& tl,
                                                       const float* zin) {
  if (p.mm_bf16) return hidden_stack<FG, true>(p, sm, j, tl, zin);
  return hidden_stack<FG, false>(p, sm, j, tl, zin);
}

// ---------------------------------------------------------------------------
// The chain
// ---------------------------------------------------------------------------

__device__ __forceinline__ float recip(const GParams& p, float x) {
  return p.approx_recip ? rcp_approx(x) : 1.0f / x;
}

__device__ __forceinline__ float log_k(const GParams& p, float x) {
  return p.approx_trans ? fast_log(x) : logf(x);
}

__device__ __forceinline__ float mix_var(float g, float vs, float vb) {
  return fmaxf(__fadd_rn(__fmul_rn(g, vs), vb), VX_FLOOR);
}

// f(q, t0) for each of this thread's output items (group q of the output
// layer's column chunks, frames t0 .. t0 + T / nfg - 1): the same items in
// every phase of the launch.
template <class Fn>
__device__ __forceinline__ void for_items(const GParams& p, Fn f) {
  const Layer l = layer_geo(p, p.depth);
  const int i = threadIdx.x, fg = i % p.nfg, qi = i / p.nfg;
  if (qi >= l.qpc) return;
  for (int c = 0; c < l.nch; ++c) {
    const int q = c * l.qpc + qi;
    if (q < l.groups) f(q, fg * (p.T / p.nfg));
  }
}

// v[j][t] = exp(v[j][t] + bo[4q + j]) for the item's columns.
template <int FG>
__device__ __forceinline__ void out_values(const GParams& p, int q,
                                           float (&v)[CC][FG]) {
#pragma unroll
  for (int u = 0; u < CC; ++u) {
    const int c = CC * q + u;
    const float b = c < p.F ? __ldg(p.bo + c) : 0.0f;
#pragma unroll
    for (int t = 0; t < FG; ++t) {
      const float x = __fadd_rn(v[u][t], b);
      v[u][t] = p.approx_trans ? fast_exp(x) : expf(x);
    }
  }
}

// The item's share of its frames' data terms, sum over its columns of
// log Vx + X2 / Vx, into red[t][q].
template <int FG>
__device__ __forceinline__ void item_terms(const GParams& p, const Smem& sm,
                                           const Tile& tl, int q, int t0,
                                           const float (&v)[CC][FG]) {
  const int c0 = CC * q, ncol = min(CC, p.F - c0);
  const int rq = round4(cdiv(p.F, CC));
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = t0 + i;
    const size_t o = tl.row(t, p.N) * p.F + c0;
    const float gt = sm.g[t];
    float part = 0.0f;
#pragma unroll
    for (int u = 0; u < CC; ++u) {
      if (u < ncol) {
        const float vx = mix_var(gt, v[u][i], p.vb[o + u]);
        const float iv = recip(p, vx);
        part = __fadd_rn(part,
                         __fadd_rn(log_k(p, vx), __fmul_rn(iv, p.x2[o + u])));
      }
    }
    sm.red[t * rq + q] = part;
  }
}

// Frame t's sum of red[t][:]: a warp a frame, its lanes over the columns in
// order, then a fixed butterfly. Every lane returns the sum.
__device__ __forceinline__ float frame_sum(const float* red, int t, int nq) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int q = lane; q < nq; q += 32)
    s = __fadd_rn(s, red[t * round4(nq) + q]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
  return s;
}

// 0.5 sum_l (Z^2 - Zp^2) of each frame: a warp a frame.
__device__ __forceinline__ void latent_prior_terms(const GParams& p,
                                                   const Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = p.nc >> 5, T = p.T;
  for (int t = warp; t < T; t += nw) {
    float d = 0.0f;
    for (int l = lane; l < p.L; l += 32) {
      const float a = sm.z[l * T + t], b = sm.zp[l * T + t];
      d = __fadd_rn(d, __fsub_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      d = __fadd_rn(d, __shfl_xor_sync(FULL, d, off));
    if (lane == 0) sm.dz[t] = __fmul_rn(0.5f, d);
  }
}

// The random numbers of step m: the proposal normals into zn ([L][T]) and
// the accept test's log u into logu[m & 1].
__device__ void draw(const GParams& p, const Smem& sm, const Tile& tl,
                     int m) {
  const bool inject = p.zn != nullptr;
  const int nd = cdiv(p.L, 4), T = p.T;
  for (int i = threadIdx.x; i < T * nd + T; i += p.nc) {
    if (i < T * nd) {
      const int t = i / nd, q = i % nd;
      float4 nz;
      if (inject) {
        const float* zn =
            p.zn + ((size_t)(tl.b * p.n_steps + m) * p.N + tl.n0 + t) * p.L;
        float tmp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tmp[j] = 4 * q + j < p.L ? zn[4 * q + j] : 0.0f;
        nz = make_float4(tmp[0], tmp[1], tmp[2], tmp[3]);
      } else {
        nz = normals4(p.seed_lo, p.seed_hi, tl.b, tl.n0 + t, m, q,
                      p.approx_trans != 0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < p.L) sm.zn[(4 * q + j) * T + t] = f4get(nz, j);
    } else {
      const int t = i - T * nd;
      const float u =
          inject ? p.u[(size_t)(tl.b * p.n_steps + m) * p.N + tl.n0 + t]
                 : accept_uniform(p.seed_lo, p.seed_hi, tl.b, tl.n0 + t, m);
      sm.logu[(m & 1) * T + t] = log_k(p, u);
    }
  }
}

// One MH step at global step index m; SAMPLE: the sampling phase (r its
// sample index), which keeps the proposals and updates the accepted state
// and the accumulators.
template <int MODE, bool SAMPLE, int FG>
__device__ void mh_step(const GParams& p, const Smem& sm, uint32_t& j,
                        const Tile& tl, int m, int r) {
  const int T = p.T, nc = p.nc, nq = cdiv(p.F, CC);
  for (int i = threadIdx.x; i < p.L * T; i += nc)
    sm.zp[i] = __fadd_rn(sm.z[i], __fmul_rn(p.sqrt_var, sm.zn[i]));
  consumers_sync(nc);
  latent_prior_terms(p, sm);
  const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.zp);
  layer<FG, false>(p, sm, j, hsrc, layer_geo(p, p.depth),
                   [&](int q, int t0, float (&v)[CC][FG]) {
    out_values<FG>(p, q, v);
    item_terms<FG>(p, sm, tl, q, t0, v);
    if (SAMPLE) {
      const int c0 = CC * q, ncol = min(CC, p.F - c0);
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const size_t o = tl.row(t0 + i, p.N) * p.F + c0;
#pragma unroll
        for (int u = 0; u < CC; ++u)
          if (u < ncol) p.vp[o + u] = v[u][i];
      }
    }
  });
  consumers_sync(nc);                   // red and dz complete; zn read
  const int warp = threadIdx.x >> 5, nw = nc >> 5;
  for (int t = warp; t < T; t += nw) {
    const float sp = frame_sum(sm.red, t, nq);
    if ((threadIdx.x & 31) == 0) {
      const float a = __fadd_rn(__fsub_rn(sm.s[t], sp), sm.dz[t]);
      const bool accept = sm.logu[(m & 1) * T + t] < a;
      sm.acc[t] = accept ? 1.0f : 0.0f;
      if (accept) sm.s[t] = sp;
    }
  }
  if (m + 1 < p.n_steps) draw(p, sm, tl, m + 1);
  consumers_sync(nc);                   // acc complete
  for (int i = threadIdx.x; i < p.L * T; i += nc)
    if (sm.acc[i % T] != 0.0f) sm.z[i] = sm.zp[i];
  if (SAMPLE) {
    const int fgn = T / p.nfg;
    for_items(p, [&](int q, int t0) {
      const int c0 = CC * q, ncol = min(CC, p.F - c0);
      for (int i = 0; i < fgn; ++i) {
        const int t = t0 + i;
        const bool acc = sm.acc[t] != 0.0f;
        const size_t o = tl.row(t, p.N) * p.F + c0;
        const size_t so =
            ((size_t)(tl.b * (p.n_steps - p.burnin) + r) * p.N + tl.n0 + t) *
                p.F + c0;
        for (int u = 0; u < ncol; ++u) {
          float vs, iv;
          if (acc) {
            vs = p.vp[o + u];
            iv = recip(p, mix_var(sm.g[t], vs, p.vb[o + u]));
            p.vs_out[o + u] = vs;
            p.inv[o + u] = iv;
          } else {
            vs = p.vs_out[o + u];
            iv = p.inv[o + u];
          }
          if (MODE == MODE_E) {
            if (p.samples_h != nullptr)
              p.samples_h[so + u] = __float2bfloat16_rn(vs);
            else
              p.samples[so + u] = vs;
            p.a1[o + u] = __fadd_rn(p.a1[o + u], iv);
            p.a2[o + u] = __fadd_rn(p.a2[o + u], __fmul_rn(iv, iv));
          } else {
            const float tt = __fmul_rn(p.vb[o + u], iv);
            p.a2[o + u] = __fadd_rn(p.a2[o + u], tt);                   // acc_n
            p.a1[o + u] = __fadd_rn(p.a1[o + u], __fsub_rn(1.0f, tt));  // acc_s
          }
        }
      }
    });
  }
  consumers_sync(nc);                   // z updated before the next proposal
}

// VB: the Vb form (p.vb is the input); else the WH form (p.vb is the
// scratch this kernel fills with H^T Wt). FG: frames an item (8, or 4 at
// T = 4). One CTA a tile; a 1-D grid; nc consumer threads and a producer
// warp.
template <int MODE, bool VB, int FG>
__global__ void __launch_bounds__(MAX_NT, 1)
    mh_chain_general_kernel(GParams p) {
  extern __shared__ __align__(128) float smem_raw[];
  const Smem sm = carve(smem_raw, p);
  const int tid = threadIdx.x, nc = p.nc, T = p.T;
  const int n_tiles = p.N / T;
  Tile tl;
  tl.b = blockIdx.x / n_tiles;
  tl.tile = blockIdx.x % n_tiles;
  tl.n0 = tl.tile * T;
  const int nq = cdiv(p.F, CC);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full + s, 1);
      mbar_init(sm.empty + s, nc / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= nc) {                      // the producer warp
    if (tid == nc) produce(p, sm);
    return;
  }

  if (tid < T) {
    sm.g[tid] = p.g[tl.row(tid, p.N)];
    sm.mask[tid] = (MODE == MODE_E && !VB) ? p.mask[tl.row(tid, p.N)] : 0.0f;
  }
  if (!VB)
    for (int i = tid; i < p.K * T; i += nc)
      sm.hk[i] = p.h[((size_t)tl.b * p.K + i / T) * p.N + tl.n0 + i % T];
  for (int i = tid; i < T * p.L; i += nc) {
    const int t = i / p.L, l = i % p.L;
    sm.z[l * T + t] = p.z[tl.row(t, p.N) * p.L + l];
  }
  consumers_sync(nc);

  // Vb (WH form), the accumulators, and the initial data term from the
  // caller's Vs (= decode(Z)), item by item
  for_items(p, [&](int q, int t0) {
    const int c0 = CC * q, ncol = min(CC, p.F - c0);
    float v[CC][FG];
#pragma unroll
    for (int i = 0; i < FG; ++i) {
      const int t = t0 + i;
      const size_t o = tl.row(t, p.N) * p.F + c0;
#pragma unroll
      for (int u = 0; u < CC; ++u) {
        if (u >= ncol) {
          v[u][i] = 1.0f;
          continue;
        }
        if (!VB) {
          float vb = 0.0f;
          for (int k = 0; k < p.K; ++k)
            vb = fmaf(sm.hk[k * T + t],
                      __ldg(p.wt + ((size_t)tl.b * p.K + k) * p.F + c0 + u),
                      vb);
          p.vbw[o + u] = vb;
        }
        p.a1[o + u] = 0.0f;
        p.a2[o + u] = 0.0f;
        v[u][i] = p.vs[o + u];
      }
    }
    item_terms<FG>(p, sm, tl, q, t0, v);
  });
  consumers_sync(nc);
  {
    const int warp = tid >> 5, nw = nc >> 5;
    for (int t = warp; t < T; t += nw) {
      const float s = frame_sum(sm.red, t, nq);
      if ((tid & 31) == 0) sm.s[t] = s;
    }
  }
  if (p.n_steps > 0) draw(p, sm, tl, 0);
  consumers_sync(nc);

  uint32_t j = 0;                       // ring stages consumed
  for (int m = 0; m < p.burnin; ++m)
    mh_step<MODE, false, FG>(p, sm, j, tl, m, 0);

  // phase boundary: Vs = decode(Z) and 1/Vx at it; s stays as carried
  {
    const float* hsrc = decoder_hidden<FG>(p, sm, j, tl, sm.z);
    layer<FG, false>(p, sm, j, hsrc, layer_geo(p, p.depth),
                     [&](int q, int t0, float (&v)[CC][FG]) {
      out_values<FG>(p, q, v);
      const int c0 = CC * q, ncol = min(CC, p.F - c0);
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const int t = t0 + i;
        const size_t o = tl.row(t, p.N) * p.F + c0;
#pragma unroll
        for (int u = 0; u < CC; ++u) {
          if (u >= ncol) continue;
          p.vs_out[o + u] = v[u][i];
          p.inv[o + u] = recip(p, mix_var(sm.g[t], v[u][i], p.vb[o + u]));
        }
      }
    });
  }
  consumers_sync(nc);                   // the activations are read
  for (int r = 0; r < p.n_steps - p.burnin; ++r)
    mh_step<MODE, true, FG>(p, sm, j, tl, p.burnin + r, r);

  for (int i = tid; i < T * p.L; i += nc) {
    const int t = i / p.L, l = i % p.L;
    p.z_out[tl.row(t, p.N) * p.L + l] = sm.z[l * T + t];
  }
  if (MODE == MODE_E && !VB) {
    // this tile's share of numW = H (X2 s2 mask), denW = H (s1 mask); the
    // accumulators of other threads' items, so after a fence and barrier
    __threadfence_block();
    consumers_sync(nc);
    for (int i = tid; i < p.K * p.F; i += nc) {
      const int k = i / p.F, c = i % p.F;
      float num = 0.0f, den = 0.0f;
      for (int t = 0; t < T; ++t) {
        const size_t o = tl.row(t, p.N) * p.F + c;
        const float hk = sm.hk[k * T + t];
        num = fmaf(hk, __fmul_rn(__fmul_rn(p.x2[o], p.a2[o]), sm.mask[t]), num);
        den = fmaf(hk, __fmul_rn(p.a1[o], sm.mask[t]), den);
      }
      const size_t po = (((size_t)tl.b * n_tiles + tl.tile) * p.K + k) * p.F + c;
      p.part1[po] = num;
      p.part2[po] = den;
    }
  }
}

template <int MODE, bool VB, int FG>
cudaError_t launch(const GParams& p, size_t smem, cudaStream_t st) {
  auto kern = mh_chain_general_kernel<MODE, VB, FG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)(p.B * (p.N / p.T)), p.nc + 32, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MODE, bool VB>
cudaError_t launch_tile(const GParams& p, size_t smem, cudaStream_t st) {
  return item_frames(p.T) == 8 ? launch<MODE, VB, 8>(p, smem, st)
                               : launch<MODE, VB, 4>(p, smem, st);
}

// The launch's plan, or where no tile fits the smallest (for the sizes
// the caller reports).
Plan plan_or_least(int F, int L, const int* hw, int depth, int K) {
  const Plan pl = plan(F, L, hw, depth, K);
  return pl.T ? pl : Plan{4, SLOT_SMALL};
}

bool widths_ok(const int* hw, int depth) {
  if (depth < 1 || depth > MAXD) return false;
  for (int d = 0; d < depth; ++d)
    if (hw[d] < 1) return false;
  return true;
}

}  // namespace

extern "C" {

// Frames a CTA at these shapes (16, 8 or 4; N must be a multiple), 0 where
// no tile fits; hw: the depth hidden widths.
int gvnmf_mh_chain_general_tile(int F, int L, const int* hw, int depth,
                                int K) {
  if (!widths_ok(hw, depth)) return 0;
  return plan(F, L, hw, depth, K).T;
}

// The most hidden layers the kernel takes.
int gvnmf_mh_chain_general_depth() { return MAXD; }

// Threads a CTA at these shapes (consumers and the producer warp), at the
// frame tile the kernel takes (4 where none fits).
int gvnmf_mh_chain_general_block(int F, int L, const int* hw, int depth,
                                 int K) {
  if (!widths_ok(hw, depth)) return 0;
  return consumers(F, plan_or_least(F, L, hw, depth, K).T) + 32;
}

// Dynamic shared memory a CTA (bytes) at these shapes, at the frame tile
// and ring stages the kernel takes (4 frames and SLOT_SMALL where none
// fits, past SMEM_MAX).
long long gvnmf_mh_chain_general_smem(int F, int L, const int* hw,
                                      int depth, int K) {
  if (!widths_ok(hw, depth)) return 0;
  const Plan pl = plan_or_least(F, L, hw, depth, K);
  return 4 * smem_floats(F, L, hw, depth, K, pl.T, pl.slot);
}

// Floats of the packed weight block (pack_general).
long long gvnmf_mh_chain_general_packed(int F, int L, const int* hw,
                                        int depth) {
  if (!widths_ok(hw, depth)) return 0;
  return layer_offset(F, L, hw, depth, depth + 1);
}

// Registers a thread of the E-mode WH kernel at 8 frames an item
// (cudaFuncGetAttributes), into out[0]. Returns the cudaError_t.
int gvnmf_mh_chain_general_registers(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, mh_chain_general_kernel<MODE_E, false, 8>);
  out[0] = fa.numRegs;
  return (int)e;
}

// mode 0 = E (out1 = samples, float32 or, with samples_bf16, bfloat16; WH
// form: out2 / out3 = numW / denW (B, K, F) and part1 / part2 the per-tile
// scratch (B, N / T, K, F); Vb form: out2 / out3 = s1 / s2 (B, N, F));
// mode 1 = WF (out1 = acc_s, out2 = acc_n). A non-null vb selects the Vb
// form (K = 0). wpk: the packed weights (16-byte aligned); bm: depth - 1
// biases of the hidden layers after the first; hw: the depth hidden
// widths. scratch: 5 B N F floats (the proposal, 1/Vx, the WH form's Vb
// and the WH E-mode accumulators). zn / u null: the in-kernel Philox
// stream keyed on `seed`. Returns the cudaError_t of the launches.
int gvnmf_mh_chain_general(
    const float* x2, const float* vb, const float* wt, const float* h,
    const float* mask, const float* g, const float* ypre, const float* z,
    const float* vs, const float* zn, const float* u, const float* wpk,
    const float* const* bm, const float* bo, float* z_out, float* vs_out,
    void* out1, float* out2, float* out3, float* part1, float* part2,
    float* scratch, int B, int N, int F, int L, const int* hw, int depth,
    int K, int n_steps, int burnin, float sqrt_var, int mode,
    unsigned long long seed, int samples_bf16, int approx_recip,
    int approx_trans, int mm_bf16, void* stream) {
  const bool vbf = vb != nullptr;
  if (vbf) K = 0;
  if (!widths_ok(hw, depth) || burnin < 0 || burnin > n_steps || F < 1 ||
      L < 1 || (mode != MODE_E && mode != MODE_WF) ||
      (samples_bf16 && mode != MODE_E) ||
      (reinterpret_cast<uintptr_t>(wpk) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(F, L, hw, depth, K);
  const int T = pl.T;
  if (T == 0 || N % T != 0) return (int)cudaErrorInvalidValue;
  const size_t bnf = (size_t)B * N * F;
  GParams p{};
  p.x2 = x2;
  p.vb = vbf ? vb : scratch + 2 * bnf;
  p.wt = wt;
  p.h = h;
  p.mask = mask;
  p.g = g;
  p.ypre = ypre;
  p.z = z;
  p.vs = vs;
  p.zn = zn;
  p.u = u;
  p.wpk = wpk;
  for (int d = 0; d + 1 < depth; ++d) p.bm[d] = bm[d];
  p.bo = bo;
  p.z_out = z_out;
  p.vs_out = vs_out;
  p.vp = scratch;
  p.inv = scratch + bnf;
  p.vbw = scratch + 2 * bnf;
  if (mode == MODE_WF) {
    p.a1 = static_cast<float*>(out1);
    p.a2 = out2;
  } else if (vbf) {
    p.a1 = out2;
    p.a2 = out3;
  } else {
    p.a1 = scratch + 3 * bnf;
    p.a2 = scratch + 4 * bnf;
  }
  if (mode == MODE_E) {
    if (samples_bf16)
      p.samples_h = static_cast<__nv_bfloat16*>(out1);
    else
      p.samples = static_cast<float*>(out1);
  }
  p.part1 = part1;
  p.part2 = part2;
  p.B = B;
  p.N = N;
  p.F = F;
  p.L = L;
  p.K = K;
  p.depth = depth;
  p.n_steps = n_steps;
  p.burnin = burnin;
  for (int d = 0; d < depth; ++d) p.hw[d] = hw[d];
  p.T = T;
  p.slot = pl.slot;
  p.nfg = frame_groups(T);
  p.nc = consumers(F, T);
  p.sqrt_var = sqrt_var;
  p.seed_lo = (uint32_t)(seed & 0xffffffffull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.approx_recip = approx_recip != 0;
  p.approx_trans = approx_trans != 0;
  p.mm_bf16 = mm_bf16 != 0;
  const size_t smem = 4 * smem_floats(F, L, hw, depth, K, T, pl.slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == MODE_E)
    e = vbf ? launch_tile<MODE_E, true>(p, smem, st)
            : launch_tile<MODE_E, false>(p, smem, st);
  else
    e = vbf ? launch_tile<MODE_WF, true>(p, smem, st)
            : launch_tile<MODE_WF, false>(p, smem, st);
  if (e != cudaSuccess || mode != MODE_E || vbf) return (int)e;
  const int KF = K * F;
  sum_tiles_kernel<<<dim3((KF + 255) / 256, B), 256, 0, st>>>(
      part1, part2, out2, out3, N / T, KF);
  return (int)cudaGetLastError();
}

}  // extern "C"
