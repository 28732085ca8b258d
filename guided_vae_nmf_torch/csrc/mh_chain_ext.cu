// The MH chain (K1) on thread-block clusters for decoders of unequal or
// wider hidden layers: K1e, the extended cluster form.
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: mh_chain_pallas
// (:336, body _make_chain_kernel :121-320) for the decoders the cluster
// form (mh_chain.cu, K1a-K1d) does not take and a cluster of up to 8 CTAs
// holds: hidden layers of different widths ((128, 256), (24, 40)), or of
// one width whose slices pass a CTA's shared memory at 4 CTAs (128 x 4,
// 256 x 2 at F = 513). It computes what mh_chain_ref computes in both
// modes (E with the sample dump and numW / denW or s1 / s2; WF with the
// Wiener sums), both noise forms (WH=, Vb=), with the recorded streams
// and every fast option (bfloat16 dumps, approx_recip, approx_trans,
// bfloat16 decoder products), as the cluster form's kernel with runtime
// options does. The general form (mh_chain_general.cu, K1g) stays for the
// decoders no cluster holds.
//
// What bounds it on an H100: float32 arithmetic, as in the cluster form.
// Per frame and step the decoder costs 2 (L H1 + sum H_i H_i+1 + H_d F)
// FLOP (336 kFLOP for the (128, 256) decoder at F = 513), plus sum H_i
// tanh, F exp and F log, against a few hundred bytes of state; there are
// no tensor cores for exact float32. The decoder's weights (0.4-0.6 MB at
// F = 513) pass a CTA's 227 KB of shared memory, and K1g, which reads them
// from L2 every step, runs at 8.6 % of the operations bound.
//
// The design: the cluster form's, with the cluster size a launch
// parameter (CL = 4 or 8 CTAs, the smallest whose CTA fits: fewer CTAs a
// cluster keep more clusters resident; the wrapper sets it with
// cudaLaunchAttributeClusterDimension) and every hidden layer sliced on
// its own:
//   * CTA `rank` owns the output bins [r Fsl, (r+1) Fsl), Fsl = ceil(F /
//     CL), and of each hidden layer d the units [r Hsl_d, (r+1) Hsl_d),
//     Hsl_d = ceil(H_d / CL), each with its own padded row length. The
//     wrapper packs each rank's weights into one 16-byte aligned block (its
//     columns of wo and bo, of w1 and of every later layer's weights and
//     bias: `pack_weights(dec_w, cluster)` in mcem/mh_chain.py, once per
//     mcem_batch_fused call); one bulk asynchronous copy (cp.async.bulk
//     with an mbarrier) brings it into shared memory at the start of the
//     launch, where it stays: no step reads a weight from global memory.
//   * each thread owns 4 columns x 4 frames of the output layer (the
//     cluster form's register tile; a rank's last 1-3 columns, such as the
//     65th of F = 513 on 8 CTAs, go to light items of their own, so no
//     warp scheduler gets a second full warp of output work) and keeps
//     their X2, Vb, proposal, accepted Vs and accepted 1/Vx in registers;
//     the two accumulators of the rank's column slice live in shared
//     memory (each element one thread's). Holding X2 and Vb in registers,
//     where the cluster form keeps them in shared memory, takes 8.4 KB a
//     frame column off a CTA: enough for the 128 x 4 decoder at F = 513 to
//     fit 4-CTA clusters (2 waves at B = 4, N = 384 where 8-CTA clusters
//     take 4). Nothing per (frame, bin) goes to global memory between
//     steps but the E-mode dump.
//   * a CTA has at least 256 threads (8 warps) for the draws, the data
//     term and the updates, where the output layer needs fewer (5 warps
//     on 8-CTA clusters at F = 513).
//   * each hidden layer: every CTA computes its units for the cluster's 32
//     frames from its resident weight columns and writes them into every
//     CTA's activation buffer through distributed shared memory; a cluster
//     barrier (arrive after the writes, wait before the reads) separates
//     the layers. Layers alternate between two buffers, each as tall as
//     the widest layer that uses it.
//   * the per-frame data term: per-warp sums written into every CTA, one
//     cluster barrier, and every CTA adds the (rank, warp) partials in the
//     same fixed order, so all CTAs hold bit-identical s, sp and accept
//     decisions; they draw the same normals and uniforms from the same
//     Philox counters (chain_common.cuh), so the chain state needs no
//     exchange. A frame's sums depend only on its position in its tile
//     pair and on the shapes, never on the batch.
//   * every CTA writes its own (K, slice) numW / denW partials per tile
//     and a second kernel sums them over tiles in a fixed order. No float
//     atomics.
// Each hidden and output sum runs over its input dimension in order, one
// FMA after another, as the plain version's matrix product sums it.
// Elementwise expressions use explicitly rounded multiplies and adds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 16;       // frames per tile: N % TILE == 0
constexpr int T = 2 * TILE;    // frames per cluster: two tiles of one utterance
constexpr int CC = 4;          // output-layer columns per thread
constexpr int FG = 4;          // output-layer frames per thread
constexpr int NFG = T / FG;    // frame groups
constexpr int HU = 2;          // hidden units per hidden-layer work item
constexpr int FGH = 4;         // frames per hidden-layer work item (read
                               // and pushed as one float4)
constexpr int NFGH = T / FGH;
constexpr int MIN_NT = 256;    // smallest block: eight warps for the
                               // draws, the data term and the updates
                               // where the output layer needs fewer
constexpr int MAXD = 4;        // hidden layers
constexpr int MAX_NT = 320;    // largest block (Fsl <= 160)
constexpr int COPY_CHUNK = 32768;  // bytes per bulk copy
constexpr float VX_FLOOR = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_E = 0, MODE_WF = 1 };

struct Params {
  const float* x2;    // (B, N, F)
  const float* vb;    // (B, N, F), Vb form
  const float* wt;    // (B, K, F), WH form
  const float* h;     // (B, K, N), WH form
  const float* mask;  // (B, N), E-mode of the WH form
  const float* g;     // (B, N)
  const float* ypre;  // (B, N, H1)
  const float* z;     // (B, N, L)
  const float* vs;    // (B, N, F), decode(Z)
  const float* zn;    // (B, n_steps, N, L), inject only
  const float* u;     // (B, n_steps, N), inject only
  const float* packed;  // (CL, P) per-rank weight blocks
  float* z_out;       // (B, N, L)
  float* vs_out;      // (B, N, F)
  float* out1;        // E: samples (B, R, N, F); WF: acc_s (B, N, F)
  float* out2;        // WF: acc_n (B, N, F); E, Vb form: s1 (B, N, F)
  float* out3;        // E, Vb form: s2 (B, N, F)
  float* part1;       // E, WH form: numW partials (B, n_tiles, K, F)
  float* part2;       // E, WH form: denW partials (B, n_tiles, K, F)
  int B, N, F, L, K, depth, n_steps, burnin, CL;
  int hw[MAXD];       // hidden widths H1 .. H_depth
  float sqrt_var;
  uint32_t seed_lo, seed_hi;
  __nv_bfloat16* out1h;  // E: bfloat16 samples in place of out1, or null
  int approx_recip, approx_trans;
  int mm_bf16;        // decoder products on bfloat16 operands
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// Launch geometry and the per-rank weight block, from the shapes alone.
struct Geo {
  int Fsl, Fsp;   // bins per rank, padded row length in shared memory
  int nq;         // column quads per rank (Fsp / 4)
  int nt, nw;     // threads and warps per CTA
  int P;          // floats in a rank's weight block
  int rowsA, rowsB;  // rows of the two activation buffers
};

__host__ __device__ inline int unit_slice(int H, int CL) {
  return cdiv(H, CL);
}

__host__ __device__ inline Geo geometry(int F, int L, const int* hw,
                                        int depth, int CL) {
  Geo g;
  g.Fsl = cdiv(F, CL);
  g.Fsp = round4(g.Fsl);
  g.nq = g.Fsp / CC;
  const int nt = 32 * cdiv(NFG * g.nq, 32);
  g.nt = nt < MIN_NT ? MIN_NT : nt;
  g.nw = g.nt / 32;
  // wo [H_depth][Fsp] | bo [Fsp] | w1 [L][Hsp_1] | (w_d [H_d-1][Hsp_d] |
  // b_d [Hsp_d]) per hidden layer after the first; every term a multiple
  // of 4
  g.P = hw[depth - 1] * g.Fsp + g.Fsp + L * round4(unit_slice(hw[0], CL));
  g.rowsA = 0;
  g.rowsB = 0;
  for (int d = 0; d < depth; ++d) {
    const int hsp = round4(unit_slice(hw[d], CL));
    if (d > 0) g.P += hw[d - 1] * hsp + hsp;
    if (d % 2 == 0)
      g.rowsA = hw[d] > g.rowsA ? hw[d] : g.rowsA;
    else
      g.rowsB = hw[d] > g.rowsB ? hw[d] : g.rowsB;
  }
  return g;
}

// Shared-memory carve-up of one CTA (floats; every offset is a multiple of
// 4, so rows can be read as float4 and the weight block is a valid
// bulk-copy destination).
struct Smem {
  float *wo, *bo, *w1, *wmid;  // the rank's weight block; wmid: layer 2's
                               // weights, each later layer after the last
  float *a1, *a2;             // [T][Fsp]: s1/s2 (E) or acc_s/acc_n (WF)
  float *hA, *hB;             // [rowsA][T], [rowsB][T], written by every rank
  float *ypre;                // [Hsp_1][T], this rank's first-layer units
  float *z, *zp, *zn;         // [L][T]; zn: the next proposal's normals
  float *hk;                  // [K][T] H tiles
  float *red;                 // [CL][nw][T] per-warp frame sums
  float *g, *mask, *s, *acc, *dz;  // [T]
  float* logu;                // [2][T] accept-test log u, by step parity
  uint64_t* bar;              // the weight block's mbarrier
};

__host__ __device__ inline size_t smem_floats(const Geo& g, int L,
                                              const int* hw, int K, int CL) {
  return (size_t)g.P + 2 * T * g.Fsp + (size_t)(g.rowsA + g.rowsB) * T +
         round4(unit_slice(hw[0], CL)) * T + 3 * L * T + round4(K) * T +
         CL * g.nw * T + 7 * T + 4;
}

__device__ inline Smem carve(float* base, const Params& p, const Geo& g) {
  Smem s;
  const int hd = p.hw[p.depth - 1];
  s.wo = base;
  s.bo = s.wo + hd * g.Fsp;
  s.w1 = s.bo + g.Fsp;
  s.wmid = s.w1 + p.L * round4(unit_slice(p.hw[0], p.CL));
  s.a1 = base + g.P;
  s.a2 = s.a1 + T * g.Fsp;
  s.hA = s.a2 + T * g.Fsp;
  s.hB = s.hA + g.rowsA * T;
  s.ypre = s.hB + g.rowsB * T;
  s.z = s.ypre + round4(unit_slice(p.hw[0], p.CL)) * T;
  s.zp = s.z + p.L * T;
  s.zn = s.zp + p.L * T;
  s.hk = s.zn + p.L * T;
  s.red = s.hk + round4(p.K) * T;
  s.g = s.red + p.CL * g.nw * T;
  s.mask = s.g + T;
  s.s = s.mask + T;
  s.acc = s.s + T;
  s.dz = s.acc + T;
  s.logu = s.dz + T;
  s.bar = reinterpret_cast<uint64_t*>(s.logu + 2 * T);
  return s;
}

#include "chain_common.cuh"

// 1/Vx: rcp.approx under approx_recip (OPTS kernel), else IEEE division.
template <bool OPTS>
__device__ __forceinline__ float recip(const Params& p, float x) {
  return (OPTS && p.approx_recip) ? rcp_approx(x) : 1.0f / x;
}

// log in the data term and the accept test: fast_log under approx_trans
// (OPTS kernel), else logf.
template <bool OPTS>
__device__ __forceinline__ float log_k(const Params& p, float x) {
  return (OPTS && p.approx_trans) ? fast_log(x) : logf(x);
}

// ---------------------------------------------------------------------------
// Cluster primitives
// ---------------------------------------------------------------------------

// Split cluster barrier: arrive (release: this thread's shared-memory
// writes, local and remote, become visible) and wait (acquire). Every
// thread of every CTA of the cluster calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// `ptr` (this CTA's shared memory) mapped into CTA `rank` of the cluster.
template <typename V>
__device__ __forceinline__ V* peer(V* ptr, int rank) {
  return cg::this_cluster().map_shared_rank(ptr, rank);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: start the bulk copy of this rank's weight block into shared
// memory; completion arrives on `bar` (phase 0).
__device__ __forceinline__ void load_weights(float* dst, const float* src,
                                             int n_floats, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  const uint32_t bytes = (uint32_t)n_floats * 4u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  for (uint32_t off = 0; off < bytes; off += COPY_CHUNK) {
    const uint32_t n = bytes - off < COPY_CHUNK ? bytes - off : COPY_CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst) + off),
           "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void wait_weights(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(0) : "memory");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c ? a : b as one selp the optimiser cannot turn into an indexed load.
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// The cluster's frames: two tiles of utterance b. With an odd tile count
// the last cluster of an utterance repeats its first tile as the second,
// computes it alongside and writes nothing of it.
struct Frames {
  int b, tile0, tile1;
  __device__ int n(int t) const {
    return (t < TILE ? tile0 : tile1) * TILE + (t & (TILE - 1));
  }
  __device__ size_t row(int t, int N) const { return (size_t)b * N + n(t); }
  __device__ bool live(int t) const { return t < TILE || tile1 != tile0; }
};

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// FGH consecutive frames of a [rows][T] activation row, read as one vector.
__device__ __forceinline__ void ldv(const float* p, float (&x)[FGH]) {
  const float4 v = ld4(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// ... and written into the same place in every CTA of the cluster.
__device__ __forceinline__ void st_peers(float* p, const float (&x)[FGH],
                                         int CL) {
  const float4 v = make_float4(x[0], x[1], x[2], x[3]);
  for (int r = 0; r < CL; ++r) *peer(reinterpret_cast<float4*>(p), r) = v;
}

// One hidden layer: this rank's units j0 + j (j < Hs) for the cluster's
// frames, h = tanh(in . w[:, j] + bias), bias = ypre (first layer,
// [Hsp][T]) or the layer's bias; written into `out` ([H][T]) of every CTA
// of the cluster. A work item is HU units x FGH frames; neighbouring lanes
// take neighbouring frame groups of the same units. Each sum runs over
// the input dimension in order. RND_IN rounds the input operand to
// bfloat16 as it is read (the first layer under mm_bf16), RND_OUT the
// output as it is written.
template <bool RND_IN, bool RND_OUT>
__device__ __forceinline__ void hidden_layer(const float* in, int kin,
                                             const float* w, int Hsp,
                                             const float* bias,
                                             const float* ypre, float* out,
                                             int Hs, int j0, int CL) {
  const int nu = (Hs + HU - 1) / HU;
  for (int it = threadIdx.x; it < nu * NFGH; it += blockDim.x) {
    const int j = HU * (it / NFGH), f0 = FGH * (it % NFGH);
    float a[HU][FGH];
#pragma unroll
    for (int u = 0; u < HU; ++u)
#pragma unroll
      for (int i = 0; i < FGH; ++i) a[u][i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kin; ++k) {
      const float2 w2 = *reinterpret_cast<const float2*>(w + k * Hsp + j);
      const float wk[HU] = {w2.x, w2.y};
      float x[FGH];
      ldv(in + k * T + f0, x);
      if (RND_IN) {
#pragma unroll
        for (int i = 0; i < FGH; ++i) x[i] = bf16_round(x[i]);
      }
#pragma unroll
      for (int u = 0; u < HU; ++u)
#pragma unroll
        for (int i = 0; i < FGH; ++i)
          a[u][i] = fmaf(x[i], wk[u], a[u][i]);
    }
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      if (j + u >= Hs) break;
      float hv[FGH];
#pragma unroll
      for (int i = 0; i < FGH; ++i) {
        const float bv = ypre ? ypre[(j + u) * T + f0 + i] : bias[j + u];
        hv[i] = tanhf(__fadd_rn(a[u][i], bv));
        if (RND_OUT) hv[i] = bf16_round(hv[i]);
      }
      st_peers(out + (j0 + j + u) * T + f0, hv, CL);
    }
  }
}

// 0.5 sum_l (Z^2 - Zp^2) of each frame: a warp per frame.
__device__ __forceinline__ void latent_prior_terms(const float* z,
                                                   const float* zp, int L,
                                                   float* dz, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += nw) {
    float d = 0.0f;
    for (int l = lane; l < L; l += 32) {
      const float a = z[l * T + t], b = zp[l * T + t];
      d = __fadd_rn(d, __fsub_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      d = __fadd_rn(d, __shfl_xor_sync(FULL, d, off));
    if (lane == 0) dz[t] = __fmul_rn(0.5f, d);
  }
}

// The hidden stack on the [L][T] latent tile `zin`; returns the buffer
// holding the last hidden layer, complete in every CTA (a cluster barrier
// follows each layer). Layer d writes hA (d even) or hB (d odd). With
// `prior`, the proposal's latent prior term (zin = Zp) is reduced while
// the first layer's barrier settles.
template <bool RND>
__device__ const float* hidden_stack(const Params& p, const Smem& sm,
                                     const float* zin, int rank,
                                     int nw, bool prior) {
  const int CL = p.CL;
  int hsl = unit_slice(p.hw[0], CL);
  hidden_layer<RND, RND>(zin, p.L, sm.w1, round4(hsl), nullptr, sm.ypre,
                         sm.hA, max(0, min(hsl, p.hw[0] - rank * hsl)),
                         rank * hsl, CL);
  cluster_arrive();
  if (prior) latent_prior_terms(sm.z, sm.zp, p.L, sm.dz, nw);
  cluster_wait();
  float* src = sm.hA;
  float* dst = sm.hB;
  const float* w = sm.wmid;
  for (int d = 1; d < p.depth; ++d) {
    const int kin = p.hw[d - 1], hout = p.hw[d];
    hsl = unit_slice(hout, CL);
    const int hsp = round4(hsl);
    hidden_layer<false, RND>(src, kin, w, hsp, w + kin * hsp, nullptr, dst,
                             max(0, min(hsl, hout - rank * hsl)),
                             rank * hsl, CL);
    w += kin * hsp + hsp;
    cluster_arrive();
    cluster_wait();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// The hidden stack in float32, or with bfloat16 operands under mm_bf16
// (OPTS kernel only).
template <bool OPTS>
__device__ __forceinline__ const float* decoder_hidden(
    const Params& p, const Smem& sm, const float* zin, int rank, int nw,
    bool prior) {
  if (OPTS && p.mm_bf16)
    return hidden_stack<true>(p, sm, zin, rank, nw, prior);
  return hidden_stack<false>(p, sm, zin, rank, nw, prior);
}

// Per-thread position in the output layer: columns CC cq .. CC cq + 3 of
// the slice (the first `ncol` of them in range) for frames t0 .. t0 + 3.
// A thread's item of the output layer. The rank's Fsl columns are
// floor(Fsl / 4) full quads, each taken by NFG threads (one a frame group),
// and, where Fsl is not a multiple of 4, a tail quad of 1-3 columns taken
// by the NFG threads after them, which compute only its columns: at F = 513
// every rank has 64 + 1 columns (8 CTAs) or 128 + 1 (4 CTAs), and a tail
// item as heavy as a full one would give one of the SM's four schedulers
// a second full warp of output-layer work.
struct Pos {
  int cq, t0, fg, ncol;
  bool tail;
};

template <int NC>
__device__ __forceinline__ void out_tail(const Params& p, const Geo& g,
                                         const Smem& sm, const float* h,
                                         const float* w,
                                         float (&v)[CC][FG]) {
  const int hd = p.hw[p.depth - 1];
#pragma unroll 4
  for (int k = 0; k < hd; ++k) {
    const float4 hk = ld4(h + k * T);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float wk = w[k * g.Fsp + j];
#pragma unroll
      for (int i = 0; i < FG; ++i)
        v[j][i] = fmaf(f4get(hk, i), wk, v[j][i]);
    }
  }
}

// Output layer for this thread's columns x 4 frames:
// v[j][i] = exp(h[t0+i] . wo[:, c_j] + bo[c_j]), the sum over the last
// hidden layer in order; the full items' k-loop reads k+1's operands while
// k's 16 FMAs run.
template <bool OPTS>
__device__ __forceinline__ void out_layer(const Params& p, const Geo& g,
                                          const Smem& sm, const float* hsrc,
                                          const Pos& ps,
                                          float (&v)[CC][FG]) {
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < FG; ++i) v[j][i] = 0.0f;
  const int hd = p.hw[p.depth - 1];
  const float* w = sm.wo + CC * ps.cq;
  const float* h = hsrc + ps.t0;
  if (ps.tail) {
    if (ps.ncol == 1)
      out_tail<1>(p, g, sm, h, w, v);
    else if (ps.ncol == 2)
      out_tail<2>(p, g, sm, h, w, v);
    else if (ps.ncol == 3)
      out_tail<3>(p, g, sm, h, w, v);
    const float* b = sm.bo + CC * ps.cq;
#pragma unroll
    for (int j = 0; j < CC; ++j)
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const float x = __fadd_rn(v[j][i], j < ps.ncol ? b[j] : 0.0f);
        v[j][i] = (OPTS && p.approx_trans) ? fast_exp(x) : expf(x);
      }
    return;
  }
  float4 wk = ld4(w), hk = ld4(h);
#pragma unroll 4
  for (int k = 1; k < hd; ++k) {
    const float4 wn = ld4(w + k * g.Fsp), hn = ld4(h + k * T);
#pragma unroll
    for (int j = 0; j < CC; ++j)
#pragma unroll
      for (int i = 0; i < FG; ++i)
        v[j][i] = fmaf(f4get(hk, i), f4get(wk, j), v[j][i]);
    wk = wn;
    hk = hn;
  }
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < FG; ++i)
      v[j][i] = fmaf(f4get(hk, i), f4get(wk, j), v[j][i]);
  const float4 b = ld4(sm.bo + CC * ps.cq);
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < FG; ++i) {
      const float x = __fadd_rn(v[j][i], f4get(b, j));
      v[j][i] = (OPTS && p.approx_trans) ? fast_exp(x) : expf(x);
    }
}

__device__ __forceinline__ float mix_var(float g, float vs, float vb) {
  return fmaxf(__fadd_rn(__fmul_rn(g, vs), vb), VX_FLOOR);
}

// This thread's X2 and Vb, [column][frame], in registers for the launch.
struct Bins {
  float x2[CC][FG], vb[CC][FG];
};

// This thread's share of the per-frame data terms:
// part[i] = sum over its columns c_j of log Vx + X2 / Vx at frame t0 + i.
template <bool OPTS, bool TRANS>
__device__ __forceinline__ void data_terms_t(const Params& p, const Smem& sm,
                                             const Bins& bn,
                                             const float (&v)[CC][FG],
                                             const Pos& ps,
                                             float (&part)[FG]) {
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const float gt = sm.g[ps.t0 + i];
    part[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      if (j < ps.ncol) {
        const float vx = mix_var(gt, v[j][i], bn.vb[j][i]);
        const float iv = recip<OPTS>(p, vx);
        const float lv = TRANS ? fast_log(vx) : logf(vx);
        part[i] = __fadd_rn(part[i], __fadd_rn(lv, __fmul_rn(iv, bn.x2[j][i])));
      }
    }
  }
}

template <bool OPTS>
__device__ __forceinline__ void data_terms(const Params& p, const Smem& sm,
                                           const Bins& bn,
                                           const float (&v)[CC][FG],
                                           const Pos& ps, float (&part)[FG]) {
  if (OPTS && p.approx_trans)
    data_terms_t<OPTS, true>(p, sm, bn, v, ps, part);
  else
    data_terms_t<OPTS, false>(p, sm, bn, v, ps, part);
}

// One level of the warp's transpose-reduction: a lane keeps half of its
// HALF x 2 frames and adds its partner's (lane ^ HALF) copy of them.
template <int HALF>
__device__ __forceinline__ void transpose_level(float (&part)[T], int lane,
                                                int& frame) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = pick(upper, part[j], part[j + HALF]);
    const float keep = pick(upper, part[j + HALF], part[j]);
    part[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, HALF));
  }
  frame += upper ? HALF : 0;
}

// Per-warp sums of the lanes' parts for each of the T frames, written into
// red[rank][warp][frame] of every CTA of the cluster. The caller's cluster
// barrier follows.
__device__ __forceinline__ void publish_frame_sums(const float (&mine)[FG],
                                                   int fg, float* red,
                                                   int rank, int nw,
                                                   int CL) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float part[T];
#pragma unroll
  for (int f = 0; f < T; ++f) part[f] = fg == f / FG ? mine[f % FG] : 0.0f;
  int frame = 0;
  transpose_level<16>(part, lane, frame);
  transpose_level<8>(part, lane, frame);
  transpose_level<4>(part, lane, frame);
  transpose_level<2>(part, lane, frame);
  transpose_level<1>(part, lane, frame);
  float* dst = red + (rank * nw + warp) * T + frame;
  for (int r = 0; r < CL; ++r) *peer(dst, r) = part[0];
}

// Frame t's sum over the cluster: the (rank, warp) partials in a fixed
// order, the same in every CTA.
__device__ __forceinline__ float cluster_frame_sum(const float* red, int n,
                                                   int t) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s = __fadd_rn(s, red[i * T + t]);
  return s;
}

// The random numbers of step m: the proposal normals into zn ([L][T]) and
// the accept test's log u into logu[m & 1]. Drawn one step ahead, while a
// cluster barrier settles.
template <bool OPTS>
__device__ __forceinline__ void draw(const Params& p, const Smem& sm,
                                     const Frames& fr, int m) {
  const bool inject = OPTS && p.zn != nullptr;
  const int nd = (p.L + 3) / 4;
  for (int i = threadIdx.x; i < T * nd + T; i += blockDim.x) {
    if (i < T * nd) {
      const int t = i / nd, q = i % nd;
      float4 nz;
      if (inject) {
        const float* zn =
            p.zn + ((size_t)(fr.b * p.n_steps + m) * p.N + fr.n(t)) * p.L;
        float tmp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tmp[j] = 4 * q + j < p.L ? zn[4 * q + j] : 0.0f;
        nz = make_float4(tmp[0], tmp[1], tmp[2], tmp[3]);
      } else {
        nz = normals4(p.seed_lo, p.seed_hi, fr.b, fr.n(t), m, q,
                      OPTS && p.approx_trans);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < p.L) sm.zn[(4 * q + j) * T + t] = f4get(nz, j);
    } else {
      const int t = i - T * nd;
      const float u =
          inject ? p.u[(size_t)(fr.b * p.n_steps + m) * p.N + fr.n(t)]
                 : accept_uniform(p.seed_lo, p.seed_hi, fr.b, fr.n(t), m);
      sm.logu[(m & 1) * T + t] = log_k<OPTS>(p, u);
    }
  }
}

// Proposal Zp = Z + sqrt(var) n.
__device__ __forceinline__ void propose(const Params& p, const Smem& sm) {
  const int nd = (p.L + 3) / 4;
  for (int i = threadIdx.x; i < T * nd; i += blockDim.x) {
    const int t = i / nd, q = i % nd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = 4 * q + j;
      if (l < p.L)
        sm.zp[l * T + t] = __fadd_rn(sm.z[l * T + t],
                                     __fmul_rn(p.sqrt_var, sm.zn[l * T + t]));
    }
  }
}

// The sampling phase's update after the accept decision, thread-local:
// the accepted Vs and 1/Vx of this thread's (column, frame) pairs, the
// E-mode sample dump r and the accumulators.
template <int MODE, bool OPTS>
__device__ __forceinline__ void sample_update(const Params& p, const Geo& g,
                                              const Smem& sm, const Bins& bn,
                                              const Frames& fr, int c0,
                                              const Pos& ps, int r,
                                              const float (&v)[CC][FG],
                                              float (&vs)[CC][FG],
                                              float (&inv)[CC][FG]) {
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = ps.t0 + i;
    const bool acc = sm.acc[t] != 0.0f;
    const size_t so =
        ((size_t)(fr.b * (p.n_steps - p.burnin) + r) * p.N + fr.n(t)) * p.F +
        c0 + CC * ps.cq;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      if (j >= ps.ncol) continue;
      const int o = t * g.Fsp + CC * ps.cq + j;
      if (acc) {
        vs[j][i] = v[j][i];
        inv[j][i] = recip<OPTS>(p, mix_var(sm.g[t], v[j][i], bn.vb[j][i]));
      }
      if (MODE == MODE_E) {
        if (fr.live(t)) {
          if (OPTS && p.out1h != nullptr)
            p.out1h[so + j] = __float2bfloat16_rn(vs[j][i]);
          else
            p.out1[so + j] = vs[j][i];
        }
        sm.a1[o] = __fadd_rn(sm.a1[o], inv[j][i]);
        sm.a2[o] = __fadd_rn(sm.a2[o], __fmul_rn(inv[j][i], inv[j][i]));
      } else {
        const float tt = __fmul_rn(bn.vb[j][i], inv[j][i]);
        sm.a2[o] = __fadd_rn(sm.a2[o], tt);                    // acc_n
        sm.a1[o] = __fadd_rn(sm.a1[o], __fsub_rn(1.0f, tt));   // acc_s
      }
    }
  }
}

// One MH step at global step index m. SAMPLE selects the sampling phase,
// which also updates the accepted Vs / 1/Vx registers and the
// accumulators.
template <int MODE, bool OPTS, bool SAMPLE>
__device__ __forceinline__ void mh_step(const Params& p, const Geo& g,
                                       const Smem& sm, const Bins& bn,
                                       const Frames& fr, int c0, int rank,
                                       const Pos& ps, int m, int r,
                                       float (&vs)[CC][FG],
                                       float (&inv)[CC][FG]) {
  propose(p, sm);
  __syncthreads();
  float v[CC][FG];
  out_layer<OPTS>(p, g, sm,
                  decoder_hidden<OPTS>(p, sm, sm.zp, rank, g.nw, true), ps,
                  v);
  // proposal data term sp = sum_f log Vxp + X2 / Vxp, over the cluster
  {
    float part[FG];
    data_terms<OPTS>(p, sm, bn, v, ps, part);
    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw, p.CL);
  }
  cluster_arrive();
  if (m + 1 < p.n_steps) draw<OPTS>(p, sm, fr, m + 1);
  cluster_wait();
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const float sp = cluster_frame_sum(sm.red, p.CL * g.nw, t);
    const float a = __fadd_rn(__fsub_rn(sm.s[t], sp), sm.dz[t]);
    const bool accept = sm.logu[(m & 1) * T + t] < a;
    sm.acc[t] = accept ? 1.0f : 0.0f;
    if (accept) sm.s[t] = sp;
  }
  __syncthreads();
  const int nd = (p.L + 3) / 4;
  for (int i = threadIdx.x; i < T * nd; i += blockDim.x) {
    const int t = i / nd, q = i % nd;
    if (sm.acc[t] != 0.0f) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * q + j;
        if (l < p.L) sm.z[l * T + t] = sm.zp[l * T + t];
      }
    }
  }
  if (SAMPLE)
    sample_update<MODE, OPTS>(p, g, sm, bn, fr, c0, ps, r, v, vs, inv);
}

// VB selects the Vb form: Vb rows are read from p.vb, and E-mode writes
// s1 / s2 per (frame, bin) instead of the H-contracted partials. OPTS: the
// kernel with runtime options (recorded streams, fast options, bfloat16
// products); the exact kernel has code for none of them. One cluster of
// CL CTAs per two tiles of an utterance; the grid is 1-D.
template <int MODE, bool VB, bool OPTS>
__global__ void __launch_bounds__(MAX_NT, 1) mh_chain_ext_kernel(Params p) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x, NT = blockDim.x;
  const Geo g = geometry(p.F, p.L, p.hw, p.depth, p.CL);
  const Smem sm = carve(reinterpret_cast<float*>(smem_raw), p, g);
  const int rank = (int)cg::this_cluster().block_rank();
  const int n_tiles = p.N / TILE, pairs = cdiv(n_tiles, 2);
  const int cid = blockIdx.x / p.CL;
  Frames fr;
  fr.b = cid / pairs;
  fr.tile0 = 2 * (cid % pairs);
  fr.tile1 = min(fr.tile0 + 1, n_tiles - 1);
  const int c0 = rank * g.Fsl;
  const int Fs = max(0, min(g.Fsl, p.F - c0));
  const int hsl1 = unit_slice(p.hw[0], p.CL), j01 = rank * hsl1;
  const int Hs1 = max(0, min(hsl1, p.hw[0] - j01));
  Pos ps;
  const int nqf = g.Fsl / CC, n_full = NFG * nqf;
  ps.tail = tid >= n_full;
  ps.fg = ps.tail ? tid - n_full : tid / nqf;
  ps.cq = ps.tail ? nqf : tid - ps.fg * nqf;
  ps.ncol = ps.fg < NFG ? max(0, min(CC, Fs - CC * ps.cq)) : 0;
  ps.t0 = FG * min(ps.fg, NFG - 1);

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(sm.bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) load_weights(sm.wo, p.packed + (size_t)rank * g.P, g.P, sm.bar);

  if (tid < T) {
    sm.g[tid] = p.g[fr.row(tid, p.N)];
    sm.mask[tid] = (MODE == MODE_E && !VB) ? p.mask[fr.row(tid, p.N)] : 0.0f;
  }
  if (!VB)
    for (int i = tid; i < p.K * T; i += NT)
      sm.hk[i] = p.h[((size_t)fr.b * p.K + i / T) * p.N + fr.n(i % T)];
  for (int i = tid; i < T * p.L; i += NT) {
    const int t = i / p.L, l = i % p.L;
    sm.z[l * T + t] = p.z[fr.row(t, p.N) * p.L + l];
  }
  for (int i = tid; i < T * Hs1; i += NT) {
    const int t = i / Hs1, j = i % Hs1;
    sm.ypre[j * T + t] = p.ypre[fr.row(t, p.N) * p.hw[0] + j01 + j];
  }
  for (int i = tid; i < T * g.Fsp; i += NT) {
    sm.a1[i] = 0.0f;
    sm.a2[i] = 0.0f;
  }
  __syncthreads();
  // this thread's X2 and Vb (Vb = H^T Wt in the WH form)
  Bins bn;
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = ps.t0 + i;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      bn.x2[j][i] = 0.0f;
      bn.vb[j][i] = 1.0f;
      if (j < ps.ncol) {
        const int c = c0 + CC * ps.cq + j;
        const size_t gi = fr.row(t, p.N) * p.F + c;
        bn.x2[j][i] = p.x2[gi];
        float vb = 0.0f;
        if (VB) {
          vb = p.vb[gi];
        } else {
          for (int k = 0; k < p.K; ++k)
            vb = fmaf(sm.hk[k * T + t],
                      __ldg(p.wt + ((size_t)fr.b * p.K + k) * p.F + c), vb);
        }
        bn.vb[j][i] = vb;
      }
    }
  }
  // every CTA of the cluster is running and its tiles are loaded before
  // any remote write
  cluster_sync();

  // initial data term from the caller's Vs (= decode(Z))
  {
    float v0[CC][FG], part[FG];
#pragma unroll
    for (int i = 0; i < FG; ++i)
#pragma unroll
      for (int j = 0; j < CC; ++j)
        v0[j][i] = j < ps.ncol ? p.vs[fr.row(ps.t0 + i, p.N) * p.F + c0 +
                                      CC * ps.cq + j]
                               : 1.0f;
    data_terms<OPTS>(p, sm, bn, v0, ps, part);
    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw, p.CL);
  }
  cluster_sync();
  if (tid < T) sm.s[tid] = cluster_frame_sum(sm.red, p.CL * g.nw, tid);
  if (p.n_steps > 0) draw<OPTS>(p, sm, fr, 0);
  wait_weights(sm.bar);

  float vs[CC][FG], inv[CC][FG];
  for (int m = 0; m < p.burnin; ++m)
    mh_step<MODE, OPTS, false>(p, g, sm, bn, fr, c0, rank, ps, m, 0, vs,
                               inv);

  // phase boundary: Vs = decode(Z), 1/Vx at it; s stays as carried
  __syncthreads();
  out_layer<OPTS>(p, g, sm,
                  decoder_hidden<OPTS>(p, sm, sm.z, rank, g.nw, false), ps,
                  vs);
#pragma unroll
  for (int i = 0; i < FG; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const int t = ps.t0 + i;
      inv[j][i] = j < ps.ncol
                      ? recip<OPTS>(p, mix_var(sm.g[t], vs[j][i], bn.vb[j][i]))
                      : 0.0f;
    }
  // no CTA writes the next step's activations while a peer still reads
  cluster_sync();
  for (int r = 0; r < p.n_steps - p.burnin; ++r)
    mh_step<MODE, OPTS, true>(p, g, sm, bn, fr, c0, rank, ps, p.burnin + r,
                              r, vs, inv);
  __syncthreads();

  for (int i = tid; i < T * p.L; i += NT) {
    const int t = i / p.L, l = i % p.L;
    if (fr.live(t)) p.z_out[fr.row(t, p.N) * p.L + l] = sm.z[l * T + t];
  }
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = ps.t0 + i;
    if (!fr.live(t)) continue;
#pragma unroll
    for (int j = 0; j < CC; ++j)
      if (j < ps.ncol)
        p.vs_out[fr.row(t, p.N) * p.F + c0 + CC * ps.cq + j] = vs[j][i];
  }
  if (MODE == MODE_WF || VB) {
    // WF: acc_s / acc_n; E, Vb form: s1 / s2
    float* o1 = MODE == MODE_WF ? p.out1 : p.out2;
    float* o2 = MODE == MODE_WF ? p.out2 : p.out3;
    for (int i = tid; i < T * Fs; i += NT) {
      const int t = i / Fs, c = i % Fs;
      if (!fr.live(t)) continue;
      const size_t gi = fr.row(t, p.N) * p.F + c0 + c;
      o1[gi] = sm.a1[t * g.Fsp + c];
      o2[gi] = sm.a2[t * g.Fsp + c];
    }
  } else {
    // each tile's share of numW = H (X2 s2 mask), denW = H (s1 mask)
    const int n_sub = fr.tile1 != fr.tile0 ? 2 : 1;
    for (int i = tid; i < n_sub * p.K * Fs; i += NT) {
      const int st = i / (p.K * Fs), k = (i / Fs) % p.K, c = i % Fs;
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int tt = 0; tt < TILE; ++tt) {
        const int t = st * TILE + tt;
        const int o = t * g.Fsp + c;
        const float hk = sm.hk[k * T + t];
        const float x2 = p.x2[fr.row(t, p.N) * p.F + c0 + c];
        num = fmaf(hk, __fmul_rn(__fmul_rn(x2, sm.a2[o]), sm.mask[t]), num);
        den = fmaf(hk, __fmul_rn(sm.a1[o], sm.mask[t]), den);
      }
      const int tile = st ? fr.tile1 : fr.tile0;
      const size_t po =
          (((size_t)fr.b * n_tiles + tile) * p.K + k) * p.F + c0 + c;
      p.part1[po] = num;
      p.part2[po] = den;
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_sync();
}

template <int MODE, bool VB, bool OPTS>
cudaError_t prepare(size_t smem) {
  auto kern = mh_chain_ext_kernel<MODE, VB, OPTS>;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaLaunchConfig_t config(int CTAs, int CL, int nt, size_t smem,
                          cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)CTAs);
  cfg.blockDim = dim3((unsigned)nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MODE, bool VB, bool OPTS>
cudaError_t launch(const Params& p, const Geo& g, size_t smem,
                   cudaStream_t st) {
  cudaError_t e = prepare<MODE, VB, OPTS>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(p.B * cdiv(p.N / TILE, 2) * p.CL, p.CL,
                                  g.nt, smem, st, attr);
  e = cudaLaunchKernelEx(&cfg, mh_chain_ext_kernel<MODE, VB, OPTS>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool valid_widths(const int* hw, int depth) {
  if (depth < 1 || depth > MAXD) return false;
  for (int d = 0; d < depth; ++d)
    if (hw[d] < 1) return false;
  return true;
}

bool valid_cluster(int CL) { return CL == 4 || CL == 8; }

}  // namespace

extern "C" {

// The most hidden layers the kernel takes.
int gvnmf_mh_chain_ext_depth() { return MAXD; }

// Threads a CTA at F bins and CL CTAs a cluster.
int gvnmf_mh_chain_ext_block(int F, int CL) {
  const int hw[1] = {1};
  return geometry(F, 1, hw, 1, CL).nt;
}

// The floats of a rank's weight block, and the dynamic shared memory of a
// CTA (bytes), for the wrapper's checks and packing; hw: the depth hidden
// widths. -1 for shapes the kernel does not take.
long long gvnmf_mh_chain_ext_packed(int F, int L, const int* hw, int depth,
                                    int CL) {
  if (!valid_widths(hw, depth) || !valid_cluster(CL)) return -1;
  return geometry(F, L, hw, depth, CL).P;
}

long long gvnmf_mh_chain_ext_smem(int F, int L, const int* hw, int depth,
                                  int K, int CL) {
  if (!valid_widths(hw, depth) || !valid_cluster(CL)) return -1;
  return (long long)smem_floats(geometry(F, L, hw, depth, CL), L, hw, K, CL) *
         sizeof(float);
}

// The exact E-mode WH kernel's launch at these shapes: out[0] registers a
// thread, out[1] clusters that can be resident at once on this card
// (cudaOccupancyMaxActiveClusters), out[2] threads a CTA. Returns the
// cudaError_t.
int gvnmf_mh_chain_ext_occupancy(int F, int L, const int* hw, int depth,
                                 int K, int CL, int* out) {
  if (!valid_widths(hw, depth) || !valid_cluster(CL))
    return (int)cudaErrorInvalidValue;
  auto kern = mh_chain_ext_kernel<MODE_E, false, false>;
  const Geo g = geometry(F, L, hw, depth, CL);
  const size_t smem = smem_floats(g, L, hw, K, CL) * sizeof(float);
  cudaError_t e = prepare<MODE_E, false, false>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(CL * 1024, CL, g.nt, smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  out[0] = fa.numRegs;
  out[1] = clusters;
  out[2] = g.nt;
  return (int)e;
}

// mode 0 = E (out1 = samples; WH form: out2 / out3 = numW / denW (B, K, F),
// part1 / part2 = per-tile scratch; Vb form: out2 / out3 = s1 / s2
// (B, N, F)), mode 1 = WF (out1 = acc_s, out2 = acc_n). A non-null vb
// selects the Vb form (K = 0; wt, h, mask and the partials unused). zn / u
// null selects the in-kernel Philox stream keyed on `seed`. hw: the depth
// hidden widths; CL: CTAs a cluster (4 or 8); packed: the (CL,
// gvnmf_mh_chain_ext_packed) weight blocks, 16-byte aligned.
// samples_bf16 (E-mode only): out1 holds bfloat16 samples. approx_recip / approx_trans: the fast-mode options.
// mm_bf16: the decoder's products on bfloat16 operands (the packed weights
// must arrive rounded to bfloat16). Returns the cudaError_t of the
// launches.
int gvnmf_mh_chain_ext(const float* x2, const float* vb, const float* wt,
                       const float* h, const float* mask, const float* g,
                       const float* ypre, const float* z, const float* vs,
                       const float* zn, const float* u, const float* packed,
                       float* z_out, float* vs_out, void* out1, float* out2,
                       float* out3, float* part1, float* part2, int B, int N,
                       int F, int L, const int* hw, int depth, int K, int CL,
                       int n_steps, int burnin, float sqrt_var, int mode,
                       unsigned long long seed, int samples_bf16,
                       int approx_recip, int approx_trans, int mm_bf16,
                       void* stream) {
  if (!valid_widths(hw, depth) || !valid_cluster(CL) || F < 1 || L < 1 ||
      N % TILE != 0 || burnin < 0 || burnin > n_steps ||
      (mode != MODE_E && mode != MODE_WF) ||
      (samples_bf16 && mode != MODE_E) ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Geo geo = geometry(F, L, hw, depth, CL);
  if (geo.nt > MAX_NT) return (int)cudaErrorInvalidValue;
  const bool vbf = vb != nullptr;
  if (vbf) K = 0;
  Params p{};
  p.x2 = x2;
  p.vb = vb;
  p.wt = wt;
  p.h = h;
  p.mask = mask;
  p.g = g;
  p.ypre = ypre;
  p.z = z;
  p.vs = vs;
  p.zn = zn;
  p.u = u;
  p.packed = packed;
  p.z_out = z_out;
  p.vs_out = vs_out;
  p.out1 = samples_bf16 ? nullptr : static_cast<float*>(out1);
  p.out2 = out2;
  p.out3 = out3;
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
  p.CL = CL;
  for (int d = 0; d < depth; ++d) p.hw[d] = hw[d];
  p.sqrt_var = sqrt_var;
  p.seed_lo = (uint32_t)(seed & 0xffffffffull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.out1h = samples_bf16 ? static_cast<__nv_bfloat16*>(out1) : nullptr;
  p.approx_recip = approx_recip != 0;
  p.approx_trans = approx_trans != 0;
  p.mm_bf16 = mm_bf16 != 0;
  const size_t smem = smem_floats(geo, L, hw, K, CL) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the exact Philox kernel, or the one with runtime options
  const bool opts = zn != nullptr || samples_bf16 || approx_recip ||
                    approx_trans || mm_bf16;
  cudaError_t e;
  if (mode == MODE_E && !opts)
    e = vbf ? launch<MODE_E, true, false>(p, geo, smem, st)
            : launch<MODE_E, false, false>(p, geo, smem, st);
  else if (mode == MODE_E)
    e = vbf ? launch<MODE_E, true, true>(p, geo, smem, st)
            : launch<MODE_E, false, true>(p, geo, smem, st);
  else if (!opts)
    e = vbf ? launch<MODE_WF, true, false>(p, geo, smem, st)
            : launch<MODE_WF, false, false>(p, geo, smem, st);
  else
    e = vbf ? launch<MODE_WF, true, true>(p, geo, smem, st)
            : launch<MODE_WF, false, true>(p, geo, smem, st);
  if (e != cudaSuccess || mode != MODE_E || vbf) return (int)e;
  const int KF = K * F;
  sum_tiles_kernel<<<dim3((KF + 255) / 256, B), 256, 0, st>>>(
      part1, part2, out2, out3, N / TILE, KF);
  return (int)cudaGetLastError();
}

}  // extern "C"
