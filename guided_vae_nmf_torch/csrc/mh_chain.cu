// Fused random-walk Metropolis-Hastings chain over the VAE latent (K1).
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: mh_chain_pallas (body
// _make_chain_kernel), E-mode and WF-mode, with the NMF factors (WH=, K1a)
// or a given noise variance (Vb=, K1b), in exact math with float32 sample
// dumps or with the fast-mode options (K1c): bfloat16 sample dumps, the
// hardware approximate reciprocal for every 1/Vx, and (approx_trans) the
// bit-arithmetic log / exp of the TPU kernel's _fast_log / _fast_exp for
// the decoder's output exp, the data term's log, the accept test's log u
// and the Box-Muller logs; and with the decoder's three products on
// bfloat16 operands (K1d, the TPU kernel's matmul_dtype=bfloat16). The
// template flag OPTS separates the main path's exact kernel (in-kernel
// Philox, exact math, float32 dumps, and no code for anything else: added
// code paths measurably slowed its steps) from the kernel with runtime
// options: the recorded streams, the fast-mode options and the bfloat16
// products are fields of Params, uniform over the grid. Both run the same
// functions in the same order, so with every option off the option kernel
// reproduces the exact one bit for bit.
//
// K1d (mm_bf16): the TPU kernel casts both operands of each decoder
// product to bfloat16 and accumulates in float32. Here the wrapper hands
// the kernel weights already rounded to bfloat16 (held as float32), the
// first layer rounds the latent operand as it reads it (never the chain
// state z / zp, which the accept rule and the state update read in
// float32), and each hidden layer rounds its tanh outputs where it writes
// them. A product of two bfloat16 values is exact in float32, so the FMA
// loops sum the same exact products as the TPU kernel, in another order.
//
// Per frame and step the chain proposes Zp = Z + sqrt(var_RW) * n, decodes
// Vsp = exp(Wo tanh(W2 tanh(Zp W1 + ypre) + b2) + bo), forms
// Vxp = max(g Vsp + Vb, 1e-10) with Vb = H^T Wt (K1a) or read from the
// (B, N, F) input (K1b), and accepts when
// log u < s - sp + 0.5 sum_l (Z^2 - Zp^2), s = sum_f (log Vx + X2 / Vx).
// Burn-in carries only (Z, s); Vs is re-derived from Z at the boundary.
// E-mode dumps the R accepted Vs and accumulates s1 = sum 1/Vx and
// s2 = sum 1/Vx^2: K1a contracts them with H into the W-update numW /
// denW, K1b writes them out per (frame, bin), unmasked. WF-mode accumulates
// acc_n += Vb/Vx and acc_s += 1 - Vb/Vx, so WFs + WFn = 1 by construction.
//
// What bounds it on an H100: float32 arithmetic. Per frame and step the
// decoder costs 2 (L H + H H + H F) ~ 172 kFLOP (L=32, H=128, F=513) plus
// 256 tanh, 513 exp and 513 log, against a few hundred bytes of state;
// there are no tensor cores for exact float32. The output weights wo
// (128 x 513 float32, 263 KB) are larger than a CTA's 227 KB of shared
// memory, and a design that streams them from L2 every step, with one
// CTA of 9 warps an SM, waits on L2 most of the time (84 % of a step, by
// clock64 stamps). So the chain runs on a thread-block cluster of
// CLUSTER = 4 CTAs per two 16-frame tiles of one utterance (T = 32
// frames; with an odd tile count the last cluster of an utterance
// computes its one tile twice and writes it once):
//   * CTA `rank` owns a column slice of F (ceil(F / 4) bins, the last one
//     ragged) and a slice of the hidden units (ceil(H / 4), ragged). The
//     wrapper packs each rank's weights into one contiguous, 16-byte
//     aligned block: its columns of wo and bo, its columns of w1 and of
//     every hidden layer's weights and biases (`pack_weights` in
//     mcem/mh_chain.py; made once per mcem_batch_fused call). One bulk
//     asynchronous copy (cp.async.bulk with an mbarrier) brings the block
//     into shared memory at the start of the launch, where it stays: no
//     step reads a weight from global memory.
//   * the per-frame F-vectors of the slice (X2, Vb and the two
//     accumulators) live in shared memory. Each thread owns 4 columns x 4
//     frames of the output layer and keeps their proposal, accepted Vs and
//     accepted 1/Vx in registers, so every update after the accept
//     decision is thread-local. A 4 x 4 tile reads 8 shared-memory words
//     per 16 FMAs; a column x 8 frames, 9 words per 8 FMAs, which left the
//     output layer bound by shared-memory wavefronts.
//   * each hidden layer: every CTA computes its units for the 32 frames
//     (2 units x 4 frames a work item, 128 items at H=128) from its
//     resident weight columns and writes them into every CTA's activation
//     buffer through distributed shared memory; a cluster barrier (arrive
//     after the writes, wait before the reads) separates the layers. The stack is not recomputed per CTA. The
//     latent prior term of the accept test is reduced between the first
//     layer's arrive and wait, and the next step's Philox draws between
//     the data term's arrive and wait.
//   * the per-frame data term: each warp reduces its partial sums with a
//     transpose-reduction and writes them into every CTA; after a cluster
//     barrier every CTA adds the (rank, warp) partials in the same fixed
//     order, so all CTAs of a cluster hold bit-identical s, sp and accept
//     decisions. They draw the same proposal normals and accept uniforms
//     from the same Philox counters, so the chain state needs no exchange.
//     A frame's sums depend only on its position in its tile pair, never
//     on the batch.
//   * two tiles a cluster halve the clusters of a launch: at 30 resident
//     clusters of 4 CTAs (one CTA an SM), B=4, N=384 runs in 2 waves
//     instead of 4, and each step's barriers and serial latencies serve
//     32 frames. Every cluster's chain is the same fixed work, so a
//     launch takes ceil(running clusters / resident clusters) waves.
//   * dead pairs: with the optional live flags (B, ceil(n_tiles / 2)),
//     one per tile pair in this layout (live when any of the pair's
//     frames has mask > 0; the caller derives them from the mask), the
//     cluster of a dead pair runs no chain: no weight load, no draws, no
//     step. It exits at once, so the live clusters pack into
//     ceil(live / resident) waves. Each of its CTAs writes, for its own
//     columns and the pair's own frames (no barrier, no peer's shared
//     memory), what a chain that rejects every proposal leaves from the
//     caller's state: z_out = Z, vs_out = Vs, each of the R sample dumps
//     Vs (rounded to bfloat16 where the dumps are), numW / denW partials
//     0 (what a live cluster writes for frames whose mask is 0), and the
//     R-step sums at the unchanged Vs, 1/Vx = 1 / max(g Vs + Vb, 1e-10):
//     s1 = sum 1/Vx, s2 = sum 1/Vx^2 (E, Vb form), acc_n = sum Vb/Vx,
//     acc_s = sum (1 - Vb/Vx) (WF), added one step after another as a
//     live chain adds them. Pad frames are masked out downstream by a
//     product with the mask (the ISTFT, the cost pass, the W sums), and a
//     NaN or an infinity would survive that product, so every value is
//     finite: a zero dump would make the gain update 0/0 on the frame.
//     A live pair's outputs do not depend on the flags.
//   * the TPU accumulated numW / denW across frame tiles in one resident
//     output block, relying on its sequential grid. Here every CTA writes
//     its own (K, slice) partials per tile and a second kernel sums them
//     over tiles in a fixed order. No float atomics.
// Proposal noise is a counter-based Philox4x32-10 with Box-Muller normals,
// keyed on (seed, utterance, frame, step, draw), so a frame's stream does
// not depend on how frames are tiled (chain_common.cuh, shared with the
// general form for the decoders this form does not take,
// mh_chain_general.cu). `inject` mode reads recorded
// streams Zn (B, n_steps, N, L) and U (B, n_steps, N) instead.
//
// Elementwise expressions use explicitly rounded multiplies and adds, as
// the plain PyTorch version evaluates them; sums run in another order than
// PyTorch's, which the tests cover with a stated tolerance. fast_log /
// fast_exp are evaluated op for op as the plain version evaluates them, so
// the two agree bit for bit; the approximate reciprocal has no plain
// counterpart (the plain version divides exactly) and differs by at most
// 1 ulp.

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
                               // (read as one float2)
constexpr int CLUSTER = 4;     // CTAs per cluster
constexpr int MAX_NT = 384;    // largest block (F <= 768)
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
  const float* ypre;  // (B, N, Hd)
  const float* z;     // (B, N, L)
  const float* vs;    // (B, N, F), decode(Z)
  const float* zn;    // (B, n_steps, N, L), inject only
  const float* u;     // (B, n_steps, N), inject only
  const float* packed;  // (CLUSTER, P) per-rank weight blocks
  float* z_out;       // (B, N, L)
  float* vs_out;      // (B, N, F)
  float* out1;        // E: samples (B, R, N, F); WF: acc_s (B, N, F)
  float* out2;        // WF: acc_n (B, N, F); E, Vb form: s1 (B, N, F)
  float* out3;        // E, Vb form: s2 (B, N, F)
  float* part1;       // E, WH form: numW partials (B, n_tiles, K, F)
  float* part2;       // E, WH form: denW partials (B, n_tiles, K, F)
  int B, N, F, L, Hd, K, depth, n_steps, burnin;
  float sqrt_var;
  uint32_t seed_lo, seed_hi;
  __nv_bfloat16* out1h;  // E: bfloat16 samples in place of out1, or null
  int approx_recip, approx_trans;
  int mm_bf16;        // decoder products on bfloat16 operands (K1d)
  const unsigned char* live;  // (B, pairs) live flags, or null: every pair runs
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// Launch geometry and the per-rank weight block, from the shapes alone.
struct Geo {
  int Fsl, Fsp;   // bins per rank, padded row length in shared memory
  int Hsl, Hsp;   // hidden units per rank, padded row length
  int nq;         // column quads per rank (Fsp / 4)
  int nt, nw;     // threads and warps per CTA
  int P;          // floats in a rank's weight block
};

__host__ __device__ inline Geo geometry(int F, int L, int Hd, int depth) {
  Geo g;
  g.Fsl = cdiv(F, CLUSTER);
  g.Fsp = round4(g.Fsl);
  g.Hsl = cdiv(Hd, CLUSTER);
  g.Hsp = round4(g.Hsl);
  g.nq = g.Fsp / CC;
  const int nt = 32 * cdiv(NFG * g.nq, 32);
  g.nt = nt < 64 ? 64 : nt;
  g.nw = g.nt / 32;
  // wo [Hd][Fsp] | bo [Fsp] | w1 [L][Hsp] | (wmid [Hd][Hsp] | bmid [Hsp])
  // per hidden layer after the first; every term is a multiple of 4
  g.P = Hd * g.Fsp + g.Fsp + L * g.Hsp + (depth - 1) * (Hd * g.Hsp + g.Hsp);
  return g;
}

// Shared-memory carve-up of one CTA (floats; every offset is a multiple of
// 4, so rows can be read as float4 and the weight block is a valid
// bulk-copy destination).
struct Smem {
  float *wo, *bo, *w1, *wmid;  // the rank's weight block; wmid: layer d
                               // at wmid + d (Hd Hsp + Hsp), bias last
  float *x2, *vb, *a1, *a2;   // [T][Fsp]; a1/a2 = s1/s2 (E) or acc_s/acc_n (WF)
  float *hA, *hB;             // [Hd][T], written by every rank
  float *ypre;                // [Hsp][T], this rank's units
  float *z, *zp, *zn;         // [L][T]; zn: the next proposal's normals
  float *hk;                  // [K][T] H tiles
  float *red;                 // [CLUSTER][nw][T] per-warp frame sums
  float *g, *mask, *s, *acc, *dz;  // [T]
  float* logu;                // [2][T] accept-test log u, by step parity
  uint64_t* bar;              // the weight block's mbarrier
};

__host__ __device__ inline size_t smem_floats(const Geo& g, int L, int Hd,
                                              int K) {
  return (size_t)g.P + 4 * T * g.Fsp + 2 * Hd * T + g.Hsp * T + 3 * L * T +
         round4(K) * T + CLUSTER * g.nw * T + 7 * T + 4;
}

__device__ inline Smem carve(float* base, const Params& p, const Geo& g) {
  Smem s;
  s.wo = base;
  s.bo = s.wo + p.Hd * g.Fsp;
  s.w1 = s.bo + g.Fsp;
  s.wmid = s.w1 + p.L * g.Hsp;
  s.x2 = base + g.P;
  s.vb = s.x2 + T * g.Fsp;
  s.a1 = s.vb + T * g.Fsp;
  s.a2 = s.a1 + T * g.Fsp;
  s.hA = s.a2 + T * g.Fsp;
  s.hB = s.hA + p.Hd * T;
  s.ypre = s.hB + p.Hd * T;
  s.z = s.ypre + g.Hsp * T;
  s.zp = s.z + p.L * T;
  s.zn = s.zp + p.L * T;
  s.hk = s.zn + p.L * T;
  s.red = s.hk + round4(p.K) * T;
  s.g = s.red + CLUSTER * g.nw * T;
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

// c ? a : b as one selp the optimiser cannot turn into an indexed load (a
// select between two elements of a register array becomes a select of
// their addresses and moves the array to local memory).
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// The cluster's frames: two tiles of utterance b. With an odd tile count
// the last cluster of an utterance repeats its first tile as the second,
// computes it alongside and writes nothing of it: own(t) is false there.
struct Frames {
  int b, tile0, tile1;
  __device__ int n(int t) const {
    return (t < TILE ? tile0 : tile1) * TILE + (t & (TILE - 1));
  }
  __device__ size_t row(int t, int N) const { return (size_t)b * N + n(t); }
  __device__ bool own(int t) const { return t < TILE || tile1 != tile0; }
};

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// One hidden layer: this rank's units j0 + j (j < Hs) for the cluster's
// frames, h = tanh(in . w[:, j] + bias), bias = ypre (first layer,
// [Hsp][T]) or the layer's bias; written into `out` ([Hd][T]) of every CTA
// of the cluster. A work item is HU units x FG frames, and neighbouring
// lanes take neighbouring frame groups of the same units, so a
// quarter-warp's 16-byte reads and writes cover 128 contiguous bytes. Each sum runs over
// the input dimension in order, one FMA after another, as the plain
// version's matrix product on the card sums it: an order that splits the
// sum moves enough hidden outputs by an ulp that the bfloat16 sample
// dumps (K1c) stop matching it. RND_IN rounds the input operand to
// bfloat16 as it is read (the first layer under K1d), RND_OUT the output
// as it is written.
template <bool RND_IN, bool RND_OUT>
__device__ __forceinline__ void hidden_layer(const float* in, int kin,
                                             const float* w, int Hsp,
                                             const float* bias,
                                             const float* ypre, float* out,
                                             int Hs, int j0) {
  const int nu = (Hs + HU - 1) / HU;
  for (int it = threadIdx.x; it < nu * NFG; it += blockDim.x) {
    const int j = HU * (it / NFG), f0 = FG * (it % NFG);
    float a[HU][FG];
#pragma unroll
    for (int u = 0; u < HU; ++u)
#pragma unroll
      for (int i = 0; i < FG; ++i) a[u][i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kin; ++k) {
      const float2 w2 = *reinterpret_cast<const float2*>(w + k * Hsp + j);
      const float wk[HU] = {w2.x, w2.y};
      float4 x = ld4(in + k * T + f0);
      if (RND_IN) {
        x.x = bf16_round(x.x);
        x.y = bf16_round(x.y);
        x.z = bf16_round(x.z);
        x.w = bf16_round(x.w);
      }
#pragma unroll
      for (int u = 0; u < HU; ++u)
#pragma unroll
        for (int i = 0; i < FG; ++i)
          a[u][i] = fmaf(f4get(x, i), wk[u], a[u][i]);
    }
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      if (j + u >= Hs) break;
      float hv[FG];
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const float bv = ypre ? ypre[(j + u) * T + f0 + i] : bias[j + u];
        hv[i] = tanhf(__fadd_rn(a[u][i], bv));
        if (RND_OUT) hv[i] = bf16_round(hv[i]);
      }
      const float4 h4 = make_float4(hv[0], hv[1], hv[2], hv[3]);
      float4* dst = reinterpret_cast<float4*>(out + (j0 + j + u) * T + f0);
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) *peer(dst, r) = h4;
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

// The hidden stack on the [L][T] latent tile `zin`; returns the [Hd][T]
// buffer holding the last hidden layer, complete in every CTA (a cluster
// barrier follows each layer). With `prior`, the proposal's latent prior
// term (zin = Zp) is reduced while the first layer's barrier settles.
template <bool RND>
__device__ const float* hidden_stack(const Params& p, const Geo& g,
                                     const Smem& sm, const float* zin,
                                     int Hs, int j0, bool prior) {
  hidden_layer<RND, RND>(zin, p.L, sm.w1, g.Hsp, nullptr, sm.ypre, sm.hA, Hs,
                         j0);
  cluster_arrive();
  if (prior) latent_prior_terms(sm.z, sm.zp, p.L, sm.dz, g.nw);
  cluster_wait();
  float* src = sm.hA;
  float* dst = sm.hB;
  for (int d = 0; d < p.depth - 1; ++d) {
    const float* w = sm.wmid + (size_t)d * (p.Hd * g.Hsp + g.Hsp);
    hidden_layer<false, RND>(src, p.Hd, w, g.Hsp, w + p.Hd * g.Hsp, nullptr,
                             dst, Hs, j0);
    cluster_arrive();
    cluster_wait();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// The hidden stack in float32, or with bfloat16 operands under mm_bf16
// (OPTS kernel only: the exact kernel instantiates the float32 stack
// alone).
template <bool OPTS>
__device__ __forceinline__ const float* decoder_hidden(
    const Params& p, const Geo& g, const Smem& sm, const float* zin, int Hs,
    int j0, bool prior) {
  if (OPTS && p.mm_bf16)
    return hidden_stack<true>(p, g, sm, zin, Hs, j0, prior);
  return hidden_stack<false>(p, g, sm, zin, Hs, j0, prior);
}

// Per-thread position in the output layer: columns CC cq .. CC cq + 3 of
// the slice (the first `ncol` of them in range) for frames t0 .. t0 + 3.
struct Pos {
  int cq, t0, fg, ncol;
};

// Output layer for this thread's 4 columns x 4 frames:
// v[j][i] = exp(h[t0+i] . wo[:, c_j] + bo[c_j]). The k-loop is
// software-pipelined: k+1's weights and activations are read from shared
// memory while k's 16 FMAs run.
template <bool OPTS>
__device__ __forceinline__ void out_layer(const Params& p, const Geo& g,
                                          const Smem& sm, const float* hsrc,
                                          const Pos& ps,
                                          float (&v)[CC][FG]) {
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < FG; ++i) v[j][i] = 0.0f;
  const float* w = sm.wo + CC * ps.cq;
  const float* h = hsrc + ps.t0;
  float4 wk = ld4(w), hk = ld4(h);
#pragma unroll 4
  for (int k = 1; k < p.Hd; ++k) {
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

// This thread's share of the per-frame data terms:
// part[i] = sum over its columns c_j of log Vx + X2 / Vx at frame t0 + i.
template <bool OPTS, bool TRANS>
__device__ __forceinline__ void data_terms_t(const Params& p, const Geo& g,
                                             const Smem& sm,
                                             const float (&v)[CC][FG],
                                             const Pos& ps,
                                             float (&part)[FG]) {
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = ps.t0 + i;
    const int o = t * g.Fsp + CC * ps.cq;
    const float4 vb = ld4(sm.vb + o), x2 = ld4(sm.x2 + o);
    const float gt = sm.g[t];
    part[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      if (j < ps.ncol) {
        const float vx = mix_var(gt, v[j][i], f4get(vb, j));
        const float iv = recip<OPTS>(p, vx);
        const float lv = TRANS ? fast_log(vx) : logf(vx);
        part[i] = __fadd_rn(part[i], __fadd_rn(lv, __fmul_rn(iv, f4get(x2, j))));
      }
    }
  }
}

template <bool OPTS>
__device__ __forceinline__ void data_terms(const Params& p, const Geo& g,
                                           const Smem& sm,
                                           const float (&v)[CC][FG],
                                           const Pos& ps, float (&part)[FG]) {
  if (OPTS && p.approx_trans)
    data_terms_t<OPTS, true>(p, g, sm, v, ps, part);
  else
    data_terms_t<OPTS, false>(p, g, sm, v, ps, part);
}

// One level of the warp's transpose-reduction: a lane keeps half of its
// HALF x 2 frames and adds its partner's (lane ^ HALF) copy of them. A
// template per level, so every index into part is a compile-time constant
// and part stays in registers.
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
                                                   int rank, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp may hold several frame groups: place this lane's values among T
  float part[T];
#pragma unroll
  for (int f = 0; f < T; ++f) part[f] = fg == f / FG ? mine[f % FG] : 0.0f;
  // transpose-reduce: after five levels each lane holds one frame, summed
  // over the warp
  int frame = 0;
  transpose_level<16>(part, lane, frame);
  transpose_level<8>(part, lane, frame);
  transpose_level<4>(part, lane, frame);
  transpose_level<2>(part, lane, frame);
  transpose_level<1>(part, lane, frame);
  float* dst = red + (rank * nw + warp) * T + frame;
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) *peer(dst, r) = part[0];
}

// Frame t's sum over the cluster: the (rank, warp) partials in a fixed
// order, the same in every CTA.
__device__ __forceinline__ float cluster_frame_sum(const float* red, int nw,
                                                   int t) {
  float s = 0.0f;
  for (int i = 0; i < CLUSTER * nw; ++i) s = __fadd_rn(s, red[i * T + t]);
  return s;
}

// The random numbers of step m: the proposal normals into zn ([L][T], one
// item per (frame, 4 draws)) and the accept test's log u into
// logu[m & 1]. Drawn one step ahead, while a cluster barrier settles.
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

// Proposal Zp = Z + sqrt(var) n over the items of `draw`: the thread that
// drew a (frame, 4 draws) item also applies the accept to it.
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
                                              const Smem& sm,
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
        inv[j][i] = recip<OPTS>(p, mix_var(sm.g[t], v[j][i], sm.vb[o]));
      }
      if (MODE == MODE_E) {
        if (fr.own(t)) {
          if (OPTS && p.out1h != nullptr)
            p.out1h[so + j] = __float2bfloat16_rn(vs[j][i]);
          else
            p.out1[so + j] = vs[j][i];
        }
        sm.a1[o] = __fadd_rn(sm.a1[o], inv[j][i]);
        sm.a2[o] = __fadd_rn(sm.a2[o], __fmul_rn(inv[j][i], inv[j][i]));
      } else {
        const float tt = __fmul_rn(sm.vb[o], inv[j][i]);
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
                                       const Smem& sm, const Frames& fr,
                                       int c0, int rank, int Hs, int j0,
                                       const Pos& ps, int m, int r,
                                       float (&vs)[CC][FG],
                                       float (&inv)[CC][FG]) {
  propose(p, sm);
  __syncthreads();
  float v[CC][FG];
  out_layer<OPTS>(p, g, sm,
                  decoder_hidden<OPTS>(p, g, sm, sm.zp, Hs, j0, true), ps, v);
  // proposal data term sp = sum_f log Vxp + X2 / Vxp, over the cluster
  {
    float part[FG];
    data_terms<OPTS>(p, g, sm, v, ps, part);
    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw);
  }
  cluster_arrive();
  if (m + 1 < p.n_steps) draw<OPTS>(p, sm, fr, m + 1);
  cluster_wait();
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const float sp = cluster_frame_sum(sm.red, g.nw, t);
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
  if (SAMPLE) sample_update<MODE, OPTS>(p, g, sm, fr, c0, ps, r, v, vs, inv);
}

// A dead pair's outputs (see the file comment): this CTA's columns
// [c0, c0 + Fs) of the pair's own frames, Z by rank 0; no barrier and no
// shared memory.
template <int MODE, bool VB, bool OPTS>
__device__ void dead_pair(const Params& p, const Frames& fr, int rank,
                          int c0, int Fs, int n_tiles) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int R = p.n_steps - p.burnin;
  const int own = fr.tile1 != fr.tile0 ? T : TILE;
  if (rank == 0)
    for (int i = tid; i < own * p.L; i += NT) {
      const size_t gi = fr.row(i / p.L, p.N) * p.L + i % p.L;
      p.z_out[gi] = p.z[gi];
    }
  for (int i = tid; i < own * Fs; i += NT) {
    const int t = i / Fs, c = i % Fs;
    const size_t gi = fr.row(t, p.N) * p.F + c0 + c;
    const float vs = p.vs[gi];
    p.vs_out[gi] = vs;
    if (MODE == MODE_E) {
      for (int r = 0; r < R; ++r) {
        const size_t so =
            ((size_t)(fr.b * R + r) * p.N + fr.n(t)) * p.F + c0 + c;
        if (OPTS && p.out1h != nullptr)
          p.out1h[so] = __float2bfloat16_rn(vs);
        else
          p.out1[so] = vs;
      }
      if (!VB) continue;
    }
    float vb = 0.0f;
    if (VB) {
      vb = p.vb[gi];
    } else {
      for (int k = 0; k < p.K; ++k)
        vb = fmaf(p.h[((size_t)fr.b * p.K + k) * p.N + fr.n(t)],
                  __ldg(p.wt + ((size_t)fr.b * p.K + k) * p.F + c0 + c), vb);
    }
    const float inv = recip<OPTS>(p, mix_var(p.g[fr.row(t, p.N)], vs, vb));
    float a1 = 0.0f, a2 = 0.0f;
    for (int r = 0; r < R; ++r) {
      if (MODE == MODE_E) {
        a1 = __fadd_rn(a1, inv);
        a2 = __fadd_rn(a2, __fmul_rn(inv, inv));
      } else {
        const float tt = __fmul_rn(vb, inv);
        a2 = __fadd_rn(a2, tt);                    // acc_n
        a1 = __fadd_rn(a1, __fsub_rn(1.0f, tt));   // acc_s
      }
    }
    // WF: acc_s / acc_n; E, Vb form: s1 / s2
    (MODE == MODE_WF ? p.out1 : p.out2)[gi] = a1;
    (MODE == MODE_WF ? p.out2 : p.out3)[gi] = a2;
  }
  if (MODE == MODE_E && !VB) {
    const int n_sub = fr.tile1 != fr.tile0 ? 2 : 1;
    for (int i = tid; i < n_sub * p.K * Fs; i += NT) {
      const int st = i / (p.K * Fs), k = (i / Fs) % p.K, c = i % Fs;
      const int tile = st ? fr.tile1 : fr.tile0;
      const size_t po =
          (((size_t)fr.b * n_tiles + tile) * p.K + k) * p.F + c0 + c;
      p.part1[po] = 0.0f;
      p.part2[po] = 0.0f;
    }
  }
}

// VB selects the Vb form (K1b): Vb rows are read from p.vb, and E-mode
// writes s1 / s2 per (frame, bin) instead of the H-contracted partials.
// OPTS: the kernel with runtime options (see the file comment). One
// cluster of CLUSTER CTAs per two tiles of an utterance; the grid is 1-D.
template <int MODE, bool VB, bool OPTS>
__global__ void __launch_bounds__(MAX_NT, 1) mh_chain_kernel(Params p) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x, NT = blockDim.x;
  const Geo g = geometry(p.F, p.L, p.Hd, p.depth);
  const Smem sm = carve(reinterpret_cast<float*>(smem_raw), p, g);
  const int rank = (int)cg::this_cluster().block_rank();
  const int n_tiles = p.N / TILE, pairs = cdiv(n_tiles, 2);
  const int cid = blockIdx.x / CLUSTER;
  Frames fr;
  fr.b = cid / pairs;
  fr.tile0 = 2 * (cid % pairs);
  fr.tile1 = min(fr.tile0 + 1, n_tiles - 1);
  const int c0 = rank * g.Fsl, j0 = rank * g.Hsl;
  const int Fs = max(0, min(g.Fsl, p.F - c0));
  const int Hs = max(0, min(g.Hsl, p.Hd - j0));
  if (p.live != nullptr && !p.live[(size_t)fr.b * pairs + cid % pairs]) {
    dead_pair<MODE, VB, OPTS>(p, fr, rank, c0, Fs, n_tiles);
    return;
  }
  Pos ps;
  ps.fg = tid / g.nq;
  ps.cq = tid - ps.fg * g.nq;
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
  for (int i = tid; i < T * Hs; i += NT) {
    const int t = i / Hs, j = i % Hs;
    sm.ypre[j * T + t] = p.ypre[fr.row(t, p.N) * p.Hd + j0 + j];
  }
  __syncthreads();
  for (int i = tid; i < T * Fs; i += NT) {
    const int t = i / Fs, c = i % Fs;
    const int o = t * g.Fsp + c;
    const size_t gi = fr.row(t, p.N) * p.F + c0 + c;
    sm.x2[o] = p.x2[gi];
    float vb = 0.0f;
    if (VB) {
      vb = p.vb[gi];
    } else {
      for (int k = 0; k < p.K; ++k)
        vb = fmaf(sm.hk[k * T + t],
                  __ldg(p.wt + ((size_t)fr.b * p.K + k) * p.F + c0 + c), vb);
    }
    sm.vb[o] = vb;
    sm.a1[o] = 0.0f;
    sm.a2[o] = 0.0f;
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
    data_terms<OPTS>(p, g, sm, v0, ps, part);
    publish_frame_sums(part, ps.fg, sm.red, rank, g.nw);
  }
  cluster_sync();
  if (tid < T) sm.s[tid] = cluster_frame_sum(sm.red, g.nw, tid);
  if (p.n_steps > 0) draw<OPTS>(p, sm, fr, 0);
  wait_weights(sm.bar);

  float vs[CC][FG], inv[CC][FG];
  for (int m = 0; m < p.burnin; ++m)
    mh_step<MODE, OPTS, false>(p, g, sm, fr, c0, rank, Hs, j0, ps, m, 0, vs,
                               inv);

  // phase boundary: Vs = decode(Z), 1/Vx at it; s stays as carried
  __syncthreads();
  out_layer<OPTS>(p, g, sm,
                  decoder_hidden<OPTS>(p, g, sm, sm.z, Hs, j0, false), ps,
                  vs);
#pragma unroll
  for (int i = 0; i < FG; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const int t = ps.t0 + i;
      inv[j][i] = j < ps.ncol
                      ? recip<OPTS>(p, mix_var(sm.g[t], vs[j][i],
                                               sm.vb[t * g.Fsp + CC * ps.cq + j]))
                      : 0.0f;
    }
  // no CTA writes the next step's activations while a peer still reads
  cluster_sync();
  for (int r = 0; r < p.n_steps - p.burnin; ++r)
    mh_step<MODE, OPTS, true>(p, g, sm, fr, c0, rank, Hs, j0, ps,
                              p.burnin + r, r, vs, inv);
  __syncthreads();

  for (int i = tid; i < T * p.L; i += NT) {
    const int t = i / p.L, l = i % p.L;
    if (fr.own(t)) p.z_out[fr.row(t, p.N) * p.L + l] = sm.z[l * T + t];
  }
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = ps.t0 + i;
    if (!fr.own(t)) continue;
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
      if (!fr.own(t)) continue;
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
        num = fmaf(hk, __fmul_rn(__fmul_rn(sm.x2[o], sm.a2[o]), sm.mask[t]), num);
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

// The streams the chain draws in Philox mode, in the inject layout.
__global__ void philox_streams_kernel(uint32_t k0, uint32_t k1, int B, int N,
                                      int L, int n_steps, float* zn, float* u) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * n_steps * N) return;
  const int n = idx % N;
  const int m = (idx / N) % n_steps;
  const int b = idx / ((size_t)N * n_steps);
  for (int q = 0; q < (L + 3) / 4; ++q) {
    const float4 nz = normals4(k0, k1, b, n, m, q, false);
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < L) zn[idx * L + 4 * q + j] = f4get(nz, j);
  }
  u[idx] = accept_uniform(k0, k1, b, n, m);
}

template <int MODE, bool VB, bool OPTS>
cudaError_t launch(const Params& p, const Geo& g, size_t smem,
                   cudaStream_t st) {
  auto kern = mh_chain_kernel<MODE, VB, OPTS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.B * cdiv(p.N / TILE, 2) * CLUSTER));
  cfg.blockDim = dim3((unsigned)g.nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames per tile (N must be a multiple), CTAs per cluster, block size, the
// floats of a rank's weight block and the dynamic shared memory of a CTA,
// for the wrapper's checks and packing.
int gvnmf_mh_chain_tile() { return TILE; }

int gvnmf_mh_chain_cluster() { return CLUSTER; }

int gvnmf_mh_chain_block(int F) { return geometry(F, 1, 1, 1).nt; }

long long gvnmf_mh_chain_packed(int F, int L, int Hd, int depth) {
  return geometry(F, L, Hd, depth).P;
}

long long gvnmf_mh_chain_smem(int F, int L, int Hd, int K, int depth) {
  return (long long)smem_floats(geometry(F, L, Hd, depth), L, Hd, K) *
         sizeof(float);
}

// The exact E-mode WH kernel's launch at these shapes: out[0] registers a
// thread, out[1] clusters that can be resident at once on this card
// (cudaOccupancyMaxActiveClusters), out[2] threads a CTA. Returns the
// cudaError_t.
int gvnmf_mh_chain_occupancy(int F, int L, int Hd, int K, int depth,
                             int* out) {
  auto kern = mh_chain_kernel<MODE_E, false, false>;
  const Geo g = geometry(F, L, Hd, depth);
  const size_t smem = smem_floats(g, L, Hd, K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 1024);
  cfg.blockDim = dim3((unsigned)g.nt);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
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
// null selects the in-kernel Philox stream keyed on `seed`. packed: the
// (CLUSTER, gvnmf_mh_chain_packed) weight blocks, 16-byte aligned.
// samples_bf16 (E-mode only): out1 holds bfloat16 samples. approx_recip /
// approx_trans: the fast-mode options. mm_bf16: the decoder's products on
// bfloat16 operands (the packed weights must arrive rounded to bfloat16).
// live: (B, ceil(N / 32)) flags, one a tile pair (0: the pair is dead, see
// the file comment), or null: every pair runs. Returns the cudaError_t of
// the launches.
int gvnmf_mh_chain(const float* x2, const float* vb, const float* wt,
                   const float* h, const float* mask, const float* g,
                   const float* ypre,
                   const float* z, const float* vs, const float* zn,
                   const float* u, const float* packed,
                   const unsigned char* live, float* z_out, float* vs_out,
                   void* out1, float* out2, float* out3, float* part1,
                   float* part2, int B, int N,
                   int F, int L, int Hd, int K, int depth, int n_steps,
                   int burnin, float sqrt_var, int mode,
                   unsigned long long seed, int samples_bf16,
                   int approx_recip, int approx_trans, int mm_bf16,
                   void* stream) {
  const Geo geo = geometry(F, L, Hd, depth);
  if (N % TILE != 0 || geo.nt > MAX_NT || depth < 1 || burnin < 0 ||
      burnin > n_steps || (mode != MODE_E && mode != MODE_WF) ||
      (samples_bf16 && mode != MODE_E) ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const bool vbf = vb != nullptr;
  if (vbf) K = 0;
  Params p{x2, vb, wt, h, mask, g, ypre, z, vs, zn, u, packed,
           z_out, vs_out,
           samples_bf16 ? nullptr : static_cast<float*>(out1), out2, out3,
           part1, part2, B, N, F, L, Hd, K, depth, n_steps, burnin, sqrt_var,
           (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
           samples_bf16 ? static_cast<__nv_bfloat16*>(out1) : nullptr,
           approx_recip != 0, approx_trans != 0, mm_bf16 != 0, live};
  const size_t smem = smem_floats(geo, L, Hd, K) * sizeof(float);
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

int gvnmf_philox_streams(unsigned long long seed, int B, int N, int L,
                         int n_steps, float* zn, float* u, void* stream) {
  const size_t total = (size_t)B * n_steps * N;
  philox_streams_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), B, N, L,
      n_steps, zn, u);
  return (int)cudaGetLastError();
}

}  // extern "C"
