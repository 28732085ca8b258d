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
// Philox, exact math, float32 dumps, and no code for anything else: any
// added code path, even the once-a-launch initial data term, measurably
// slowed its steps) from the kernel with runtime options: the recorded
// streams, the fast-mode options and the bfloat16 products are fields of
// Params, uniform over the grid, and its data-term loop is instantiated
// with and without approx_trans, its hidden layers with and without the
// bfloat16 rounding. Four kernels of each kind keep the build under a
// minute.
//
// K1d (mm_bf16): the TPU kernel casts both operands of each decoder
// product to bfloat16 and accumulates in float32. Here the wrapper hands
// the kernel weights already rounded to bfloat16 (held as float32), the
// first layer rounds the latent operand as it reads it (never the chain
// state z / zp, which the accept rule and the state update read in
// float32), and each hidden layer rounds its tanh outputs where it writes
// them, since they feed only the next product. A product of two bfloat16
// values is exact in float32, so the FMA loops stay as they are and sum
// the same exact products as the TPU kernel, in another order. This is
// the simplest correct form, not a fast one: the products still run on
// the FMA pipes. On Hopper the option is what could use the tensor cores:
// T = 16 frames a CTA is exactly mma.sync.m16n8k16's M, and a bfloat16 wo
// (128 x 513 x 2 B = 131 KB) fits in shared memory, where the float32 one
// (263 KB) does not. Both belong to the work on K1's speed.
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
// The two forms differ only in where a tile's Vb rows come from and in the
// E-mode epilogue; the chain itself (mh_step) is shared.
//
// What bounds it on an H100: float32 arithmetic. Per frame and step the
// decoder costs 2 (L H + H H + H F) ~ 172 kFLOP (L=32, H=128, F=513) plus
// 256 tanh, 513 exp and 513 log, against a few hundred bytes of state;
// there are no tensor cores for exact float32. The TPU design kept the
// decoder weights and six (128, F) state tiles resident in VMEM; wo alone
// (128 x 513 float32 = 263 KB) is larger than a CTA's 227 KB of shared
// memory. So:
//   * a CTA owns T = 16 frames of one utterance. Its per-frame F-vectors
//     (X2, Vb and the two accumulators) live in shared memory, and each
//     thread owns up to two frequency columns for all 16 frames, keeping the
//     proposal, the accepted Vs and the accepted 1/Vx of its columns in
//     registers: every (frame, bin) update after the accept decision is
//     thread-local.
//   * the block has 32 * ceil(F / 64) threads (288 at F = 513), so F = 513
//     splits into two columns per thread with no ragged third pass.
//   * w1, the hidden weights and wo are read from global memory: every CTA
//     reads the same 0.35 MB, which stays in L2. Each wo element loaded is
//     reused for 16 frames from registers.
//   * the per-frame sum over F is a warp transpose-reduction (16 shuffles
//     for 16 frames) followed by a fixed-order sum over warps, so a run is
//     reproducible.
//   * the TPU accumulated numW / denW across frame tiles in one resident
//     output block, relying on its sequential grid. Here every CTA writes
//     its own (K, F) partials and a second kernel sums them over tiles in a
//     fixed order. No float atomics.
// Proposal noise is a counter-based Philox4x32-10 with Box-Muller normals,
// keyed on (seed, utterance, frame, step, draw), so a frame's stream does
// not depend on how frames are tiled. `inject` mode reads recorded
// streams Zn (B, n_steps, N, L) and U (B, n_steps, N) instead.
//
// Elementwise expressions use explicitly rounded multiplies and adds, as
// the plain PyTorch version evaluates them; sums run in another order than
// PyTorch's, which the tests cover with a stated tolerance. fast_log /
// fast_exp are evaluated op for op as the plain version evaluates them, so
// the two agree bit for bit; the approximate reciprocal has no plain
// counterpart (the plain version divides exactly) and differs by at most
// 1 ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;          // frames per CTA
constexpr int MAXC = 2;        // frequency columns per thread
constexpr int FT = 8;          // frames per hidden-layer work item
constexpr int MAX_NT = 384;    // largest block (F <= 768)
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
  const float* w1;    // (L, Hd)
  const float* wmid;  // (depth-1, Hd, Hd)
  const float* bmid;  // (depth-1, Hd)
  const float* wo;    // (Hd, F)
  const float* bo;    // (F)
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
};

constexpr double LN2 = 0.6931471805599453;
constexpr double SQRT2 = 1.4142135623730951;

// rcp.approx: at most 1 ulp from 1/x. Vx >= 1e-10 is a normal float, so
// flushing subnormals changes nothing.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1/Vx: rcp.approx under approx_recip (OPTS kernel), else IEEE division.
template <bool OPTS>
__device__ __forceinline__ float recip(const Params& p, float x) {
  return (OPTS && p.approx_recip) ? rcp_approx(x) : 1.0f / x;
}

// The TPU kernel's _fast_log: log x = e ln2 + 2s (1 + s^2/3 + s^4/5 +
// s^6/7), s = (m - 1) / (m + 1), m in [sqrt(1/2), sqrt(2)). Constants are
// the float32 roundings of the reference's double literals. x >= 1e-10.
__device__ __forceinline__ float fast_log(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const bool big = m > (float)SQRT2;
  if (big) m = __fmul_rn(0.5f, m);
  const float ef = (float)(e + (big ? 1 : 0));
  const float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float s2 = __fmul_rn(s, s);
  float q = __fadd_rn((float)0.2, __fmul_rn(s2, (float)0.14285714));
  q = __fadd_rn((float)0.33333333, __fmul_rn(s2, q));
  q = __fadd_rn(1.0f, __fmul_rn(s2, q));
  return __fadd_rn(__fmul_rn(ef, (float)LN2), __fmul_rn(__fmul_rn(2.0f, s), q));
}

// The TPU kernel's _fast_exp: 2^zi (degree-6 Taylor of the Cody-Waite
// residual r), zi = floor(x / ln2 + 0.5), x clamped to [-87, 88].
__device__ __forceinline__ float fast_exp(float x) {
  x = fminf(fmaxf(x, -87.0f), 88.0f);
  const float zi = floorf(__fadd_rn(__fmul_rn(x, (float)(1.0 / LN2)), 0.5f));
  const float r = __fadd_rn(__fsub_rn(x, __fmul_rn(zi, 0.693359375f)),
                            __fmul_rn(zi, (float)2.12194440e-4));
  float q = __fadd_rn((float)0.008333333333333333,
                      __fmul_rn(r, (float)0.001388888888888889));
  q = __fadd_rn((float)0.041666666666666664, __fmul_rn(r, q));
  q = __fadd_rn((float)0.16666666666666666, __fmul_rn(r, q));
  q = __fadd_rn(0.5f, __fmul_rn(r, q));
  q = __fadd_rn(1.0f, __fmul_rn(r, q));
  q = __fadd_rn(1.0f, __fmul_rn(r, q));
  return __fmul_rn(__int_as_float(((int)zi + 127) << 23), q);
}

// log in the data term and the accept test: fast_log under approx_trans
// (OPTS kernel), else logf.
template <bool OPTS>
__device__ __forceinline__ float log_k(const Params& p, float x) {
  return (OPTS && p.approx_trans) ? fast_log(x) : logf(x);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// 24 random bits -> float32 uniform strictly inside (0, 1).
__device__ __forceinline__ float uniform01(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Normals for draws 4q .. 4q+3 of frame n at step m: two Box-Muller pairs
// (their logs are fast_log's under approx_trans, as in the TPU kernel).
__device__ __forceinline__ float4 normals4(uint32_t k0, uint32_t k1, int b,
                                           int n, int m, int q, bool trans) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)n, (uint32_t)m, (uint32_t)q, (uint32_t)b), k0, k1);
  const float ua = uniform01(r.x), ub = uniform01(r.z);
  const float ra = sqrtf(-2.0f * (trans ? fast_log(ua) : logf(ua)));
  const float rb = sqrtf(-2.0f * (trans ? fast_log(ub) : logf(ub)));
  float sa, ca, sb, cb;
  sincospif(2.0f * uniform01(r.y), &sa, &ca);
  sincospif(2.0f * uniform01(r.w), &sb, &cb);
  return make_float4(ra * ca, ra * sa, rb * cb, rb * sb);
}

// The accept uniform of frame n at step m (its own counter, draw 2^32-1).
__device__ __forceinline__ float accept_uniform(uint32_t k0, uint32_t k1,
                                                int b, int n, int m) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)n, (uint32_t)m, 0xFFFFFFFFu, (uint32_t)b), k0, k1);
  return uniform01(r.x);
}

__device__ __forceinline__ float f4get(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// x rounded to the nearest bfloat16 (ties to even), as a float.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A float4 of latent operands, rounded to bfloat16 under RND (K1d).
template <bool RND>
__device__ __forceinline__ float4 operand4(float4 v) {
  if (RND) {
    v.x = bf16_round(v.x);
    v.y = bf16_round(v.y);
    v.z = bf16_round(v.z);
    v.w = bf16_round(v.w);
  }
  return v;
}

// Shared-memory carve-up of one CTA (floats; every offset is a multiple of
// 16, so the [.][T] arrays can be read as float4).
struct Smem {
  float *x2, *vb, *a1, *a2;   // [T][F]; a1/a2 = s1/s2 (E) or acc_s/acc_n (WF)
  float *z, *zp;              // [L][T]
  float *ypre, *hA, *hB;      // [Hd][T]
  float *hk;                  // [K][T] H tile
  float *red;                 // [n_warps][T]
  float *g, *mask, *s, *sp, *acc;  // [T]
};

__host__ __device__ inline size_t smem_floats(int F, int L, int Hd, int K,
                                              int n_warps) {
  return (size_t)4 * T * F + 2 * L * T + 3 * Hd * T + K * T + n_warps * T +
         5 * T;
}

__device__ inline Smem carve(float* base, const Params& p, int n_warps) {
  Smem s;
  s.x2 = base;
  s.vb = s.x2 + T * p.F;
  s.a1 = s.vb + T * p.F;
  s.a2 = s.a1 + T * p.F;
  s.z = s.a2 + T * p.F;
  s.zp = s.z + p.L * T;
  s.ypre = s.zp + p.L * T;
  s.hA = s.ypre + p.Hd * T;
  s.hB = s.hA + p.Hd * T;
  s.hk = s.hB + p.Hd * T;
  s.red = s.hk + p.K * T;
  s.g = s.red + n_warps * T;
  s.mask = s.g + T;
  s.s = s.mask + T;
  s.sp = s.s + T;
  s.acc = s.sp + T;
  return s;
}

// Decoder hidden stack on the [L][T] latent tile `zin`; returns the [Hd][T]
// buffer holding the last hidden layer. Ends with a barrier. RND (K1d):
// the latent operand is rounded to bfloat16 as it is read and each hidden
// output as it is written; the weights arrive rounded.
template <bool RND>
__device__ const float* hidden_layers(const Params& p, const Smem& sm,
                                      const float* zin) {
  const int items = p.Hd * (T / FT);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j = it % p.Hd, t0 = (it / p.Hd) * FT;
    float acc[FT];
#pragma unroll
    for (int t = 0; t < FT; ++t) acc[t] = 0.0f;
    for (int l = 0; l < p.L; ++l) {
      const float w = __ldg(p.w1 + l * p.Hd + j);
      const float4 a =
          operand4<RND>(*reinterpret_cast<const float4*>(zin + l * T + t0));
      const float4 b =
          operand4<RND>(*reinterpret_cast<const float4*>(zin + l * T + t0 + 4));
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[t] = fmaf(f4get(a, t), w, acc[t]);
        acc[t + 4] = fmaf(f4get(b, t), w, acc[t + 4]);
      }
    }
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      const float h = tanhf(__fadd_rn(acc[t], sm.ypre[j * T + t0 + t]));
      sm.hA[j * T + t0 + t] = RND ? bf16_round(h) : h;
    }
  }
  __syncthreads();
  float* src = sm.hA;
  float* dst = sm.hB;
  for (int d = 0; d < p.depth - 1; ++d) {
    const float* w = p.wmid + (size_t)d * p.Hd * p.Hd;
    const float* bias = p.bmid + d * p.Hd;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int j = it % p.Hd, t0 = (it / p.Hd) * FT;
      float acc[FT];
#pragma unroll
      for (int t = 0; t < FT; ++t) acc[t] = 0.0f;
      for (int k = 0; k < p.Hd; ++k) {
        const float wk = __ldg(w + k * p.Hd + j);
        const float4 a = *reinterpret_cast<const float4*>(src + k * T + t0);
        const float4 b = *reinterpret_cast<const float4*>(src + k * T + t0 + 4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[t] = fmaf(f4get(a, t), wk, acc[t]);
          acc[t + 4] = fmaf(f4get(b, t), wk, acc[t + 4]);
        }
      }
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int t = 0; t < FT; ++t) {
        const float h = tanhf(__fadd_rn(acc[t], bj));
        dst[j * T + t0 + t] = RND ? bf16_round(h) : h;
      }
    }
    __syncthreads();
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
__device__ __forceinline__ const float* decoder_hidden(const Params& p,
                                                       const Smem& sm,
                                                       const float* zin) {
  if (OPTS && p.mm_bf16) return hidden_layers<true>(p, sm, zin);
  return hidden_layers<false>(p, sm, zin);
}

// Output layer for this thread's columns c = tid + i * blockDim.x:
// v[i][t] = exp(h[t] . wo[:, c] + bo[c]). Columns >= F are left at 1.
template <bool OPTS>
__device__ __forceinline__ void out_layer(const Params& p, const float* hsrc,
                                          float (&v)[MAXC][T]) {
  int col[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    col[i] = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int t = 0; t < T; ++t) v[i][t] = 0.0f;
  }
#pragma unroll 2
  for (int k = 0; k < p.Hd; ++k) {
    float w[MAXC];
#pragma unroll
    for (int i = 0; i < MAXC; ++i)
      w[i] = col[i] < p.F ? __ldg(p.wo + (size_t)k * p.F + col[i]) : 0.0f;
    const float4* h4 = reinterpret_cast<const float4*>(hsrc + k * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const float4 hq = h4[q];
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        v[i][4 * q + 0] = fmaf(hq.x, w[i], v[i][4 * q + 0]);
        v[i][4 * q + 1] = fmaf(hq.y, w[i], v[i][4 * q + 1]);
        v[i][4 * q + 2] = fmaf(hq.z, w[i], v[i][4 * q + 2]);
        v[i][4 * q + 3] = fmaf(hq.w, w[i], v[i][4 * q + 3]);
      }
    }
  }
  if (OPTS && p.approx_trans) {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const float b = col[i] < p.F ? __ldg(p.bo + col[i]) : 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) v[i][t] = fast_exp(__fadd_rn(v[i][t], b));
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const float b = col[i] < p.F ? __ldg(p.bo + col[i]) : 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) v[i][t] = expf(__fadd_rn(v[i][t], b));
    }
  }
}

__device__ __forceinline__ float mix_var(float g, float vs, float vb) {
  return fmaxf(__fadd_rn(__fmul_rn(g, vs), vb), VX_FLOOR);
}

// This thread's share of the per-frame data terms
// part[t] = sum_c log Vx + X2 / Vx, Vx = mix_var(g, v, Vb), over its columns.
template <bool OPTS, bool TRANS>
__device__ __forceinline__ void data_terms_t(const Params& p, const Smem& sm,
                                             const float (&v)[MAXC][T],
                                             float (&part)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) part[t] = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < p.F) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float vx = mix_var(sm.g[t], v[i][t], sm.vb[t * p.F + c]);
        const float iv = recip<OPTS>(p, vx);
        const float lv = TRANS ? fast_log(vx) : logf(vx);
        part[t] = __fadd_rn(part[t], __fadd_rn(lv,
                                               __fmul_rn(iv, sm.x2[t * p.F + c])));
      }
    }
  }
}

template <bool OPTS>
__device__ __forceinline__ void data_terms(const Params& p, const Smem& sm,
                                           const float (&v)[MAXC][T],
                                           float (&part)[T]) {
  if (OPTS && p.approx_trans)
    data_terms_t<OPTS, true>(p, sm, v, part);
  else
    data_terms_t<OPTS, false>(p, sm, v, part);
}

// Block-wide per-frame sums of part[t]; the result lands in out[t] for
// threads 0..T-1 (only they read it). One barrier inside.
__device__ __forceinline__ void frame_sums(float (&part)[T], float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // transpose-reduce: at each level a lane keeps half of its frames and
  // adds its partner's copy of them; after four levels each lane holds one
  // frame, summed over 16 lanes, and a last shuffle adds the 17th..32nd.
  int frame = 0;
#pragma unroll
  for (int half = T / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? part[j] : part[j + half];
      const float keep = upper ? part[j + half] : part[j];
      part[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, off));
    }
    frame += upper ? half : 0;
  }
  float v = __fadd_rn(part[0], __shfl_xor_sync(FULL, part[0], 1));
  if ((lane & 1) == 0) red[warp * T + frame] = v;
  __syncthreads();
  if (threadIdx.x < T) {
    const int n_warps = blockDim.x >> 5;
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s = __fadd_rn(s, red[w * T + threadIdx.x]);
    out[threadIdx.x] = s;
  }
}

// One MH step at global step index m. SAMPLE selects the sampling phase,
// which also updates the accepted Vs / 1/Vx registers and the
// accumulators. Ends with a barrier.
template <int MODE, bool OPTS, bool SAMPLE>
__device__ __forceinline__ void mh_step(const Params& p, const Smem& sm,
                                       int b, int n0, int m, int r,
                                       float (&vs)[MAXC][T],
                                       float (&inv)[MAXC][T]) {
  const int tid = threadIdx.x, NT = blockDim.x;
  // proposal Zp = Z + sqrt(var) * n  ([L][T] tiles)
  const bool inject = OPTS && p.zn != nullptr;
  if (inject) {
    const float* zn = p.zn + ((size_t)(b * p.n_steps + m) * p.N + n0) * p.L;
    for (int i = tid; i < T * p.L; i += NT) {
      const int t = i / p.L, l = i % p.L;
      sm.zp[l * T + t] =
          __fadd_rn(sm.z[l * T + t], __fmul_rn(p.sqrt_var, zn[i]));
    }
  } else {
    const int nq = (p.L + 3) / 4;
    for (int i = tid; i < T * nq; i += NT) {
      const int t = i / nq, q = i % nq;
      const float4 nz = normals4(p.seed_lo, p.seed_hi, b, n0 + t, m, q,
                                 OPTS && p.approx_trans);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * q + j;
        if (l < p.L)
          sm.zp[l * T + t] =
              __fadd_rn(sm.z[l * T + t], __fmul_rn(p.sqrt_var, f4get(nz, j)));
      }
    }
  }
  __syncthreads();
  float v[MAXC][T];
  out_layer<OPTS>(p, decoder_hidden<OPTS>(p, sm, sm.zp), v);
  // proposal data term sp = sum_f log Vxp + X2 / Vxp
  float part[T];
  data_terms<OPTS>(p, sm, v, part);
  frame_sums(part, sm.red, sm.sp);
  if (tid < T) {
    const int t = tid;
    const float sp = sm.sp[t];
    float dz = 0.0f;
    for (int l = 0; l < p.L; ++l) {
      const float z = sm.z[l * T + t], zp = sm.zp[l * T + t];
      dz = __fadd_rn(dz, __fsub_rn(__fmul_rn(z, z), __fmul_rn(zp, zp)));
    }
    const float a = __fadd_rn(__fsub_rn(sm.s[t], sp), __fmul_rn(0.5f, dz));
    const float u = inject ? p.u[(size_t)(b * p.n_steps + m) * p.N + n0 + t]
                           : accept_uniform(p.seed_lo, p.seed_hi, b, n0 + t, m);
    const bool accept = log_k<OPTS>(p, u) < a;
    sm.acc[t] = accept ? 1.0f : 0.0f;
    if (accept) sm.s[t] = sp;
  }
  __syncthreads();
  for (int i = tid; i < T * p.L; i += NT) {
    if (sm.acc[i % T] != 0.0f) sm.z[i] = sm.zp[i];
  }
  if (SAMPLE) {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = tid + i * NT;
      if (c < p.F) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int o = t * p.F + c;
          if (sm.acc[t] != 0.0f) {
            vs[i][t] = v[i][t];
            inv[i][t] = recip<OPTS>(p, mix_var(sm.g[t], v[i][t], sm.vb[o]));
          }
          if (MODE == MODE_E) {
            const size_t so =
                ((size_t)(b * (p.n_steps - p.burnin) + r) * p.N + n0 + t) *
                    p.F + c;
            if (OPTS && p.out1h != nullptr)
              p.out1h[so] = __float2bfloat16_rn(vs[i][t]);
            else
              p.out1[so] = vs[i][t];
            sm.a1[o] = __fadd_rn(sm.a1[o], inv[i][t]);
            sm.a2[o] = __fadd_rn(sm.a2[o], __fmul_rn(inv[i][t], inv[i][t]));
          } else {
            const float tt = __fmul_rn(sm.vb[o], inv[i][t]);
            sm.a2[o] = __fadd_rn(sm.a2[o], tt);                    // acc_n
            sm.a1[o] = __fadd_rn(sm.a1[o], __fsub_rn(1.0f, tt));   // acc_s
          }
        }
      }
    }
  }
  __syncthreads();
}

// VB selects the Vb form (K1b): Vb rows are read from p.vb, and E-mode
// writes s1 / s2 per (frame, bin) instead of the H-contracted partials.
// OPTS: the kernel with runtime options (see the file comment).
template <int MODE, bool VB, bool OPTS>
__global__ void __launch_bounds__(MAX_NT, 1) mh_chain_kernel(Params p) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x, NT = blockDim.x, n_warps = NT >> 5;
  const Smem sm = carve(reinterpret_cast<float*>(smem_raw), p, n_warps);
  const int n_tiles = p.N / T;
  const int b = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int n0 = tile * T;
  const size_t row0 = (size_t)b * p.N + n0;   // first frame of the tile

  if (tid < T) {
    sm.g[tid] = p.g[row0 + tid];
    sm.mask[tid] = (MODE == MODE_E && !VB) ? p.mask[row0 + tid] : 0.0f;
  }
  if (!VB)
    for (int i = tid; i < p.K * T; i += NT)
      sm.hk[i] = p.h[((size_t)b * p.K + i / T) * p.N + n0 + i % T];
  for (int i = tid; i < T * p.L; i += NT)
    sm.z[(i % p.L) * T + i / p.L] = p.z[row0 * p.L + i];
  for (int i = tid; i < T * p.Hd; i += NT)
    sm.ypre[(i % p.Hd) * T + i / p.Hd] = p.ypre[row0 * p.Hd + i];
  __syncthreads();
  for (int i = tid; i < T * p.F; i += NT) {
    const int t = i / p.F, c = i % p.F;
    sm.x2[i] = p.x2[row0 * p.F + i];
    float vb = 0.0f;
    if (VB) {
      vb = p.vb[row0 * p.F + i];
    } else {
      for (int k = 0; k < p.K; ++k)
        vb = fmaf(sm.hk[k * T + t], __ldg(p.wt + ((size_t)b * p.K + k) * p.F + c), vb);
    }
    sm.vb[i] = vb;
    sm.a1[i] = 0.0f;
    sm.a2[i] = 0.0f;
  }
  __syncthreads();

  // initial data term from the caller's Vs (= decode(Z))
  if (!OPTS) {
    float part[T];
#pragma unroll
    for (int t = 0; t < T; ++t) part[t] = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = tid + i * NT;
      if (c < p.F) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float vx = mix_var(sm.g[t], p.vs[(row0 + t) * p.F + c],
                                   sm.vb[t * p.F + c]);
          const float iv = 1.0f / vx;
          part[t] = __fadd_rn(part[t], __fadd_rn(logf(vx),
                                                 __fmul_rn(iv, sm.x2[t * p.F + c])));
        }
      }
    }
    frame_sums(part, sm.red, sm.s);
    __syncthreads();
  } else {
    // once a launch, so a compact loop: per frame, this thread's columns,
    // a butterfly warp sum (the same tree as frame_sums, so with every
    // option off this kernel reproduces the exact one bit for bit), then
    // a fixed-order sum over warps
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      float part = 0.0f;
      for (int c = tid; c < p.F; c += NT) {
        const float vx = mix_var(sm.g[t], p.vs[(row0 + t) * p.F + c],
                                 sm.vb[t * p.F + c]);
        part = __fadd_rn(part, __fadd_rn(log_k<OPTS>(p, vx),
                                         __fmul_rn(recip<OPTS>(p, vx),
                                                   sm.x2[t * p.F + c])));
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(FULL, part, off));
      if (lane == 0) sm.red[warp * T + t] = part;
    }
    __syncthreads();
    if (tid < T) {
      float s0 = 0.0f;
      for (int w = 0; w < n_warps; ++w) s0 = __fadd_rn(s0, sm.red[w * T + tid]);
      sm.s[tid] = s0;
    }
    __syncthreads();
  }

  float vs[MAXC][T], inv[MAXC][T];
  for (int m = 0; m < p.burnin; ++m)
    mh_step<MODE, OPTS, false>(p, sm, b, n0, m, 0, vs, inv);

  // phase boundary: Vs = decode(Z), 1/Vx at it; s stays as carried
  out_layer<OPTS>(p, decoder_hidden<OPTS>(p, sm, sm.z), vs);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = tid + i * NT;
#pragma unroll
    for (int t = 0; t < T; ++t)
      inv[i][t] = c < p.F
                      ? recip<OPTS>(p, mix_var(sm.g[t], vs[i][t], sm.vb[t * p.F + c]))
                      : 0.0f;
  }
  for (int r = 0; r < p.n_steps - p.burnin; ++r)
    mh_step<MODE, OPTS, true>(p, sm, b, n0, p.burnin + r, r, vs, inv);

  for (int i = tid; i < T * p.L; i += NT)
    p.z_out[row0 * p.L + i] = sm.z[(i % p.L) * T + i / p.L];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = tid + i * NT;
    if (c >= p.F) continue;
#pragma unroll
    for (int t = 0; t < T; ++t) p.vs_out[(row0 + t) * p.F + c] = vs[i][t];
    if (MODE == MODE_WF || VB) {
      // WF: acc_s / acc_n; E, Vb form: s1 / s2
      float* o1 = MODE == MODE_WF ? p.out1 : p.out2;
      float* o2 = MODE == MODE_WF ? p.out2 : p.out3;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        o1[(row0 + t) * p.F + c] = sm.a1[t * p.F + c];
        o2[(row0 + t) * p.F + c] = sm.a2[t * p.F + c];
      }
    } else {
      // this tile's share of numW = H (X2 s2 mask), denW = H (s1 mask)
      for (int k = 0; k < p.K; ++k) {
        float num = 0.0f, den = 0.0f;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int o = t * p.F + c;
          const float hk = sm.hk[k * T + t];
          num = fmaf(hk, __fmul_rn(__fmul_rn(sm.x2[o], sm.a2[o]), sm.mask[t]), num);
          den = fmaf(hk, __fmul_rn(sm.a1[o], sm.mask[t]), den);
        }
        const size_t po = (((size_t)b * n_tiles + tile) * p.K + k) * p.F + c;
        p.part1[po] = num;
        p.part2[po] = den;
      }
    }
  }
}

// numW[b] = sum over tiles of the partials, in tile order.
__global__ void sum_tiles_kernel(const float* __restrict__ part1,
                                 const float* __restrict__ part2,
                                 float* __restrict__ out1,
                                 float* __restrict__ out2, int n_tiles,
                                 int KF) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KF) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const size_t o = ((size_t)b * n_tiles + tile) * KF + i;
    s1 = __fadd_rn(s1, part1[o]);
    s2 = __fadd_rn(s2, part2[o]);
  }
  out1[(size_t)b * KF + i] = s1;
  out2[(size_t)b * KF + i] = s2;
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
cudaError_t launch(const Params& p, int nt, size_t smem, cudaStream_t st) {
  auto kern = mh_chain_kernel<MODE, VB, OPTS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<p.B * (p.N / T), nt, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames per CTA, block size and dynamic shared memory of a launch, for the
// wrapper's checks.
int gvnmf_mh_chain_tile() { return T; }

int gvnmf_mh_chain_block(int F) {
  const int nt = 32 * ((F + 63) / 64);
  return nt < 64 ? 64 : nt;
}

long long gvnmf_mh_chain_smem(int F, int L, int Hd, int K) {
  const int nt = gvnmf_mh_chain_block(F);
  return (long long)smem_floats(F, L, Hd, K, nt / 32) * sizeof(float);
}

// mode 0 = E (out1 = samples; WH form: out2 / out3 = numW / denW (B, K, F),
// part1 / part2 = per-tile scratch; Vb form: out2 / out3 = s1 / s2
// (B, N, F)), mode 1 = WF (out1 = acc_s, out2 = acc_n). A non-null vb
// selects the Vb form (K = 0; wt, h, mask and the partials unused). zn / u
// null selects the in-kernel Philox stream keyed on `seed`. samples_bf16
// (E-mode only): out1 holds bfloat16 samples. approx_recip / approx_trans:
// the fast-mode options. mm_bf16: the decoder's products on bfloat16
// operands (w1, wmid and wo must arrive rounded to bfloat16). Returns the
// cudaError_t of the launches.
int gvnmf_mh_chain(const float* x2, const float* vb, const float* wt,
                   const float* h, const float* mask, const float* g,
                   const float* ypre,
                   const float* z, const float* vs, const float* zn,
                   const float* u, const float* w1, const float* wmid,
                   const float* bmid, const float* wo, const float* bo,
                   float* z_out, float* vs_out, void* out1, float* out2,
                   float* out3, float* part1, float* part2, int B, int N,
                   int F, int L, int Hd, int K, int depth, int n_steps,
                   int burnin, float sqrt_var, int mode,
                   unsigned long long seed, int samples_bf16,
                   int approx_recip, int approx_trans, int mm_bf16,
                   void* stream) {
  const int nt = gvnmf_mh_chain_block(F);
  if (N % T != 0 || nt > MAX_NT || depth < 1 || burnin < 0 ||
      burnin > n_steps || (mode != MODE_E && mode != MODE_WF) ||
      (samples_bf16 && mode != MODE_E))
    return (int)cudaErrorInvalidValue;
  const bool vbf = vb != nullptr;
  if (vbf) K = 0;
  Params p{x2, vb, wt, h, mask, g, ypre, z, vs, zn, u, w1, wmid, bmid, wo, bo,
           z_out, vs_out,
           samples_bf16 ? nullptr : static_cast<float*>(out1), out2, out3,
           part1, part2, B, N, F, L, Hd, K, depth, n_steps, burnin, sqrt_var,
           (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
           samples_bf16 ? static_cast<__nv_bfloat16*>(out1) : nullptr,
           approx_recip != 0, approx_trans != 0, mm_bf16 != 0};
  const size_t smem = (size_t)gvnmf_mh_chain_smem(F, L, Hd, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the exact Philox kernel, or the one with runtime options
  const bool opts = zn != nullptr || samples_bf16 || approx_recip ||
                    approx_trans || mm_bf16;
  cudaError_t e;
  if (mode == MODE_E && !opts)
    e = vbf ? launch<MODE_E, true, false>(p, nt, smem, st)
            : launch<MODE_E, false, false>(p, nt, smem, st);
  else if (mode == MODE_E)
    e = vbf ? launch<MODE_E, true, true>(p, nt, smem, st)
            : launch<MODE_E, false, true>(p, nt, smem, st);
  else if (!opts)
    e = vbf ? launch<MODE_WF, true, false>(p, nt, smem, st)
            : launch<MODE_WF, false, false>(p, nt, smem, st);
  else
    e = vbf ? launch<MODE_WF, true, true>(p, nt, smem, st)
            : launch<MODE_WF, false, true>(p, nt, smem, st);
  if (e != cudaSuccess || mode != MODE_E || vbf) return (int)e;
  const int KF = K * F;
  sum_tiles_kernel<<<dim3((KF + 255) / 256, B), 256, 0, st>>>(
      part1, part2, out2, out3, N / T, KF);
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
