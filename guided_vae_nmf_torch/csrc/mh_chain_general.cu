// The MH chain (K1) for every decoder the TPU kernel takes: K1g, the
// general form.
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: mh_chain_pallas (body
// _make_chain_kernel) where the cluster form (mh_chain.cu) does not take
// the decoder: hidden layers of different widths, widths whose column
// slices pass a CTA's shared memory (128 x 4, 160 x 2, 256 x 2 at F = 513),
// more than 768 bins, or an NMF rank whose H tile does not fit. It computes
// what mh_chain_ref computes, in both modes (E with the sample dump and
// s1 / s2 or numW / denW; WF with the Wiener sums), both noise forms (WH=,
// Vb=), with the recorded streams and every fast option (bfloat16 dumps,
// approx_recip, approx_trans, bfloat16 decoder products), as the cluster
// form's kernel with runtime options does.
//
// What bounds it on an H100: float32 arithmetic, and here the L2. Per frame
// and step the decoder costs 2 (L H1 + sum H_i H_i+1 + H_d F) FLOP; the
// weights (half a MB to a MB at F = 513) cannot stay in one CTA's shared
// memory, so every step reads them from L2 (they stay there across CTAs).
//
// The design (a simple kernel, right first): one CTA of 4 frame groups x
// column quads threads per 16-frame tile of one utterance (96 CTAs at
// B = 4, N = 384), no cluster.
//   * The tile's latents, proposals, normals, the first layer's ypre and
//     the hidden activations ([width][16], sized by the widest layer) live
//     in shared memory. Each hidden layer is computed by work items of 2
//     units x 4 frames reading the layer's weights from global memory; each
//     unit's sum runs over its input in order, one FMA after another, as
//     the cluster form sums it.
//   * The output layer is computed by items of 4 columns x 4 frames (the
//     cluster form's register tile), summed over the last hidden layer in
//     order. The per-(frame, bin) state (X2, Vb, the proposal, the accepted
//     Vs and 1/Vx, the two accumulators) lives in global memory (L2): a
//     thread reads and writes only the elements of its own items, which
//     never change owner, so no barrier guards them.
//   * A frame's data term: each item writes its 4 frames' partial sums
//     over its columns to shared memory, and one warp a frame adds them in
//     column order, then over the warp's lanes by a fixed butterfly: the
//     order depends on F only, so a batch equals each utterance run alone.
//   * Draws: the cluster form's Philox4x32-10 counters (chain_common.cuh),
//     keyed on (seed, utterance, frame, step, draw): the same streams.
//   * numW / denW: each CTA writes its tile's (K, F) partials and a second
//     kernel adds them over tiles in order, as the cluster form does. No
//     float atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;          // frames a CTA: N % T == 0
constexpr int FG = 4;          // frames an output item
constexpr int NFG = T / FG;    // frame groups
constexpr int CC = 4;          // columns an output item
constexpr int HU = 2;          // hidden units a hidden-layer work item
constexpr int MAXD = 4;        // hidden layers
constexpr int MAX_NT = 640;    // threads a CTA: an item each up to F = 640,
                               // and 96 registers a thread
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
  const float* w1;    // (L, H1)
  const float* wm[MAXD - 1];  // hidden layer d + 1: (H_d, H_d+1)
  const float* bm[MAXD - 1];  // and its bias (H_d+1)
  const float* wo;    // (H_depth, F)
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
  float sqrt_var;
  uint32_t seed_lo, seed_hi;
  int approx_recip, approx_trans, mm_bf16;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// Threads a CTA: an output item (4 columns x 4 frames) a thread, in warps,
// at most MAX_NT (wider F loops over its items).
__host__ __device__ inline int block_threads(int F) {
  const int nt = 32 * cdiv(NFG * cdiv(F, CC), 32);
  return nt < 64 ? 64 : (nt > MAX_NT ? MAX_NT : nt);
}

__host__ __device__ inline int widest(const int* hw, int depth) {
  int m = 0;
  for (int d = 0; d < depth; ++d) m = hw[d] > m ? hw[d] : m;
  return m;
}

// Shared memory (floats): hA, hB [Hmax][T]; ypre [H1][T]; z, zp, zn [L][T];
// hk [K][T]; red [T][nq] (the output items' frame partials); g, mask, s,
// acc, dz [T]; logu [2][T].
__host__ __device__ inline size_t smem_floats(int F, int L, const int* hw,
                                              int depth, int K) {
  return (size_t)T * (2 * round4(widest(hw, depth)) + round4(hw[0]) +
                      3 * round4(L) + round4(K) + round4(cdiv(F, CC)) + 7);
}

struct Smem {
  float *hA, *hB, *ypre, *z, *zp, *zn, *hk, *red;
  float *g, *mask, *s, *acc, *dz, *logu;
};

__device__ inline Smem carve(float* base, const GParams& p) {
  Smem s;
  const int hmax = round4(widest(p.hw, p.depth));
  s.hA = base;
  s.hB = s.hA + hmax * T;
  s.ypre = s.hB + hmax * T;
  s.z = s.ypre + round4(p.hw[0]) * T;
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
  return s;
}

__device__ __forceinline__ float recip(const GParams& p, float x) {
  return p.approx_recip ? rcp_approx(x) : 1.0f / x;
}

__device__ __forceinline__ float log_k(const GParams& p, float x) {
  return p.approx_trans ? fast_log(x) : logf(x);
}

__device__ __forceinline__ float mix_var(float g, float vs, float vb) {
  return fmaxf(__fadd_rn(__fmul_rn(g, vs), vb), VX_FLOOR);
}

// This CTA's tile: frames n0 .. n0 + T - 1 of utterance b.
struct Tile {
  int b, tile, n0;
  __device__ size_t row(int t, int N) const {
    return (size_t)b * N + n0 + t;
  }
};

// One hidden layer: out[j][t] = tanh(sum_k in[k][t] w[k][j] + bias), bias
// the layer's (bias[j]) or, for the first layer, ypre[j][t]. Items of HU
// units x FG frames, neighbouring threads on neighbouring units (the
// weights' rows are read coalesced). Each sum runs over k in order. RND_IN
// rounds the input operand to bfloat16 as it is read (the first layer
// under mm_bf16), RND_OUT the output as it is written.
template <bool RND_IN, bool RND_OUT>
__device__ void hidden_layer(const float* in, int kin, const float* w,
                             int hout, const float* bias, const float* ypre,
                             float* out) {
  const int nu = cdiv(hout, HU);
  for (int it = threadIdx.x; it < nu * NFG; it += blockDim.x) {
    const int j = HU * (it % nu), f0 = FG * (it / nu);
    const bool two = j + 1 < hout;
    float a[HU][FG];
#pragma unroll
    for (int q = 0; q < HU; ++q)
#pragma unroll
      for (int i = 0; i < FG; ++i) a[q][i] = 0.0f;
    for (int k = 0; k < kin; ++k) {
      const float w0 = __ldg(w + (size_t)k * hout + j);
      const float w1 = two ? __ldg(w + (size_t)k * hout + j + 1) : 0.0f;
      float4 x = *reinterpret_cast<const float4*>(in + k * T + f0);
      if (RND_IN) {
        x.x = bf16_round(x.x);
        x.y = bf16_round(x.y);
        x.z = bf16_round(x.z);
        x.w = bf16_round(x.w);
      }
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        a[0][i] = fmaf(f4get(x, i), w0, a[0][i]);
        a[1][i] = fmaf(f4get(x, i), w1, a[1][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < HU; ++q) {
      if (j + q >= hout) break;
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const float bv = ypre ? ypre[(j + q) * T + f0 + i] : __ldg(bias + j + q);
        float hv = tanhf(__fadd_rn(a[q][i], bv));
        if (RND_OUT) hv = bf16_round(hv);
        out[(j + q) * T + f0 + i] = hv;
      }
    }
  }
}

// The hidden stack on the [L][T] latent tile `zin`; returns the buffer
// holding the last layer ([H_depth][T]), complete after the barrier.
template <bool RND>
__device__ const float* hidden_stack(const GParams& p, const Smem& sm,
                                     const float* zin) {
  hidden_layer<RND, RND>(zin, p.L, p.w1, p.hw[0], nullptr, sm.ypre, sm.hA);
  __syncthreads();
  float* src = sm.hA;
  float* dst = sm.hB;
  for (int d = 1; d < p.depth; ++d) {
    hidden_layer<false, RND>(src, p.hw[d - 1], p.wm[d - 1], p.hw[d],
                             p.bm[d - 1], nullptr, dst);
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

__device__ __forceinline__ const float* decoder_hidden(const GParams& p,
                                                       const Smem& sm,
                                                       const float* zin) {
  if (p.mm_bf16) return hidden_stack<true>(p, sm, zin);
  return hidden_stack<false>(p, sm, zin);
}

// An output item: columns c0 .. c0 + ncol - 1 (ncol <= CC) of frames
// t0 .. t0 + FG - 1.
struct Item {
  int cq, t0, c0, ncol;
};

__device__ __forceinline__ Item item(int it, int nq, int F) {
  Item m;
  m.cq = it % nq;
  m.t0 = FG * (it / nq);
  m.c0 = CC * m.cq;
  m.ncol = min(CC, F - m.c0);
  return m;
}

// v[j][i] = exp(h[:, t0 + i] . wo[:, c0 + j] + bo[c0 + j]), the sum over
// the last hidden layer in order.
__device__ __forceinline__ void out_item(const GParams& p, const float* h,
                                         const Item& m, float (&v)[CC][FG]) {
  const int hd = p.hw[p.depth - 1];
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < FG; ++i) v[j][i] = 0.0f;
  for (int k = 0; k < hd; ++k) {
    const float4 hk = *reinterpret_cast<const float4*>(h + k * T + m.t0);
    const float* wr = p.wo + (size_t)k * p.F + m.c0;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const float wk = j < m.ncol ? __ldg(wr + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < FG; ++i) v[j][i] = fmaf(f4get(hk, i), wk, v[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < CC; ++j) {
    const float b = j < m.ncol ? __ldg(p.bo + m.c0 + j) : 0.0f;
#pragma unroll
    for (int i = 0; i < FG; ++i) {
      const float x = __fadd_rn(v[j][i], b);
      v[j][i] = p.approx_trans ? fast_exp(x) : expf(x);
    }
  }
}

// The item's share of its frames' data terms, sum over its columns of
// log Vx + X2 / Vx, into red[t][cq].
__device__ __forceinline__ void item_terms(const GParams& p, const Smem& sm,
                                           const Tile& tl, const Item& m,
                                           const float (&v)[CC][FG],
                                           int nq) {
  const float* vbs = p.vb;
#pragma unroll
  for (int i = 0; i < FG; ++i) {
    const int t = m.t0 + i;
    const size_t o = tl.row(t, p.N) * p.F + m.c0;
    const float gt = sm.g[t];
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      if (j < m.ncol) {
        const float vx = mix_var(gt, v[j][i], vbs[o + j]);
        const float iv = recip(p, vx);
        part = __fadd_rn(part, __fadd_rn(log_k(p, vx), __fmul_rn(iv, p.x2[o + j])));
      }
    }
    sm.red[t * round4(nq) + m.cq] = part;
  }
}

// Frame t's sum of red[t][:]: a warp a frame, its lanes over the columns in
// order, then a fixed butterfly. Every lane returns the sum.
__device__ __forceinline__ float frame_sum(const float* red, int t, int nq) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int q = lane; q < nq; q += 32) s = __fadd_rn(s, red[t * round4(nq) + q]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
  return s;
}

// 0.5 sum_l (Z^2 - Zp^2) of each frame: a warp a frame.
__device__ __forceinline__ void latent_prior_terms(const GParams& p,
                                                   const Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
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
  const int nd = cdiv(p.L, 4);
  for (int i = threadIdx.x; i < T * nd + T; i += blockDim.x) {
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
template <int MODE, bool SAMPLE>
__device__ void mh_step(const GParams& p, const Smem& sm, const Tile& tl,
                        int m, int r) {
  const int nq = cdiv(p.F, CC), items = NFG * nq;
  for (int i = threadIdx.x; i < p.L * T; i += blockDim.x)
    sm.zp[i] = __fadd_rn(sm.z[i], __fmul_rn(p.sqrt_var, sm.zn[i]));
  __syncthreads();
  latent_prior_terms(p, sm);
  const float* hsrc = decoder_hidden(p, sm, sm.zp);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const Item mi = item(it, nq, p.F);
    float v[CC][FG];
    out_item(p, hsrc, mi, v);
    item_terms(p, sm, tl, mi, v, nq);
    if (SAMPLE) {
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const size_t o = tl.row(mi.t0 + i, p.N) * p.F + mi.c0;
#pragma unroll
        for (int j = 0; j < CC; ++j)
          if (j < mi.ncol) p.vp[o + j] = v[j][i];
      }
    }
  }
  __syncthreads();                      // red and dz complete; zn read
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
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
  __syncthreads();                      // acc complete
  for (int i = threadIdx.x; i < p.L * T; i += blockDim.x)
    if (sm.acc[i % T] != 0.0f) sm.z[i] = sm.zp[i];
  if (SAMPLE) {
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const Item mi = item(it, nq, p.F);
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const int t = mi.t0 + i;
        const bool acc = sm.acc[t] != 0.0f;
        const size_t o = tl.row(t, p.N) * p.F + mi.c0;
        const size_t so =
            ((size_t)(tl.b * (p.n_steps - p.burnin) + r) * p.N + tl.n0 + t) *
                p.F + mi.c0;
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          if (j >= mi.ncol) continue;
          float vs, iv;
          if (acc) {
            vs = p.vp[o + j];
            iv = recip(p, mix_var(sm.g[t], vs, p.vb[o + j]));
            p.vs_out[o + j] = vs;
            p.inv[o + j] = iv;
          } else {
            vs = p.vs_out[o + j];
            iv = p.inv[o + j];
          }
          if (MODE == MODE_E) {
            if (p.samples_h != nullptr)
              p.samples_h[so + j] = __float2bfloat16_rn(vs);
            else
              p.samples[so + j] = vs;
            p.a1[o + j] = __fadd_rn(p.a1[o + j], iv);
            p.a2[o + j] = __fadd_rn(p.a2[o + j], __fmul_rn(iv, iv));
          } else {
            const float tt = __fmul_rn(p.vb[o + j], iv);
            p.a2[o + j] = __fadd_rn(p.a2[o + j], tt);                    // acc_n
            p.a1[o + j] = __fadd_rn(p.a1[o + j], __fsub_rn(1.0f, tt));   // acc_s
          }
        }
      }
    }
  }
  __syncthreads();                      // z updated before the next proposal
}

// VB: the Vb form (p.vb is the input); else the WH form (p.vb is the
// scratch this kernel fills with H^T Wt). One CTA a tile; a 1-D grid.
template <int MODE, bool VB>
__global__ void __launch_bounds__(MAX_NT, 1) mh_chain_general_kernel(GParams p) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve(reinterpret_cast<float*>(smem_raw), p);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int n_tiles = p.N / T;
  Tile tl;
  tl.b = blockIdx.x / n_tiles;
  tl.tile = blockIdx.x % n_tiles;
  tl.n0 = tl.tile * T;
  const int nq = cdiv(p.F, CC), items = NFG * nq;
  const int h1 = p.hw[0];

  if (tid < T) {
    sm.g[tid] = p.g[tl.row(tid, p.N)];
    sm.mask[tid] = (MODE == MODE_E && !VB) ? p.mask[tl.row(tid, p.N)] : 0.0f;
  }
  if (!VB)
    for (int i = tid; i < p.K * T; i += NT)
      sm.hk[i] = p.h[((size_t)tl.b * p.K + i / T) * p.N + tl.n0 + i % T];
  for (int i = tid; i < T * p.L; i += NT) {
    const int t = i / p.L, l = i % p.L;
    sm.z[l * T + t] = p.z[tl.row(t, p.N) * p.L + l];
  }
  for (int i = tid; i < T * h1; i += NT) {
    const int t = i / h1, j = i % h1;
    sm.ypre[j * T + t] = p.ypre[tl.row(t, p.N) * h1 + j];
  }
  __syncthreads();

  // Vb (WH form), the accumulators, and the initial data term from the
  // caller's Vs (= decode(Z)), item by item
  for (int it = tid; it < items; it += NT) {
    const Item mi = item(it, nq, p.F);
    float v[CC][FG];
#pragma unroll
    for (int i = 0; i < FG; ++i) {
      const int t = mi.t0 + i;
      const size_t o = tl.row(t, p.N) * p.F + mi.c0;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        if (j >= mi.ncol) {
          v[j][i] = 1.0f;
          continue;
        }
        if (!VB) {
          float vb = 0.0f;
          for (int k = 0; k < p.K; ++k)
            vb = fmaf(sm.hk[k * T + t],
                      __ldg(p.wt + ((size_t)tl.b * p.K + k) * p.F + mi.c0 + j),
                      vb);
          p.vbw[o + j] = vb;
        }
        p.a1[o + j] = 0.0f;
        p.a2[o + j] = 0.0f;
        v[j][i] = p.vs[o + j];
      }
    }
    item_terms(p, sm, tl, mi, v, nq);
  }
  __syncthreads();
  {
    const int warp = tid >> 5, nw = NT >> 5;
    for (int t = warp; t < T; t += nw) {
      const float s = frame_sum(sm.red, t, nq);
      if ((tid & 31) == 0) sm.s[t] = s;
    }
  }
  if (p.n_steps > 0) draw(p, sm, tl, 0);
  __syncthreads();

  for (int m = 0; m < p.burnin; ++m) mh_step<MODE, false>(p, sm, tl, m, 0);

  // phase boundary: Vs = decode(Z) and 1/Vx at it; s stays as carried
  {
    const float* hsrc = decoder_hidden(p, sm, sm.z);
    for (int it = tid; it < items; it += NT) {
      const Item mi = item(it, nq, p.F);
      float v[CC][FG];
      out_item(p, hsrc, mi, v);
#pragma unroll
      for (int i = 0; i < FG; ++i) {
        const int t = mi.t0 + i;
        const size_t o = tl.row(t, p.N) * p.F + mi.c0;
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          if (j >= mi.ncol) continue;
          p.vs_out[o + j] = v[j][i];
          p.inv[o + j] = recip(p, mix_var(sm.g[t], v[j][i], p.vb[o + j]));
        }
      }
    }
  }
  __syncthreads();                      // the activations are read
  for (int r = 0; r < p.n_steps - p.burnin; ++r)
    mh_step<MODE, true>(p, sm, tl, p.burnin + r, r);

  for (int i = tid; i < T * p.L; i += NT) {
    const int t = i / p.L, l = i % p.L;
    p.z_out[tl.row(t, p.N) * p.L + l] = sm.z[l * T + t];
  }
  if (MODE == MODE_E && !VB) {
    // this tile's share of numW = H (X2 s2 mask), denW = H (s1 mask); the
    // accumulators of other threads' items, so after a fence and barrier
    __threadfence_block();
    __syncthreads();
    for (int i = tid; i < p.K * p.F; i += NT) {
      const int k = i / p.F, c = i % p.F;
      float num = 0.0f, den = 0.0f;
#pragma unroll
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

template <int MODE, bool VB>
cudaError_t launch(const GParams& p, size_t smem, int nt, cudaStream_t st) {
  auto kern = mh_chain_general_kernel<MODE, VB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mh_chain_general_kernel<MODE, VB>
      <<<(unsigned)(p.B * (p.N / T)), nt, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames a CTA (N must be a multiple).
int gvnmf_mh_chain_general_tile() { return T; }

// The most hidden layers the kernel takes.
int gvnmf_mh_chain_general_depth() { return MAXD; }

// Threads a CTA at F bins.
int gvnmf_mh_chain_general_block(int F) { return block_threads(F); }

// Dynamic shared memory a CTA (bytes) at these shapes; hw: the depth
// hidden widths.
long long gvnmf_mh_chain_general_smem(int F, int L, const int* hw, int depth,
                                      int K) {
  return (long long)smem_floats(F, L, hw, depth, K) * sizeof(float);
}

// Registers a thread of the E-mode WH kernel (cudaFuncGetAttributes), into
// out[0]. Returns the cudaError_t.
int gvnmf_mh_chain_general_registers(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, mh_chain_general_kernel<MODE_E, false>);
  out[0] = fa.numRegs;
  return (int)e;
}

// mode 0 = E (out1 = samples, float32 or, with samples_bf16, bfloat16; WH
// form: out2 / out3 = numW / denW (B, K, F) and part1 / part2 the per-tile
// scratch; Vb form: out2 / out3 = s1 / s2 (B, N, F)); mode 1 = WF (out1 =
// acc_s, out2 = acc_n). A non-null vb selects the Vb form (K = 0). wm / bm:
// depth - 1 hidden layers after the first; hw: the depth hidden widths.
// scratch: 5 B N F floats (the proposal, 1/Vx, the WH form's Vb and the
// WH E-mode accumulators). zn / u null: the in-kernel Philox stream keyed
// on `seed`. Returns the cudaError_t of the launches.
int gvnmf_mh_chain_general(
    const float* x2, const float* vb, const float* wt, const float* h,
    const float* mask, const float* g, const float* ypre, const float* z,
    const float* vs, const float* zn, const float* u, const float* w1,
    const float* const* wm, const float* const* bm, const float* wo,
    const float* bo, float* z_out, float* vs_out, void* out1, float* out2,
    float* out3, float* part1, float* part2, float* scratch, int B, int N,
    int F, int L, const int* hw, int depth, int K, int n_steps, int burnin,
    float sqrt_var, int mode, unsigned long long seed, int samples_bf16,
    int approx_recip, int approx_trans, int mm_bf16, void* stream) {
  if (N % T != 0 || depth < 1 || depth > MAXD || burnin < 0 ||
      burnin > n_steps || F < 1 || L < 1 ||
      (mode != MODE_E && mode != MODE_WF) || (samples_bf16 && mode != MODE_E))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < depth; ++d)
    if (hw[d] < 1) return (int)cudaErrorInvalidValue;
  const bool vbf = vb != nullptr;
  if (vbf) K = 0;
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
  p.w1 = w1;
  for (int d = 0; d + 1 < depth; ++d) {
    p.wm[d] = wm[d];
    p.bm[d] = bm[d];
  }
  p.wo = wo;
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
  p.sqrt_var = sqrt_var;
  p.seed_lo = (uint32_t)(seed & 0xffffffffull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.approx_recip = approx_recip != 0;
  p.approx_trans = approx_trans != 0;
  p.mm_bf16 = mm_bf16 != 0;
  const size_t smem = smem_floats(F, L, hw, depth, K) * sizeof(float);
  const int nt = block_threads(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == MODE_E)
    e = vbf ? launch<MODE_E, true>(p, smem, nt, st)
            : launch<MODE_E, false>(p, smem, nt, st);
  else
    e = vbf ? launch<MODE_WF, true>(p, smem, nt, st)
            : launch<MODE_WF, false>(p, smem, nt, st);
  if (e != cudaSuccess || mode != MODE_E || vbf) return (int)e;
  const int KF = K * F;
  sum_tiles_kernel<<<dim3((KF + 255) / 256, B), 256, 0, st>>>(
      part1, part2, out2, out3, N / T, KF);
  return (int)cudaGetLastError();
}

}  // extern "C"
