// The EM cost pass: each row's masked expected negative log-likelihood
// over the MH sample dumps, once an EM iteration.
//
// Replaces no TPU kernel: the JAX package's batched cost
// (guided_vae_nmf_tpu/mcem/pallas_engine.py: _masked_cost_batched) is plain
// jnp, which XLA fuses into one pass. In PyTorch the same expression is
// eight elementwise and reduction kernels, each writing and reading a
// (B, R, N, F) float32 temporary, and on the NMF path a (B, N, F) product
// W H before them: about sixteen times the dumps' bytes. This kernel reads
// the dumps once.
//
// With Vb = H^T Wt (the WH form) or the (B, N, F) input (the Vb form) and
// Vx = max(g Vs_r + Vb, 1e-10) over the R samples of a frame:
//   em_cost_kernel:       c[b, n] = sum_r sum_f (log Vx + X2 / Vx)
//   em_cost_final_kernel: cost[b] = sum_n mask c / (R F sum_n mask)
// in float32, with the plain version's roundings: g Vs and + Vb rounded
// apart (no FMA), the accurate logf, an IEEE division, no approximate
// reciprocal. Float32 or bfloat16 dumps (a template parameter; bfloat16
// read with __bfloat162float, as K2 reads it).
//
// Frames whose mask is 0 read no dumps and get c = 0: their term in the
// plain version is 0 x a finite value, since the chain writes finite dumps
// on every frame, dead tile pairs included.
//
// What bounds it on an H100: bytes and issue about equally. At B=16, R=10,
// N=512, F=513 the dumps are 168 MB and X2 17 MB; over one sweep batch's
// 7,011 valid frames the pass needs 158 MB (173 MB in the Vb form), a
// 47 us (52 us) bound at 3.35 TB/s, and the logf and the division of each
// of its 36 M elements issue in about as long.
//
// The design: a streaming pass over registers.
//   * A CTA takes FRAMES = 2 consecutive frames of one row, the blocks
//     tiled from n = 0 of each row; B ceil(N / 2) CTAs (4,096 at the sweep
//     shape) keep every SM busy for several waves.
//   * A thread owns bins f and f + nt (nt = 32 ceil(F / 64) threads, 288
//     at F = 513) of each frame: it holds X2, Vb and g there in registers
//     and loops over r two samples at a time, the next two samples' loads
//     in flight during the current two's math, each warp reading 32
//     neighbouring values a load. At most 64 registers a thread and no
//     spills, so an SM holds three CTAs.
//   * The WH form forms Vb = sum_k H[k, n] Wt[k, f] in registers, k in
//     order from 0 with one FMA a term (K2's order, so both kernels see the
//     same Vb): no (B, N, F) tensor is written.
//   * Measured on an H100 at that batch: the loads alone run at 81 % of
//     the byte bound; the logf and the division cost about as much again,
//     and the whole pass reaches 42-52 % of it (1, 4 or 8 frames a CTA, or
//     no overlap of loads with math, were slower).
// Fixed reduction order, a function of F only (not of B, N, the grid or
// which frames are live): per element r = 0 .. R-1 in order; per thread its
// two bins; per warp a butterfly; per frame the warps in order. The final
// kernel: per row, thread t sums frames t, t + 256, ... in order, then a
// butterfly and the 8 warps in order. So a row gives the same bits alone
// as inside a longer padded batch (pad frames add 0 x 0), and two launches
// give equal outputs. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FRAMES = 2;                 // frames a CTA
constexpr int BPT = 2;                    // bins a thread
constexpr int MAX_THREADS = 1024;
constexpr int FMAX = BPT * MAX_THREADS;
constexpr int FINAL_THREADS = 256;
constexpr float VX_FLOOR = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int threads_for(int F) {
  return 32 * ((F + BPT * 32 - 1) / (BPT * 32));
}

struct Params {
  const void* samples;
  const float *vb, *wt, *h, *g, *x2, *mask;
  float *c, *cost;
  int B, R, N, F, K;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// sample values of this CTA's frames at the thread's bins (0 where a
// frame is dead, a bin is past F or `want` is false); `sp` is frame n0 of
// one sample of the row
template <typename S>
__device__ __forceinline__ void load_sample(
    const S* sp, int F, const bool (&live)[FRAMES], const bool (&on)[BPT],
    const int (&cb)[BPT], bool want, float (&v)[FRAMES][BPT]) {
#pragma unroll
  for (int fr = 0; fr < FRAMES; ++fr) {
#pragma unroll
    for (int i = 0; i < BPT; ++i)
      v[fr][i] = (want && live[fr] && on[i]) ? to_float(sp[fr * F + cb[i]])
                                             : 0.0f;
  }
}

// acc += log Vx + X2 / Vx, Vx = max(g Vs + Vb, VX_FLOOR), as the plain
// version rounds it
__device__ __forceinline__ void accumulate(
    const float (&v)[FRAMES][BPT], const float (&gf)[FRAMES],
    const float (&vb)[FRAMES][BPT], const float (&x2)[FRAMES][BPT],
    const bool (&live)[FRAMES], const bool (&on)[BPT],
    float (&acc)[FRAMES][BPT]) {
#pragma unroll
  for (int fr = 0; fr < FRAMES; ++fr) {
    if (!live[fr]) continue;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      if (!on[i]) continue;
      const float vx = fmaxf(
          __fadd_rn(__fmul_rn(gf[fr], v[fr][i]), vb[fr][i]), VX_FLOOR);
      acc[fr][i] = __fadd_rn(acc[fr][i],
                             __fadd_rn(logf(vx), __fdiv_rn(x2[fr][i], vx)));
    }
  }
}

template <bool WH, typename S>
__global__ void __launch_bounds__(MAX_THREADS)
    em_cost_kernel(const Params p) {
  __shared__ float part[FRAMES][MAX_THREADS / 32];
  const int F = p.F, N = p.N, nt = blockDim.x;
  const int nblk = (N + FRAMES - 1) / FRAMES;
  const int b = blockIdx.x / nblk, n0 = (blockIdx.x - b * nblk) * FRAMES;
  const int tc = min(FRAMES, N - n0);
  const size_t row = (size_t)b * N + n0;        // frame n0 of row b
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  bool live[FRAMES];
  bool any = false;
#pragma unroll
  for (int fr = 0; fr < FRAMES; ++fr) {
    live[fr] = fr < tc && __ldg(p.mask + row + fr) != 0.0f;
    any |= live[fr];
  }
  if (!any) {                               // no live frame: c = 0
    if (tid < tc) p.c[row + tid] = 0.0f;
    return;
  }

  const int fb[BPT] = {tid, tid + nt};
  bool on[BPT];
  int cb[BPT];
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    on[i] = fb[i] < F;
    cb[i] = on[i] ? fb[i] : F - 1;
  }

  float gf[FRAMES], vb[FRAMES][BPT], x2[FRAMES][BPT], acc[FRAMES][BPT];
#pragma unroll
  for (int fr = 0; fr < FRAMES; ++fr) {
    gf[fr] = live[fr] ? __ldg(p.g + row + fr) : 0.0f;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const bool ld = live[fr] && on[i];
      const size_t o = (row + fr) * F + cb[i];
      x2[fr][i] = ld ? __ldg(p.x2 + o) : 0.0f;
      vb[fr][i] = (!WH && ld) ? __ldg(p.vb + o) : 0.0f;
      acc[fr][i] = 0.0f;
    }
  }
  // the first two samples' loads go out before Vb is formed
  const S* base = static_cast<const S*>(p.samples) +
                  (size_t)b * p.R * N * F + (size_t)n0 * F;
  const size_t step = (size_t)N * F;
  float v0[FRAMES][BPT], v1[FRAMES][BPT];
  load_sample(base, F, live, on, cb, p.R > 0, v0);
  load_sample(base + step, F, live, on, cb, p.R > 1, v1);
  if (WH) {                                 // Vb = H^T Wt, k in order
    const float* wt = p.wt + (size_t)b * p.K * F;
    const float* hb = p.h + (size_t)b * p.K * N + n0;
    for (int k = 0; k < p.K; ++k) {
      const float w0 = __ldg(wt + (size_t)k * F + cb[0]);
      const float w1 = __ldg(wt + (size_t)k * F + cb[1]);
#pragma unroll
      for (int fr = 0; fr < FRAMES; ++fr) {
        const float hk = live[fr] ? __ldg(hb + (size_t)k * N + fr) : 0.0f;
        vb[fr][0] = fmaf(hk, w0, vb[fr][0]);
        vb[fr][1] = fmaf(hk, w1, vb[fr][1]);
      }
    }
  }

  // two samples at a time, the next two's loads in flight during the
  // current two's math
  for (int r = 0; r < p.R; r += 2) {
    float next0[FRAMES][BPT], next1[FRAMES][BPT];
    load_sample(base + (r + 2) * step, F, live, on, cb, r + 2 < p.R, next0);
    load_sample(base + (r + 3) * step, F, live, on, cb, r + 3 < p.R, next1);
    accumulate(v0, gf, vb, x2, live, on, acc);
    if (r + 1 < p.R) accumulate(v1, gf, vb, x2, live, on, acc);
#pragma unroll
    for (int fr = 0; fr < FRAMES; ++fr) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        v0[fr][i] = next0[fr][i];
        v1[fr][i] = next1[fr][i];
      }
    }
  }

  // a frame: a thread's two bins, the warp's butterfly, the warps in order
#pragma unroll
  for (int fr = 0; fr < FRAMES; ++fr) {
    if (!live[fr]) continue;
    const float s = warp_sum(__fadd_rn(acc[fr][0], acc[fr][1]));
    if (lane == 0) part[fr][warp] = s;
  }
  __syncthreads();
  if (tid < tc) {
    float s = 0.0f;
    if (__ldg(p.mask + row + tid) != 0.0f) {
      s = part[tid][0];
      for (int w = 1; w < nt / 32; ++w) s = __fadd_rn(s, part[tid][w]);
    }
    p.c[row + tid] = s;
  }
}

__global__ void __launch_bounds__(FINAL_THREADS)
    em_cost_final_kernel(const Params p) {
  __shared__ float part[2][FINAL_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* c = p.c + (size_t)b * p.N;
  const float* m = p.mask + (size_t)b * p.N;
  float tot = 0.0f, cnt = 0.0f;
  for (int n = tid; n < p.N; n += FINAL_THREADS) {
    const float mn = m[n];
    tot = __fadd_rn(tot, __fmul_rn(mn, c[n]));
    cnt = __fadd_rn(cnt, mn);
  }
  tot = warp_sum(tot);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    part[0][warp] = tot;
    part[1][warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    tot = part[0][0];
    cnt = part[1][0];
    for (int w = 1; w < FINAL_THREADS / 32; ++w) {
      tot = __fadd_rn(tot, part[0][w]);
      cnt = __fadd_rn(cnt, part[1][w]);
    }
    p.cost[b] = __fdiv_rn(tot, __fmul_rn((float)(p.R * p.F), cnt));
  }
}

template <bool WH, typename S>
cudaError_t launch_t(const Params& p, cudaStream_t st) {
  const int threads = threads_for(p.F);
  const long long blocks =
      (long long)p.B * ((p.N + FRAMES - 1) / FRAMES);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0)
    em_cost_kernel<WH, S><<<(unsigned)blocks, threads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.B == 0) return e;
  em_cost_final_kernel<<<p.B, FINAL_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

int dispatch(const Params& p, int samples_bf16, void* stream) {
  if (p.F < 1 || p.F > FMAX || p.R < 0 || p.B < 0 || p.N < 0 ||
      (p.vb == nullptr && p.K < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.vb == nullptr)
    e = samples_bf16 ? launch_t<true, __nv_bfloat16>(p, st)
                     : launch_t<true, float>(p, st);
  else
    e = samples_bf16 ? launch_t<false, __nv_bfloat16>(p, st)
                     : launch_t<false, float>(p, st);
  return (int)e;
}

}  // namespace

extern "C" {

// The largest F the kernel takes: BPT bins a thread of at most 1024.
int gvnmf_em_cost_fmax() { return FMAX; }

// cost (B,) from samples (B, R, N, F) (bfloat16 if samples_bf16, else
// float32), g, mask (B, N), X2 (B, N, F) and either vb (B, N, F) or, with
// vb null, wt (B, K, F) and h (B, K, N); c (B, N) is the per-frame scratch.
// Returns the cudaError_t of the launches.
int gvnmf_em_cost(const void* samples, const float* vb, const float* wt,
                  const float* h, const float* g, const float* x2,
                  const float* mask, float* c, float* cost, int B, int R,
                  int N, int F, int K, int samples_bf16, void* stream) {
  Params p{samples, vb, wt, h, g, x2, mask, c, cost, B, R, N, F,
           vb == nullptr ? K : 0};
  return dispatch(p, samples_bf16, stream);
}

}  // extern "C"
