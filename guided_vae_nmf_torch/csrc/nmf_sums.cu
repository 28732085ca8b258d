// One-pass NMF M-step sums over the MH sample buffer (K2).
//
// Replaces guided_vae_nmf_tpu/mcem/pallas_engine.py: nmf_sums_pallas (body
// _make_sums_kernel), modes 'h' and 'g', with the NMF factors (WH=, K2a) or
// a given noise variance (Vb=, K2b), over float32 samples in exact math or,
// in fast mode (K2c), over the chain's bfloat16 sample dumps (converted
// with __bfloat162float) with every 1/Vx from the hardware approximate
// reciprocal (rcp.approx, within 1 ulp). The sample type and the
// reciprocal are template parameters, so the exact kernels are unchanged.
//
// With Vb = H^T Wt (K2a) or the (B, N, F) input (K2b) and
// inv_r = 1 / max(g Vs_r + Vb, 1e-10) over the R samples of a frame:
//   'h', WH: numH[k] = sum_f X2 (sum_r inv_r^2) Wt[k, f],
//            denH[k] = sum_f (sum_r inv_r) Wt[k, f]        -> (B, N, K) x2
//   'h', Vb: s1 = sum_r inv_r, s2 = sum_r inv_r^2           -> (B, N, F) x2
//   'g':     num = sum_f X2 sum_r Vs_r inv_r^2,
//            den = sum_{r, f} Vs_r inv_r                     -> (B, N) x2
//
// What bounds it on an H100: bytes. Each frame reads R F float32 samples
// plus F of X2 once (20 KB at R = 10, F = 513) for ~10 flops a sample. The
// TPU design kept a (R, 128, F) sample tile in VMEM and reduced over R
// vectorised. Here one warp owns one frame: its lanes walk F in coalesced
// 128-byte rows, every lane keeps its R-sums and its K partial H-update
// sums in registers, and a butterfly shuffle reduces them at the end. A
// frame's Wt column and H row are read once from L1/L2. No shared memory,
// no atomics; the order of every sum is fixed, so a run is reproducible.
// 'g' with Vb is the same warp-per-frame pass with each bin's Vb read from
// the input. 'h' with Vb reduces over R only: a pure stream in which each
// thread owns (frame, bin) elements, reads R samples and Vb, and writes s1
// and s2 with coalesced stores (R + 1 arrays in, 2 out). bfloat16 samples
// halve the bytes of the dominant input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 16;          // largest NMF rank
constexpr int WARPS = 8;          // frames per block
constexpr float VX_FLOOR = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_H = 0, MODE_G = 1 };

__device__ __forceinline__ float load_sample(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_sample(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// rcp.approx: at most 1 ulp from 1/x; Vx >= 1e-10 is a normal float.
template <bool APPROX>
__device__ __forceinline__ float recip(float x) {
  if (!APPROX) return 1.0f / x;            // IEEE division
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// One warp per frame. VB reads each bin's Vb from `vbp` (only with 'g').
template <int MODE, bool VB, typename S, bool APPROX>
__global__ void __launch_bounds__(WARPS * 32)
    nmf_sums_kernel(const S* __restrict__ samples,
                    const float* __restrict__ vbp,
                    const float* __restrict__ wt, const float* __restrict__ h,
                    const float* __restrict__ g, const float* __restrict__ x2,
                    float* __restrict__ o1, float* __restrict__ o2, int B,
                    int R, int N, int F, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (long long)B * N) return;
  const int b = (int)(row / N), n = (int)(row % N);
  float hk[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    hk[k] = (!VB && k < K) ? __ldg(h + ((size_t)b * K + k) * N + n) : 0.0f;
  const float gn = __ldg(g + row);
  const float* wtb = wt + (size_t)b * K * F;
  const float* x2r = x2 + (size_t)row * F;
  const size_t rstride = (size_t)N * F;   // between samples of one frame
  const S* s0 = samples + ((size_t)b * R * N + n) * F;

  float num[KMAX], den[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) num[k] = den[k] = 0.0f;

  for (int c = lane; c < F; c += 32) {
    float wk[KMAX];
    float vb = 0.0f;
    if (VB) {
      vb = __ldg(vbp + (size_t)row * F + c);
    } else {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        wk[k] = k < K ? __ldg(wtb + (size_t)k * F + c) : 0.0f;
        if (k < K) vb = fmaf(hk[k], wk[k], vb);
      }
    }
    const float xv = __ldg(x2r + c);
    float a = 0.0f, d = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float vs = load_sample(s0 + r * rstride + c);
      const float vx = fmaxf(__fadd_rn(__fmul_rn(gn, vs), vb), VX_FLOOR);
      const float inv = recip<APPROX>(vx);
      if (MODE == MODE_H) {
        d = __fadd_rn(d, inv);                          // s1
        a = __fadd_rn(a, __fmul_rn(inv, inv));          // s2
      } else {
        const float vi = __fmul_rn(vs, inv);
        a = __fadd_rn(a, __fmul_rn(vi, inv));           // sum_r Vs inv^2
        d = __fadd_rn(d, vi);                           // sum_r Vs inv
      }
    }
    if (MODE == MODE_H) {
      const float xs2 = __fmul_rn(xv, a);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        num[k] = fmaf(xs2, wk[k], num[k]);
        den[k] = fmaf(d, wk[k], den[k]);
      }
    } else {
      num[0] = fmaf(xv, a, num[0]);
      den[0] = __fadd_rn(den[0], d);
    }
  }

  if (MODE == MODE_H) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      const float sn = warp_sum(num[k]), sd = warp_sum(den[k]);
      if (lane == 0) {
        o1[(size_t)row * K + k] = sn;
        o2[(size_t)row * K + k] = sd;
      }
    }
  } else {
    const float sn = warp_sum(num[0]), sd = warp_sum(den[0]);
    if (lane == 0) {
      o1[row] = sn;
      o2[row] = sd;
    }
  }
}

// 'h' with Vb: s1 = sum_r inv_r, s2 = sum_r inv_r^2 per (frame, bin), one
// element per thread and grid-stride, samples read r-slab by r-slab.
template <typename S, bool APPROX>
__global__ void __launch_bounds__(256)
    sums_h_vb_kernel(const S* __restrict__ samples,
                     const float* __restrict__ vb,
                     const float* __restrict__ g, float* __restrict__ s1,
                     float* __restrict__ s2, int B, int R, int N, int F) {
  const size_t NF = (size_t)N * F, total = (size_t)B * NF;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t b = idx / NF, rem = idx - b * NF;
    const float gn = __ldg(g + idx / F);
    const float v = __ldg(vb + idx);
    const S* sp = samples + b * R * NF + rem;
    float d = 0.0f, a = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float vx = fmaxf(
          __fadd_rn(__fmul_rn(gn, load_sample(sp + r * NF)), v), VX_FLOOR);
      const float inv = recip<APPROX>(vx);
      d = __fadd_rn(d, inv);
      a = __fadd_rn(a, __fmul_rn(inv, inv));
    }
    s1[idx] = d;
    s2[idx] = a;
  }
}

template <typename S, bool APPROX>
cudaError_t launch(const void* samples_v, const float* vb, const float* wt,
                   const float* h, const float* g, const float* x2, float* o1,
                   float* o2, int B, int R, int N, int F, int K, int mode,
                   cudaStream_t st) {
  const S* samples = static_cast<const S*>(samples_v);
  const long long rows = (long long)B * N;
  const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
  if (vb != nullptr && mode == MODE_H) {
    const size_t total = (size_t)B * N * F;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    sums_h_vb_kernel<S, APPROX><<<blocks, 256, 0, st>>>(samples, vb, g, o1,
                                                        o2, B, R, N, F);
  } else if (vb != nullptr) {
    nmf_sums_kernel<MODE_G, true, S, APPROX><<<grid, WARPS * 32, 0, st>>>(
        samples, vb, wt, h, g, x2, o1, o2, B, R, N, F, 0);
  } else if (mode == MODE_H) {
    nmf_sums_kernel<MODE_H, false, S, APPROX><<<grid, WARPS * 32, 0, st>>>(
        samples, vb, wt, h, g, x2, o1, o2, B, R, N, F, K);
  } else {
    nmf_sums_kernel<MODE_G, false, S, APPROX><<<grid, WARPS * 32, 0, st>>>(
        samples, vb, wt, h, g, x2, o1, o2, B, R, N, F, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gvnmf_nmf_sums_kmax() { return KMAX; }

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
  if ((mode != MODE_H && mode != MODE_G) ||
      (vb == nullptr && (K < 1 || K > KMAX)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (samples_bf16 && approx_recip)
    e = launch<__nv_bfloat16, true>(samples, vb, wt, h, g, x2, o1, o2, B, R,
                                    N, F, K, mode, st);
  else if (samples_bf16)
    e = launch<__nv_bfloat16, false>(samples, vb, wt, h, g, x2, o1, o2, B, R,
                                     N, F, K, mode, st);
  else if (approx_recip)
    e = launch<float, true>(samples, vb, wt, h, g, x2, o1, o2, B, R, N, F, K,
                            mode, st);
  else
    e = launch<float, false>(samples, vb, wt, h, g, x2, o1, o2, B, R, N, F,
                             K, mode, st);
  return (int)e;
}

}  // extern "C"
