// Device helpers shared by the MH-chain kernels: the cluster form
// (mh_chain.cu) and the general form (mh_chain_general.cu). Included
// inside each file's anonymous namespace, so each library has its own
// copy; both draw the same Philox streams and evaluate the same fast log /
// exp.
//
// Keep in step: the wrapper's build hashes this header into each library's
// name, so an edit rebuilds both.

constexpr double LN2 = 0.6931471805599453;
constexpr double SQRT2 = 1.4142135623730951;

// rcp.approx: at most 1 ulp from 1/x. Vx >= 1e-10 is a normal float, so
// flushing subnormals changes nothing.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
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
