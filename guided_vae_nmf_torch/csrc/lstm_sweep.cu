// The RVAE decoder's bidirectional-LSTM sweeps for the Langevin chain, and
// the chain step's likelihood-gradient and update passes.
//
// Replaces no TPU kernel: the JAX package has no recurrent model. It was
// added because a Langevin step of the RVAE (models/rvae.py,
// mcem/rvae_engine.py) differentiates the log joint through both LSTM
// directions over the whole sequence, an ordered recurrence that a plain
// PyTorch or library LSTM runs as a few kernel launches per timestep: some
// 10^7 launches a batch. Here each sweep is one launch over the sequence.
//
//   lstm_sweep_fwd_kernel: both directions over Z (B, N, L), each row's
//     valid frames alone (the backward direction from the row's own last
//     valid frame); writes Hout (B, N, 2H) = [->h; <-h] and, for BPTT,
//     save (2, B, N, 5, H) = i, f, g, o, c of every frame; 0 at pad frames.
//   lstm_sweep_bwd_kernel: backpropagation through time of both
//     directions from dL/dHout, in each direction's reverse order; writes
//     dL/dz partials (2 directions, 2 CTAs, B, N, L), 0 at pad frames.
//   rvae_lik_kernel / langevin_update_kernel: one elementwise pass each
//     (see mcem/lstm_sweep.py).
//
// What bounds it on an H100: the recurrence's latency. A timestep of one
// direction is a (4H x H) matrix-vector product per row, 512 x 128
// multiply-adds, and the next timestep needs its result; at B = 64 rows
// and H = 128 the whole card's float32 rate would do a timestep of both
// directions in 0.25 us, so the time goes to the ordered chain of
// product, reduction, gate math and the hand-over of h to the next step.
// One direction's W_hh is 4H x H float32 = 256 KB, more than a CTA's
// 227 KB of shared memory, and reading it from L2 every step takes
// microseconds. So:
//   * each direction of RC rows runs on a cluster of 2 CTAs (512 threads,
//     one an SM). CTA `rank` owns units [64 rank, 64 rank + 64) and keeps
//     its 256 gate rows of W_hh (128 KB) in registers, 64 floats a thread,
//     loaded once a launch; no step reads a weight from memory.
//   * forward: thread (unit pair p, k segment s) holds the 4 gates x 2
//     units x 8 inputs of its slice, so each h value read from shared
//     memory feeds 8 multiply-adds. The 16 segments' partial sums meet in
//     a reduce-scatter over the 16 lanes (shuffles), and the lanes of each
//     (row, unit) gather its 4 gates, update c and h, and write h into
//     both CTAs' shared memory (the peer's through distributed shared
//     memory); one cluster barrier a step hands h to the next.
//   * backward: thread (8 output units, 8 gate rows) holds W_hh's
//     transpose slice; each CTA's partial dL/dh over its own gate rows
//     goes to the CTA that owns the unit (its own or the peer's shared
//     memory), summed there as rank 0's + rank 1's; dL/dz partials go to
//     memory and meet in the update pass.
//   * RC rows a cluster (1, 2 or 4, the wrapper's choice from the card's
//     resident clusters): each row's sums run in the same fixed order
//     whatever RC and whichever rows share its cluster, with no atomics, so
//     a batch's rows equal the same rows run alone bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H = 128;          // units a direction
constexpr int G4 = 4 * H;       // gate rows a direction
constexpr int HALF = H / 2;     // units a CTA
constexpr int NT = 512;         // threads a CTA
constexpr int MAXL = 16;        // latent dims the forward kernel's lanes take
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory index of element k of a padded vector: 4 floats of
// padding after every 32, so the 16-byte reads of 8 lanes (a quarter
// warp) at k = 8 s fall in distinct banks.
__device__ __forceinline__ int pidx(int k) { return k + 4 * (k >> 5); }
constexpr int HS = H + 16;          // padded h row
constexpr int DGS = 4 * HALF + 32;  // padded row of a CTA's 256 gate grads

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

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Reduce-scatter of V values over the lanes whose index bits M, M/2, .., 1
// differ: at each level a lane keeps one half of its values (the upper
// where its bit is set), adds its partner's copy of that half, and passes
// on; once one value is left the levels that remain add partners' values
// alike. Every value's sum is then the same tree over the lanes, so the
// result does not depend on where a value sits.
template <int V, int C, int M>
struct Scatter {
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    if constexpr (M > 0) {
      if constexpr (C > 1) {
        const bool up = (lane & M) != 0;
#pragma unroll
        for (int i = 0; i < C / 2; ++i) {
          const float send = up ? v[i] : v[i + C / 2];
          const float keep = up ? v[i + C / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(FULL, send, M);
        }
        Scatter<V, C / 2, M / 2>::run(v, lane);
      } else {
        v[0] = v[0] + __shfl_xor_sync(FULL, v[0], M);
        Scatter<V, 1, M / 2>::run(v, lane);
      }
    }
  }
};

template <int RC>
__device__ __forceinline__ int pick(const int (&a)[RC], int r) {
  int x = a[0];
#pragma unroll
  for (int i = 1; i < RC; ++i) x = (r == i) ? a[i] : x;
  return x;
}

struct FwdParams {
  const float* z;        // (B, N, L)
  const int* lengths;    // (B,)
  const float* w_ih;     // (2, L, 4H)
  const float* w_hh;     // (2, H, 4H)
  const float* b;        // (2, 4H)
  float* hout;           // (B, N, 2H)
  float* save;           // (2, B, N, 5, H)
  int B, N, L;
};

struct BwdParams {
  const float* dh;       // (B, N, 2H)
  const float* save;     // (2, B, N, 5, H)
  const int* lengths;
  const float* w_ih;
  const float* w_hh;
  float* dzp;            // (2 dir, 2 rank, B, N, L)
  int B, N, L;
};

// Grid: 2 CTAs a cluster, clusters (row group, direction) with the
// direction fastest.
template <int RC>
__global__ void __launch_bounds__(NT, 1) lstm_sweep_fwd_kernel(FwdParams p) {
  constexpr int V = 8 * RC;                   // (row, unit of the pair, gate)
  constexpr int VPL = V >= 16 ? V / 16 : 1;   // values a lane keeps
  constexpr int DUP = V >= 16 ? 1 : 16 / V;   // lanes holding each value
  constexpr int GS = (4 / VPL) * DUP;         // lanes of a (row, unit)
  __shared__ __align__(16) float hs[2][RC][HS];
  __shared__ float bs[8 * 32];

  const int rank = (int)cg::this_cluster().block_rank();
  const int cid = blockIdx.x >> 1;
  const int dir = cid & 1;
  const int grp = cid >> 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int seg = lane & 15;                  // inputs 8 seg .. 8 seg + 7
  const int base = lane & 16;
  const int pr = (tid >> 5) * 2 + (lane >> 4);  // unit pair 0..31
  const int L = p.L;
  const float* whh = p.w_hh + (size_t)dir * H * G4;
  const float* wih = p.w_ih + (size_t)dir * L * G4;
  const float* bb = p.b + dir * G4;

  // value v = 4 up + q: gate q of unit 64 rank + 2 pr + up
  float w[8][8], wi[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int col = (v & 3) * H + rank * HALF + 2 * pr + (v >> 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i][v] = whh[(size_t)(seg * 8 + i) * G4 + col];
    wi[v] = seg < L ? wih[(size_t)seg * G4 + col] : 0.0f;
  }
  if (tid < 8 * 32) {
    const int v = tid & 7, q = v & 3, up = v >> 2;
    bs[tid] = bb[q * H + rank * HALF + 2 * (tid >> 3) + up];
  }
  for (int i = tid; i < 2 * RC * HS; i += NT) (&hs[0][0][0])[i] = 0.0f;

  int len[RC];
  int T = 0;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int b = grp * RC + r;
    len[r] = b < p.B ? p.lengths[b] : 0;
    T = max(T, len[r]);
  }
  const bool rev = dir == 1;
  float zr[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int n = rev ? len[r] - 1 : 0;
    zr[r] = (len[r] > 0 && seg < L)
                ? p.z[((size_t)(grp * RC + r) * p.N + n) * L + seg]
                : 0.0f;
  }
  // this lane's (row, unit) after the reduction
  const int gi = seg / GS;
  const int my_r = gi >> 1, my_up = gi & 1;
  const int my_len = pick<RC>(len, my_r);
  const int my_b = grp * RC + my_r;
  const int ug = rank * HALF + 2 * pr + my_up;
  const bool writer = (seg % GS) == 0;
  float c = 0.0f;

  cluster_sync();   // the peer runs and its h buffers are zero
  float* hs_peer = cg::this_cluster().map_shared_rank(&hs[0][0][0], rank ^ 1);

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    float acc[V];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float* hr = &hs[cur][r][pidx(seg * 8)];
      const float4 h0 = *reinterpret_cast<const float4*>(hr);
      const float4 h1 = *reinterpret_cast<const float4*>(hr + 4);
      const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float a = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(w[i][v], hv[i], a);
        acc[r * 8 + v] = fmaf(wi[v], zr[r], a);
      }
    }
    if (seg == 0) {
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[r * 8 + v] += bs[pr * 8 + v];
    }
    // the next step's inputs, while this one reduces
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int t1 = t + 1;
      const int n = rev ? len[r] - 1 - t1 : t1;
      zr[r] = (t1 < len[r] && seg < L)
                  ? p.z[((size_t)(grp * RC + r) * p.N + n) * L + seg]
                  : 0.0f;
    }
    Scatter<V, V, 8>::run(acc, seg);
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gate[q] = __shfl_sync(FULL, acc[q % VPL],
                            base + ((gi * 4 + q) / VPL) * DUP);
    const float ig = sigm(gate[0]), fg = sigm(gate[1]);
    const float gg = tanhf(gate[2]), og = sigm(gate[3]);
    c = fg * c + ig * gg;
    const float h = og * tanhf(c);
    if (writer && t < my_len) {
      const int k = pidx(ug);
      hs[nxt][my_r][k] = h;
      hs_peer[(nxt * RC + my_r) * HS + k] = h;
      const int n = rev ? my_len - 1 - t : t;
      p.hout[((size_t)my_b * p.N + n) * 2 * H + dir * H + ug] = h;
      float* sv = p.save + (((size_t)dir * p.B + my_b) * p.N + n) * 5 * H + ug;
      sv[0] = ig;
      sv[H] = fg;
      sv[2 * H] = gg;
      sv[3 * H] = og;
      sv[4 * H] = c;
    }
    cluster_arrive();
    cluster_wait();
  }
  // pad frames: this CTA's units, 0
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int b = grp * RC + r;
    if (b >= p.B) continue;
    const int pad = p.N - len[r];
    for (int i = tid; i < pad * HALF; i += NT) {
      const int n = len[r] + i / HALF;
      const int u = rank * HALF + i % HALF;
      p.hout[((size_t)b * p.N + n) * 2 * H + dir * H + u] = 0.0f;
      float* sv = p.save + (((size_t)dir * p.B + b) * p.N + n) * 5 * H + u;
#pragma unroll
      for (int q = 0; q < 5; ++q) sv[q * H] = 0.0f;
    }
  }
}

template <int RC>
__global__ void __launch_bounds__(NT, 1) lstm_sweep_bwd_kernel(BwdParams p) {
  constexpr int V = 8 * RC;                  // (row, output unit)
  constexpr int DUP = 32 / V;                // V <= 32: one value a lane
  constexpr int DUPZ = 32 / RC;
  __shared__ __align__(16) float dg[RC][DGS];
  __shared__ float part[2][2][RC][HALF];     // [buffer][from rank][row][unit]

  const int rank = (int)cg::this_cluster().block_rank();
  const int cid = blockIdx.x >> 1;
  const int dir = cid & 1;
  const int grp = cid >> 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kg = tid >> 5;                   // output units 8 kg .. 8 kg + 7
  const int L = p.L;
  const float* whh = p.w_hh + (size_t)dir * H * G4;
  const float* wih = p.w_ih + (size_t)dir * L * G4;

  // local gate row jl = 64 q + u is gate q of unit 64 rank + u
  float wb[8][8], wz[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int jl = lane * 8 + jj;
    const int col = (jl >> 6) * H + rank * HALF + (jl & 63);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wb[jj][kk] = whh[(size_t)(kg * 8 + kk) * G4 + col];
    wz[jj] = kg < L ? wih[(size_t)kg * G4 + col] : 0.0f;
  }
  for (int i = tid; i < 2 * 2 * RC * HALF; i += NT)
    (&part[0][0][0][0])[i] = 0.0f;
  for (int i = tid; i < RC * DGS; i += NT) (&dg[0][0])[i] = 0.0f;

  int len[RC];
  int T = 0;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int b = grp * RC + r;
    len[r] = b < p.B ? p.lengths[b] : 0;
    T = max(T, len[r]);
  }
  // BPTT runs each direction against its own order
  const bool rev = dir == 0;
  // the (row, unit) role: one thread each, the gate gradients
  const bool role = tid < HALF * RC;
  const int ru = tid >> 6, uu = tid & 63;
  const int rb = grp * RC + ru;
  const int rlen = role ? pick<RC>(len, ru) : 0;
  const int ug = rank * HALF + uu;
  float si = 0, sf = 0, sg = 0, so = 0, sc = 0, scp = 0, sdh = 0;
  auto load = [&](int t) {
    const int n = rev ? rlen - 1 - t : t;
    const float* sv =
        p.save + (((size_t)dir * p.B + rb) * p.N + n) * 5 * H + ug;
    si = sv[0];
    sf = sv[H];
    sg = sv[2 * H];
    so = sv[3 * H];
    sc = sv[4 * H];
    const int np = dir == 0 ? n - 1 : n + 1;   // the cell before, in order
    scp = (np >= 0 && np < rlen)
              ? p.save[(((size_t)dir * p.B + rb) * p.N + np) * 5 * H + 4 * H +
                       ug]
              : 0.0f;
    sdh = p.dh[((size_t)rb * p.N + n) * 2 * H + dir * H + ug];
  };
  if (role && rlen > 0) load(0);
  float dc = 0.0f;

  cluster_sync();
  float* part_peer =
      cg::this_cluster().map_shared_rank(&part[0][0][0][0], rank ^ 1);

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (role) {
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
      if (t < rlen) {
        const float dh = sdh + (part[cur][0][ru][uu] + part[cur][1][ru][uu]);
        const float tc = tanhf(sc);
        const float dcc = dh * so * (1.0f - tc * tc) + dc;
        d0 = dcc * sg * si * (1.0f - si);
        d1 = dcc * scp * sf * (1.0f - sf);
        d2 = dcc * si * (1.0f - sg * sg);
        d3 = dh * tc * so * (1.0f - so);
        dc = dcc * sf;
        if (t + 1 < rlen) load(t + 1);
      }
      dg[ru][pidx(uu)] = d0;
      dg[ru][pidx(HALF + uu)] = d1;
      dg[ru][pidx(2 * HALF + uu)] = d2;
      dg[ru][pidx(3 * HALF + uu)] = d3;
    }
    __syncthreads();
    float acc[V], dz[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float* dr = &dg[r][pidx(lane * 8)];
      const float4 a0 = *reinterpret_cast<const float4*>(dr);
      const float4 a1 = *reinterpret_cast<const float4*>(dr + 4);
      const float dv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float a = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) a = fmaf(wb[jj][kk], dv[jj], a);
        acc[r * 8 + kk] = a;
      }
      float a = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) a = fmaf(wz[jj], dv[jj], a);
      dz[r] = a;
    }
    Scatter<V, V, 16>::run(acc, lane);
    Scatter<RC, RC, 16>::run(dz, lane);
    if (lane % DUP == 0) {
      const int v = lane / DUP;
      const int r = v >> 3;
      const int k = kg * 8 + (v & 7);
      if (t < pick<RC>(len, r)) {
        const int idx = ((nxt * 2 + rank) * RC + r) * HALF + (k & 63);
        if ((k >> 6) == rank)
          (&part[0][0][0][0])[idx] = acc[0];
        else
          part_peer[idx] = acc[0];
      }
    }
    if (kg < L && lane % DUPZ == 0) {
      const int r = lane / DUPZ;
      const int rl = pick<RC>(len, r);
      if (t < rl) {
        const int n = rev ? rl - 1 - t : t;
        p.dzp[((((size_t)dir * 2 + rank) * p.B + grp * RC + r) * p.N + n) *
                  L + kg] = dz[0];
      }
    }
    cluster_arrive();
    cluster_wait();
  }
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int b = grp * RC + r;
    if (b >= p.B) continue;
    const int pad = p.N - len[r];
    float* out = p.dzp + ((((size_t)dir * 2 + rank) * p.B + b) * p.N +
                          len[r]) * L;
    for (int i = tid; i < pad * L; i += NT) out[i] = 0.0f;
  }
}

__global__ void rvae_lik_kernel(const float* o, const float* bo,
                                const float* x2, const float* vb,
                                const float* g, const float* mask, float* vs,
                                float* G, size_t total, int F, float vx_floor) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t bn = i / F;
    const float s = expf(o[i] + bo[i - bn * F]);
    const float gs = g[bn] * s;
    const float vx = gs + vb[i];
    const float inv = 1.0f / fmaxf(vx, vx_floor);
    vs[i] = s;
    G[i] = (mask[bn] > 0.0f && vx >= vx_floor) ? (x2[i] * inv - 1.0f) * inv * gs
                                            : 0.0f;
  }
}

__global__ void langevin_update_kernel(const float* z, const float* parts,
                                       int D, const float* eps,
                                       const float* mask, float* out,
                                       size_t total, int L, float eta,
                                       float sq) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = parts[i];
    for (int d = 1; d < D; ++d) s = s + parts[(size_t)d * total + i];
    const float zv = z[i];
    out[i] = mask[i / L] > 0.0f ? zv + eta * (s - zv) + sq * eps[i] : zv;
  }
}

template <class K, class P>
cudaError_t launch_cluster(K kern, const P& p, int clusters,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(2 * clusters));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int blocks_for(size_t total) {
  size_t nb = (total + 255) / 256;
  return (int)(nb < 8192 ? (nb > 0 ? nb : 1) : 8192);
}

}  // namespace

extern "C" {

int gvnmf_lstm_hidden() { return H; }

// Clusters of the forward kernel at `rc` rows a cluster that the card can
// hold at once (the backward kernel has the same block and no more
// registers a thread), in out[0].
int gvnmf_lstm_max_clusters(int rc, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * 1024);
  cfg.blockDim = dim3(NT);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (rc == 1)
    e = cudaOccupancyMaxActiveClusters(out, lstm_sweep_fwd_kernel<1>, &cfg);
  else if (rc == 2)
    e = cudaOccupancyMaxActiveClusters(out, lstm_sweep_fwd_kernel<2>, &cfg);
  else if (rc == 4)
    e = cudaOccupancyMaxActiveClusters(out, lstm_sweep_fwd_kernel<4>, &cfg);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}

int gvnmf_lstm_fwd(const float* z, const int* lengths, const float* w_ih,
                   const float* w_hh, const float* b, float* hout,
                   float* save, int B, int N, int L, int rc, void* stream) {
  if (B < 1 || N < 1 || L < 1 || L > MAXL) return (int)cudaErrorInvalidValue;
  FwdParams p{z, lengths, w_ih, w_hh, b, hout, save, B, N, L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 2 * ((B + rc - 1) / rc);   // (row group, direction)
  switch (rc) {
    case 1: return (int)launch_cluster(lstm_sweep_fwd_kernel<1>, p, n, st);
    case 2: return (int)launch_cluster(lstm_sweep_fwd_kernel<2>, p, n, st);
    case 4: return (int)launch_cluster(lstm_sweep_fwd_kernel<4>, p, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int gvnmf_lstm_bwd(const float* dh, const float* save, const int* lengths,
                   const float* w_ih, const float* w_hh, float* dzp, int B,
                   int N, int L, int rc, void* stream) {
  if (B < 1 || N < 1 || L < 1 || L > MAXL) return (int)cudaErrorInvalidValue;
  BwdParams p{dh, save, lengths, w_ih, w_hh, dzp, B, N, L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 2 * ((B + rc - 1) / rc);   // (row group, direction)
  switch (rc) {
    case 1: return (int)launch_cluster(lstm_sweep_bwd_kernel<1>, p, n, st);
    case 2: return (int)launch_cluster(lstm_sweep_bwd_kernel<2>, p, n, st);
    case 4: return (int)launch_cluster(lstm_sweep_bwd_kernel<4>, p, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int gvnmf_rvae_lik(const float* o, const float* bo, const float* x2,
                   const float* vb, const float* g, const float* mask,
                   float* vs, float* G, int BN, int F, float vx_floor,
                   void* stream) {
  const size_t total = (size_t)BN * F;
  rvae_lik_kernel<<<blocks_for(total), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      o, bo, x2, vb, g, mask, vs, G, total, F, vx_floor);
  return (int)cudaGetLastError();
}

int gvnmf_langevin_update(const float* z, const float* parts,
                          const float* eps, const float* mask, float* out,
                          int BN, int L, int D, float eta, float sq,
                          void* stream) {
  const size_t total = (size_t)BN * L;
  langevin_update_kernel<<<blocks_for(total), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, parts, D, eps, mask, out, total, L, eta, sq);
  return (int)cudaGetLastError();
}

}  // extern "C"
