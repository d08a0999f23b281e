// Fused scaled OSQP-ADMM iterations of the structured SAA QP, for Hopper.
//
// Replaces riskaversetrajopt_tpu/ops/pallas/experimental/saa_admm.py:
// admm_chunk_pallas (the pallas_call at saa_admm.py:793). The math is that
// file's _iter_body / _solve_kkt / _small_updates; the plain PyTorch version
// is riskaversetrajopt_torch/ops/cuda/saa_admm.py:one_iter_ref, in the same
// natural layout: Gs (M, K, n), sample-row state (M, K), per-sample vectors
// (M,), small rows [final (n_fc) | cvar | slack | control (n)].
//
// What bounds it on an H100: each iteration reads the scaled Jacobian stack
// Gs twice (the A^T sweep and the A sweep): 2 x 14.4 MB at M=1000, K=n=60,
// which fits in the 50 MB L2, so after the first iteration the sweeps run
// from L2 rather than HBM. Between the sweeps sits a grid-wide dependency
// (the KKT solve needs the reduction over all M samples, and sweep 2 needs
// the solve's u_t), so each iteration is three launches, and launch latency
// plus the one-block solve (a dense (n+2)^2 matvec with the explicit Schur
// inverse and a few reductions over M) are the other bounds.
//
// The design: one C call per chunk loops `chunk` times over three launches
// on the caller's stream:
//   1. sweep1: blocks over samples; each block writes a partial sum of
//      u_part = sum_{m,k} w_G Gs[m,k,:] and of sum eGt w_G, plus the
//      per-sample rowsum_y. Partials are reduced in a fixed order by the
//      solve (no float atomics), so repeated runs agree bit for bit.
//   2. solve: one block does the partial reduction, the rhs, the
//      Sherman-Morrison y-block elimination, r_v Sinv, and the small-row,
//      y-row, u, s and t updates; it writes u_t, y_t and t_t to scratch.
//   3. sweep2: half a warp per sample row computes zt = Gs u_t - eGy y_t -
//      eGt t_t and applies the relax/clip/dual update to z_G, yd_G in place.
// A cooperative persistent kernel, clusters, wgmma or TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsaa_admm.so saa_admm.cu
// Binding: plain C entry point saa_admm_chunk (ctypes); it returns
// cudaGetLastError() and the caller raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSweepThreads = 256;   // sweep1 / sweep2 block size
constexpr int kSolveThreads = 1024;  // the one-block solve
constexpr int kSamplesPerBlock = 4;  // sweep1 samples per block

// Problem data, in the order of ScaledSAA's fields (ops/cuda/saa_admm.py).
struct Prob {
  const float *Gs, *eGy, *eGt, *rv_G, *lb_G, *ub_G;
  const float *rv_y, *lb_y, *ub_y, *cy_hat, *yd_hat, *ys_hat, *Dinv, *wD;
  const float *rv_small, *lb_small, *ub_small;
  const float *Fs, *cu, *q_hat_u, *Sinv, *Cbar;
  const float *ct_hat, *cs_hat, *ss_hat, *q_hat_s, *sm_beta, *sm_denom,
      *sigma, *alpha_relax;
};
constexpr int kProbPtrs = 30;
static_assert(sizeof(Prob) == kProbPtrs * sizeof(float*), "Prob is a pointer list");

// Iterate, in the order of ScaledState's fields.
struct State {
  float *u, *s, *t, *y, *z_y, *yd_y, *z_G, *yd_G, *z_small, *yd_small;
};
constexpr int kStatePtrs = 10;
static_assert(sizeof(State) == kStatePtrs * sizeof(float*), "State is a pointer list");

struct Scratch {
  float *partials;  // (nblk1, n+1): per-block u_part | sum eGt w
  float *rowsum_y;  // (M,)
  float *rhs_y;     // (M,)
  float *g_y;       // (M,)
  float *y_t;       // (M,)
  float *vt;        // (n+2,): u_t | s_t | t_t
};
constexpr int kScratchPtrs = 6;
static_assert(sizeof(Scratch) == kScratchPtrs * sizeof(float*), "Scratch is a pointer list");

struct Dims {
  int M, K, n, n_fc, nblk1;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Deterministic block-wide sum; every thread of the block must call it.
// `red` holds at least 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ void row_update(float al, float& z, float& yd,
                                           float zt, float rv, float lb,
                                           float ub) {
  const float z_relax = al * zt + (1.0f - al) * z;
  const float z_next = fminf(fmaxf(z_relax + yd / rv, lb), ub);
  yd = yd + rv * (z_relax - z_next);
  z = z_next;
}

// ---- sweep 1: A^T contribution of the sample rows + per-sample sums ----
__global__ void __launch_bounds__(kSweepThreads)
sweep1_kernel(Prob p, State st, Scratch sc, Dims d) {
  extern __shared__ float sh[];
  const int K = d.K, n = d.n;
  float* w = sh;                              // kSamplesPerBlock * K
  float* egt = w + kSamplesPerBlock * K;      // kSamplesPerBlock
  float* red = egt + kSamplesPerBlock;        // kSweepThreads
  const int m0 = blockIdx.x * kSamplesPerBlock;
  const int ms = min(kSamplesPerBlock, d.M - m0);
  const int tid = threadIdx.x;

  for (int e = tid; e < ms * K; e += blockDim.x) {
    const size_t idx = (size_t)m0 * K + e;
    w[e] = p.rv_G[idx] * st.z_G[idx] - st.yd_G[idx];
  }
  __syncthreads();

  // per-sample reductions over k: one warp per sample
  const int lane = tid & 31, warp = tid >> 5;
  for (int ml = warp; ml < ms; ml += blockDim.x >> 5) {
    float a = 0.0f, b = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const size_t idx = (size_t)(m0 + ml) * K + k;
      const float wv = w[ml * K + k];
      a += p.eGy[idx] * wv;
      b += p.eGt[idx] * wv;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      sc.rowsum_y[m0 + ml] = a;
      egt[ml] = b;
    }
  }

  // u_part: thread (r, j) sums rows r, r+nr, ... of the block's (ms*K, n)
  // slab for column j; neighbouring threads read neighbouring addresses
  const int nr = blockDim.x / n;
  const int r = tid / n, j = tid - (tid / n) * n;
  float acc = 0.0f;
  if (r < nr) {
    const float* G = p.Gs + (size_t)m0 * K * n;
    for (int row = r; row < ms * K; row += nr) acc += w[row] * G[(size_t)row * n + j];
    red[tid] = acc;
  }
  __syncthreads();
  float* part = sc.partials + (size_t)blockIdx.x * (n + 1);
  if (tid < n) {
    float s = 0.0f;
    for (int rr = 0; rr < nr; ++rr) s += red[rr * n + tid];
    part[tid] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int ml = 0; ml < ms; ++ml) s += egt[ml];
    part[n] = s;
  }
}

// ---- solve: KKT solve + every update except the sample rows ----
__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(Prob p, State st, Scratch sc, Dims d) {
  extern __shared__ float sh[];
  const int M = d.M, n = d.n, n_fc = d.n_fc;
  const int nv = n + 2, ns = n_fc + 2 + n, ncol = n + 1;
  const int tid = threadIdx.x, NT = blockDim.x;
  float* red = sh;            // NT + 33
  float* up = red + NT + 33;  // n + 1: reduced u_part | sum eGt w
  float* wsm = up + ncol;     // ns: small-row w
  float* rv = wsm + ns;       // nv: r_v
  float* v = rv + nv;         // nv: solution of the coupled block

  const float sig = *p.sigma, al = *p.alpha_relax;
  const float beta = *p.sm_beta, denom = *p.sm_denom;

  // A. fixed-order reduction of sweep1's per-block partials
  {
    const int nr = NT / ncol;
    const int r = tid / ncol, j = tid - (tid / ncol) * ncol;
    if (r < nr) {
      float s = 0.0f;
      for (int b = r; b < d.nblk1; b += nr) s += sc.partials[(size_t)b * ncol + j];
      red[tid] = s;
    }
    __syncthreads();
    if (tid < ncol) {
      float s = 0.0f;
      for (int rr = 0; rr < nr; ++rr) s += red[rr * ncol + tid];
      up[tid] = s;
    }
  }
  // B. small-row w
  for (int i = tid; i < ns; i += NT)
    wsm[i] = p.rv_small[i] * st.z_small[i] - st.yd_small[i];
  __syncthreads();
  const float w_c = wsm[n_fc], w_s = wsm[n_fc + 1];

  // C. rhs_u (final-row and control-row contributions added in order)
  for (int j = tid; j < n; j += NT) {
    float u_part = up[j];
    for (int i = 0; i < n_fc; ++i) u_part = u_part + wsm[i] * p.Fs[i * n + j];
    u_part = u_part + p.cu[j] * wsm[n_fc + 2 + j];
    rv[j] = sig * st.u[j] - p.q_hat_u[j] + u_part;
  }
  // D. rhs_y per sample; sums for rhs_s and the first Sherman-Morrison
  float a_ys = 0.0f, a_wd = 0.0f;
  for (int m = tid; m < M; m += NT) {
    const float w_y = p.rv_y[m] * st.z_y[m] - st.yd_y[m];
    const float r_y =
        sig * st.y[m] + p.cy_hat[m] * w_c - p.yd_hat[m] * w_y - sc.rowsum_y[m];
    sc.rhs_y[m] = r_y;
    a_ys += p.ys_hat[m] * w_y;
    a_wd += p.wD[m] * r_y;
  }
  const float sum_ysw = block_sum(a_ys, red);
  const float sum_wdr = block_sum(a_wd, red);
  if (tid == 0) {
    rv[n] = sig * *st.s - *p.q_hat_s + *p.cs_hat * w_c - sum_ysw -
            *p.ss_hat * w_s;
    rv[n + 1] = sig * *st.t + *p.ct_hat * w_c - up[n];
  }
  // E. g_y = (D + beta w w^T)^-1 rhs_y
  {
    const float coef = beta * sum_wdr / denom;
    for (int m = tid; m < M; m += NT)
      sc.g_y[m] = p.Dinv[m] * sc.rhs_y[m] - coef * p.wD[m];
  }
  __syncthreads();
  // F. r_v -= Cbar^T g_y
  {
    const int nr = NT / nv;
    const int r = tid / nv, j = tid - (tid / nv) * nv;
    if (r < nr) {
      float s = 0.0f;
      for (int m = r; m < M; m += nr) s += p.Cbar[(size_t)m * nv + j] * sc.g_y[m];
      red[tid] = s;
    }
    __syncthreads();
    if (tid < nv) {
      float s = 0.0f;
      for (int rr = 0; rr < nr; ++rr) s += red[rr * nv + tid];
      rv[tid] = rv[tid] - s;
    }
    __syncthreads();
  }
  // G. v = r_v Sinv
  for (int j = tid; j < nv; j += NT) {
    float s = 0.0f;
    for (int i = 0; i < nv; ++i) s += rv[i] * p.Sinv[i * nv + j];
    v[j] = s;
    sc.vt[j] = s;
  }
  __syncthreads();
  const float s_t = v[n], t_t = v[n + 1];
  // H. y_t = (D + beta w w^T)^-1 (rhs_y - Cbar v)
  float a2 = 0.0f;
  for (int m = tid; m < M; m += NT) {
    const float* crow = p.Cbar + (size_t)m * nv;
    float cv = 0.0f;
    for (int j = 0; j < nv; ++j) cv += crow[j] * v[j];
    const float r2 = sc.rhs_y[m] - cv;
    sc.g_y[m] = r2;
    a2 += p.wD[m] * r2;
  }
  const float coef2 = beta * block_sum(a2, red) / denom;
  // I. y rows: y, z_y, yd_y updates; sum cy_hat y_t for the CVaR row
  float a_cy = 0.0f;
  for (int m = tid; m < M; m += NT) {
    const float y_t = p.Dinv[m] * sc.g_y[m] - coef2 * p.wD[m];
    sc.y_t[m] = y_t;
    a_cy += p.cy_hat[m] * y_t;
    const float zt_y = -p.yd_hat[m] * y_t - p.ys_hat[m] * s_t;
    st.y[m] = al * y_t + (1.0f - al) * st.y[m];
    float z = st.z_y[m], yd = st.yd_y[m];
    row_update(al, z, yd, zt_y, p.rv_y[m], p.lb_y[m], p.ub_y[m]);
    st.z_y[m] = z;
    st.yd_y[m] = yd;
  }
  const float zt_c = block_sum(a_cy, red) + *p.cs_hat * s_t + *p.ct_hat * t_t;
  // J. small rows and the coupled variables
  for (int i = tid; i < ns; i += NT) {
    float zt;
    if (i < n_fc) {
      zt = 0.0f;
      for (int j = 0; j < n; ++j) zt += p.Fs[i * n + j] * v[j];
    } else if (i == n_fc) {
      zt = zt_c;
    } else if (i == n_fc + 1) {
      zt = -*p.ss_hat * s_t;
    } else {
      zt = p.cu[i - n_fc - 2] * v[i - n_fc - 2];
    }
    float z = st.z_small[i], yd = st.yd_small[i];
    row_update(al, z, yd, zt, p.rv_small[i], p.lb_small[i], p.ub_small[i]);
    st.z_small[i] = z;
    st.yd_small[i] = yd;
  }
  for (int j = tid; j < n; j += NT) st.u[j] = al * v[j] + (1.0f - al) * st.u[j];
  if (tid == 0) {
    *st.s = al * s_t + (1.0f - al) * *st.s;
    *st.t = al * t_t + (1.0f - al) * *st.t;
  }
}

// ---- sweep 2: zt = Gs u_t - eGy y_t - eGt t_t + in-place row update ----
__global__ void __launch_bounds__(kSweepThreads)
sweep2_kernel(Prob p, State st, Scratch sc, Dims d) {
  extern __shared__ float u_sh[];  // n
  const int n = d.n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) u_sh[j] = sc.vt[j];
  __syncthreads();
  const float al = *p.alpha_relax, t_t = sc.vt[n + 1];
  const int lane = threadIdx.x & 15;
  const size_t rows = (size_t)d.M * d.K;
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 4;
  if (row >= rows) return;  // whole half-warps leave together
  const float* g = p.Gs + row * n;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 16) acc += g[j] * u_sh[j];
  // the shuffles stay inside this half-warp, whose 16 lanes are all here
  const unsigned half = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(half, acc, off, 16);
  if (lane == 0) {
    const int m = (int)(row / d.K);
    const float zt = acc - p.eGy[row] * sc.y_t[m] - p.eGt[row] * t_t;
    float z = st.z_G[row], yd = st.yd_G[row];
    row_update(al, z, yd, zt, p.rv_G[row], p.lb_G[row], p.ub_G[row]);
    st.z_G[row] = z;
    st.yd_G[row] = yd;
  }
}

}  // namespace

extern "C" {

// Runs `chunk` iterations. ptrs holds, in order: the 30 problem arrays
// (Prob), the 10 input state arrays, the 10 output state arrays (State) and
// the 6 scratch arrays (Scratch), all float32 device pointers. The input
// state is copied to the output first; the iterations then update the
// output in place. Returns cudaGetLastError() of the first failing step.
int saa_admm_chunk(const void* const* ptrs, int n_ptrs, int M, int K, int n,
                   int n_fc, int chunk, void* stream_ptr) {
  if (n_ptrs != kProbPtrs + 2 * kStatePtrs + kScratchPtrs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Prob p;
  const float** pp = reinterpret_cast<const float**>(&p);
  for (int i = 0; i < kProbPtrs; ++i) pp[i] = static_cast<const float*>(ptrs[i]);
  const void* const* in = ptrs + kProbPtrs;
  State st;
  float** sp = reinterpret_cast<float**>(&st);
  for (int i = 0; i < kStatePtrs; ++i)
    sp[i] = const_cast<float*>(static_cast<const float*>(ptrs[kProbPtrs + kStatePtrs + i]));
  Scratch sc;
  float** scp = reinterpret_cast<float**>(&sc);
  for (int i = 0; i < kScratchPtrs; ++i)
    scp[i] = const_cast<float*>(
        static_cast<const float*>(ptrs[kProbPtrs + 2 * kStatePtrs + i]));

  const int ns = n_fc + 2 + n;
  const size_t sizes[kStatePtrs] = {
      (size_t)n, 1, 1, (size_t)M, (size_t)M, (size_t)M,
      (size_t)M * K, (size_t)M * K, (size_t)ns, (size_t)ns};
  for (int i = 0; i < kStatePtrs; ++i) {
    cudaError_t e = cudaMemcpyAsync(sp[i], in[i], sizes[i] * sizeof(float),
                                    cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
  }

  Dims d{M, K, n, n_fc, (M + kSamplesPerBlock - 1) / kSamplesPerBlock};
  const size_t sh1 = (size_t)(kSamplesPerBlock * K + kSamplesPerBlock + kSweepThreads) * sizeof(float);
  const size_t sh2 = (size_t)(kSolveThreads + 33 + (n + 1) + ns + 2 * (n + 2)) * sizeof(float);
  const size_t sh3 = (size_t)n * sizeof(float);
  const size_t rows = (size_t)M * K;
  const unsigned nblk3 = (unsigned)((rows * 16 + kSweepThreads - 1) / kSweepThreads);
  for (int it = 0; it < chunk; ++it) {
    sweep1_kernel<<<d.nblk1, kSweepThreads, sh1, stream>>>(p, st, sc, d);
    solve_kernel<<<1, kSolveThreads, sh2, stream>>>(p, st, sc, d);
    sweep2_kernel<<<nblk3, kSweepThreads, sh3, stream>>>(p, st, sc, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Launch-shape facts the Python wrapper needs before calling: the widest n
// the launch shapes take (sweep1 gives each of a block's threads one
// column), and the samples per sweep1 block, which size the partials
// scratch ((M / samples per block, rounded up) * (n + 1) floats).
int saa_admm_max_n() { return kSweepThreads; }
int saa_admm_samples_per_block() { return kSamplesPerBlock; }

}  // extern "C"
