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
//      It lives in saa_admm_common.cuh, shared with kernel B2.
//   3. sweep2: half a warp per sample row computes zt = Gs u_t - eGy y_t -
//      eGt t_t and applies the relax/clip/dual update to z_G, yd_G in place.
// A cooperative persistent kernel, clusters, wgmma or TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsaa_admm.so saa_admm.cu
// Binding: plain C entry point saa_admm_chunk (ctypes); it returns
// cudaGetLastError() and the caller raises if it is not 0.

#include "saa_admm_common.cuh"

namespace {

constexpr int kSweepThreads = 256;   // sweep1 / sweep2 block size
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
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Prob p;
  State st;
  Scratch sc;
  cudaError_t e0 = begin_chunk(ptrs, n_ptrs, M, K, n, n_fc, stream, p, st, sc);
  if (e0 != cudaSuccess) return (int)e0;

  Dims d{M, K, n, n_fc, (M + kSamplesPerBlock - 1) / kSamplesPerBlock};
  const size_t sh1 = (size_t)(kSamplesPerBlock * K + kSamplesPerBlock + kSweepThreads) * sizeof(float);
  const size_t sh2 = solve_smem_bytes(n, n_fc);
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
