// Fused scaled OSQP-ADMM iterations of the structured SAA QP in the lane-flat
// ("F") layout, for Hopper (kernel B2).
//
// Replaces riskaversetrajopt_tpu/ops/pallas/experimental/saa_admm_f.py:
// admm_chunk_pallas_f (saa_admm_f.py:227, the pallas_call at :425). The plain
// PyTorch version is riskaversetrajopt_torch/ops/cuda/saa_admm_f.py:
// one_iter_ref_f, in the same layout: every sample-row array is flat, F = K*M,
// f = k*M + i; the scaled Jacobian stack is resident twice, as G2 (F, n) and
// G2T (n, F); per-sample vectors are (M,); small rows are [final (n_fc) |
// cvar | slack | control (n)]. The iteration is kernel B1's (saa_admm.cu);
// the one-block KKT solve is shared with it through saa_admm_common.cuh.
//
// What bounds it on an H100: each iteration reads G twice, once as G2 (sweep
// 1, A^T w) and once as G2T (sweep 2, G u): 2 x 14.4 MB at M=1000, K=n=60,
// both resident in the 50 MB L2 after the first iteration. The operations
// are 2 x 2*F*n = 14.4 MFLOP per iteration in float32 at "highest" (three
// times the products at "high"), 0.2 us at the 67 TFLOP/s of the CUDA
// cores, below the bytes. Between the sweeps sits the grid-wide dependency
// of the KKT solve, so each iteration is three launches, and the one-block
// solve (B1's) is the largest item.
//
// The design: one C call per chunk loops `chunk` times over three launches
// on the caller's stream:
//   1. sweep1: the grid has two kinds of blocks. The first kind walks 256
//      rows of G2: thread (r, j) sums w_f * G2[f, j] over rows r, r + n_r,
//      ... (neighbouring threads on neighbouring addresses) and the block
//      writes one partial row of u_part. The second kind takes 32 samples
//      and 8 groups of k, and forms the per-sample rowsum_y = sum_k eGy w
//      (stride M, consecutive samples on consecutive addresses) and a
//      partial of sum eGt w. Every block writes a full (n+1) partial row (the
//      other kind's columns zero), and the shared solve reduces them in a
//      fixed order: no float atomics, so repeated runs agree bit for bit.
//   2. solve: saa_admm_common.cuh, as in B1.
//   3. sweep2: one thread per flat row f computes zt = G2T[:, f] . u_t -
//      eGy y_t[f mod M] - eGt t_t (each step of the loop over j reads 32
//      neighbouring floats per warp) and applies the relax/clip/dual update
//      to z_G, yd_G in place.
// sweep_precision is a kernel argument with the TPU meanings of the G
// products: 0 "highest" float32 FMA; 1 "high" bf16x3 (each operand split
// into a bf16 hi and a bf16 lo part, hi*hi + (hi*lo + lo*hi) in float32); 2
// "default" operands rounded to bf16 (__float2bfloat16_rn), float32
// accumulation. A bf16 x bf16 product is exact in float32, so the FMAs of
// "high" and "default" round only in the sums. Plain CUDA-core FMA;
// mma.sync / wgmma on bf16 tiles are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsaa_admm_f.so saa_admm_f.cu
// Binding: plain C entry point saa_admm_f_chunk (ctypes); it returns
// cudaGetLastError() and the caller raises if it is not 0.

#include <cuda_bf16.h>

#include "saa_admm_common.cuh"

namespace {

constexpr int kSweepThreads = 256;      // sweep1 / sweep2 block size
constexpr int kRowsPerBlock = 256;      // sweep1: G2 rows per block
constexpr int kSamplesPerRowBlock = 32; // sweep1: samples per rowsum block
constexpr int kKGroups = kSweepThreads / kSamplesPerRowBlock;

enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

// Problem data, in the order of ScaledSAAF's fields (ops/cuda/saa_admm_f.py).
struct ProbF {
  const float *G2, *G2T, *eGy, *eGt, *rv_G, *lb_G, *ub_G;
  const float *rv_y, *lb_y, *ub_y, *cy_hat, *yd_hat, *ys_hat, *Dinv, *wD;
  const float *rv_small, *lb_small, *ub_small;
  const float *Fs, *cu, *q_hat_u, *Sinv, *Cbar;
  const float *ct_hat, *cs_hat, *ss_hat, *q_hat_s, *sm_beta, *sm_denom,
      *sigma, *alpha_relax;
};
constexpr int kProbPtrs = 31;
static_assert(sizeof(ProbF) == kProbPtrs * sizeof(float*), "ProbF is a pointer list");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An operand as the precision splits it: hi (x itself at "highest"), and lo
// at "high".
struct Split {
  float hi, lo;
};

template <int P>
__device__ __forceinline__ Split split(float x) {
  if (P == kHighest) return {x, 0.0f};
  const float hi = bf16_round(x);
  if (P == kDefault) return {hi, 0.0f};
  return {hi, bf16_round(x - hi)};
}

// acc += a * b at precision P; "high" sums its two cross products apart in
// `cross`, as its plain version sums the three products' matrices apart.
template <int P>
__device__ __forceinline__ void mac(float& acc, float& cross, Split a, Split b) {
  acc = fmaf(a.hi, b.hi, acc);
  if (P == kHigh) {
    cross = fmaf(a.hi, b.lo, cross);
    cross = fmaf(a.lo, b.hi, cross);
  }
}

// w = rv z - yd of one sample row, rounded as the plain version's two tensor
// ops round it (no FMA contraction): from one state, "high" and "default"
// then split the same float32 w into bf16 parts.
__device__ __forceinline__ float row_w(float rv, float z, float yd) {
  return __fsub_rn(__fmul_rn(rv, z), yd);
}

// ---- sweep 1: A^T w over G2 rows + per-sample sums over k ----
template <int P>
__global__ void __launch_bounds__(kSweepThreads)
sweep1_f_kernel(ProbF p, State st, Scratch sc, Dims d, int nblk_g) {
  extern __shared__ float sh[];
  const int n = d.n, tid = threadIdx.x;
  const int F = d.M * d.K;
  float* part = sc.partials + (size_t)blockIdx.x * (n + 1);
  if (blockIdx.x < nblk_g) {
    float* w_hi = sh;                    // kRowsPerBlock
    float* w_lo = w_hi + kRowsPerBlock;  // kRowsPerBlock
    float* red = w_lo + kRowsPerBlock;   // kSweepThreads
    const int f0 = blockIdx.x * kRowsPerBlock;
    const int rows = min(kRowsPerBlock, F - f0);
    for (int e = tid; e < rows; e += blockDim.x) {
      const int f = f0 + e;
      const Split w = split<P>(row_w(p.rv_G[f], st.z_G[f], st.yd_G[f]));
      w_hi[e] = w.hi;
      w_lo[e] = w.lo;
    }
    __syncthreads();
    const int nr = blockDim.x / n;
    const int r = tid / n, j = tid - (tid / n) * n;
    if (r < nr) {
      const float* G = p.G2 + (size_t)f0 * n + j;
      float acc = 0.0f, cross = 0.0f;
      for (int row = r; row < rows; row += nr)
        mac<P>(acc, cross, Split{w_hi[row], w_lo[row]},
               split<P>(G[(size_t)row * n]));
      red[tid] = acc + cross;
    }
    __syncthreads();
    if (tid < n) {
      float s = 0.0f;
      for (int rr = 0; rr < nr; ++rr) s += red[rr * n + tid];
      part[tid] = s;
    }
    if (tid == 0) part[n] = 0.0f;
  } else {
    float* ra = sh;                  // kSweepThreads: eGy w partials
    float* rb = ra + kSweepThreads;  // kSweepThreads: eGt w partials
    const int lane = tid % kSamplesPerRowBlock, kg = tid / kSamplesPerRowBlock;
    const int i = (blockIdx.x - nblk_g) * kSamplesPerRowBlock + lane;
    float a = 0.0f, b = 0.0f;
    if (i < d.M) {
      for (int k = kg; k < d.K; k += kKGroups) {
        const size_t f = (size_t)k * d.M + i;
        const float w = row_w(p.rv_G[f], st.z_G[f], st.yd_G[f]);
        a += p.eGy[f] * w;
        b += p.eGt[f] * w;
      }
    }
    ra[tid] = a;
    rb[tid] = b;
    __syncthreads();
    if (tid < kSamplesPerRowBlock) {  // lane == tid, kg == 0
      float s = 0.0f, t = 0.0f;
      for (int g = 0; g < kKGroups; ++g) {
        s += ra[g * kSamplesPerRowBlock + tid];
        t += rb[g * kSamplesPerRowBlock + tid];
      }
      if (i < d.M) sc.rowsum_y[i] = s;
      ra[tid] = t;  // only this thread reads or writes slot tid of ra here
    }
    __syncthreads();
    for (int j = tid; j < n; j += blockDim.x) part[j] = 0.0f;
    if (tid == 0) {
      float t = 0.0f;
      for (int l = 0; l < kSamplesPerRowBlock; ++l) t += ra[l];
      part[n] = t;
    }
  }
}

// ---- sweep 2: zt = G2T^T u_t - eGy y_t - eGt t_t + in-place row update ----
template <int P>
__global__ void __launch_bounds__(kSweepThreads)
sweep2_f_kernel(ProbF p, State st, Scratch sc, Dims d) {
  extern __shared__ float u_sh[];  // 2n: u_t hi | lo
  const int n = d.n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const Split u = split<P>(sc.vt[j]);
    u_sh[j] = u.hi;
    u_sh[n + j] = u.lo;
  }
  __syncthreads();
  const size_t F = (size_t)d.M * d.K;
  const size_t f = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float* g = p.G2T + f;
  float acc = 0.0f, cross = 0.0f;
#pragma unroll 4
  for (int j = 0; j < n; ++j)
    mac<P>(acc, cross, Split{u_sh[j], u_sh[n + j]}, split<P>(g[(size_t)j * F]));
  const int i = (int)(f % (size_t)d.M);
  const float al = *p.alpha_relax, t_t = sc.vt[n + 1];
  const float zt = (acc + cross) - p.eGy[f] * sc.y_t[i] - p.eGt[f] * t_t;
  float z = st.z_G[f], yd = st.yd_G[f];
  row_update(al, z, yd, zt, p.rv_G[f], p.lb_G[f], p.ub_G[f]);
  st.z_G[f] = z;
  st.yd_G[f] = yd;
}

int sweep1_g_blocks(int M, int K) { return (M * K + kRowsPerBlock - 1) / kRowsPerBlock; }
int sweep1_r_blocks(int M) { return (M + kSamplesPerRowBlock - 1) / kSamplesPerRowBlock; }

template <int P>
int run_chunk(const ProbF& p, const State& st, const Scratch& sc, int M, int K,
              int n, int n_fc, int chunk, cudaStream_t stream) {
  const int nblk_g = sweep1_g_blocks(M, K);
  const Dims d{M, K, n, n_fc, nblk_g + sweep1_r_blocks(M)};
  const size_t sh1 = (size_t)(2 * kRowsPerBlock + kSweepThreads) * sizeof(float);
  const size_t sh2 = solve_smem_bytes(n, n_fc);
  const size_t sh3 = (size_t)2 * n * sizeof(float);
  const unsigned nblk3 = (unsigned)(((size_t)M * K + kSweepThreads - 1) / kSweepThreads);
  for (int it = 0; it < chunk; ++it) {
    sweep1_f_kernel<P><<<d.nblk1, kSweepThreads, sh1, stream>>>(p, st, sc, d, nblk_g);
    solve_kernel<<<1, kSolveThreads, sh2, stream>>>(p, st, sc, d);
    sweep2_f_kernel<P><<<nblk3, kSweepThreads, sh3, stream>>>(p, st, sc, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs `chunk` iterations at `precision` (0 highest, 1 high, 2 default).
// ptrs holds, in order: the 31 problem arrays (ProbF), the 10 input state
// arrays, the 10 output state arrays (State) and the 6 scratch arrays
// (Scratch), all float32 device pointers; the partials scratch holds
// saa_admm_f_partials(M, K) * (n + 1) floats. The input state is copied
// to the output first; the iterations then update the output in place.
// Returns cudaGetLastError() of the first failing step.
int saa_admm_f_chunk(const void* const* ptrs, int n_ptrs, int M, int K, int n,
                     int n_fc, int chunk, int precision, void* stream_ptr) {
  if (precision < kHighest || precision > kDefault) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  ProbF p;
  State st;
  Scratch sc;
  cudaError_t e0 = begin_chunk(ptrs, n_ptrs, M, K, n, n_fc, stream, p, st, sc);
  if (e0 != cudaSuccess) return (int)e0;
  switch (precision) {
    case kHighest:
      return run_chunk<kHighest>(p, st, sc, M, K, n, n_fc, chunk, stream);
    case kHigh:
      return run_chunk<kHigh>(p, st, sc, M, K, n, n_fc, chunk, stream);
    default:
      return run_chunk<kDefault>(p, st, sc, M, K, n, n_fc, chunk, stream);
  }
}

// Launch-shape facts the Python wrapper needs before calling: the widest n
// the launch shapes take (sweep1 gives each of a block's threads one
// column), and the rows of sweep1's partials scratch.
int saa_admm_f_max_n() { return kSweepThreads; }
int saa_admm_f_partials(int M, int K) {
  return sweep1_g_blocks(M, K) + sweep1_r_blocks(M);
}

}  // extern "C"
