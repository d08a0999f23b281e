// Device code shared by the fused ADMM-chunk kernels B1 (saa_admm.cu, the
// natural (M, K, n) layout) and B2 (saa_admm_f.cu, the lane-flat layout).
//
// Both run the same scaled OSQP-ADMM iteration of the structured SAA QP as
// three launches on the caller's stream (sweep 1, a one-block solve, sweep
// 2); they differ only in how the sample rows are laid out and swept. What
// they share lives here: the iterate and scratch pointer lists, the
// deterministic block reductions, the relax/clip/dual row update, the
// one-block KKT solve (templated on the kernel's problem struct, whose
// non-G fields carry the same names in both) and the unpacking of a chunk
// call's pointer list.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSolveThreads = 1024;  // the one-block solve

// Iterate, in the order of ScaledState's (and ScaledStateF's) fields. In B2
// z_G and yd_G are the flat (F,) rows.
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
  int M, K, n, n_fc, nblk1;  // nblk1: rows of sweep 1's partials
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

// ---- solve: KKT solve + every update except the sample rows ----
// Reduces sweep 1's partials in a fixed order, forms the rhs, eliminates
// the y block by Sherman-Morrison, applies the explicit Schur inverse, and
// updates the small rows, the y rows, u, s and t; writes u_t | s_t | t_t
// and y_t to scratch for sweep 2.
template <class P>
__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(P p, State st, Scratch sc, Dims d) {
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

// Dynamic shared memory of solve_kernel, in bytes.
inline size_t solve_smem_bytes(int n, int n_fc) {
  const int ns = n_fc + 2 + n;
  return (size_t)(kSolveThreads + 33 + (n + 1) + ns + 2 * (n + 2)) * sizeof(float);
}

// Unpacks the pointer list of a chunk call: the problem arrays (into `p`, a
// struct of float pointers), the input state, the output state (`st`) and
// the scratch arrays (`sc`), all float32 device pointers; then copies the
// input state into the output state on `stream`, so that the iterations
// update the output in place. Returns a cudaError_t.
template <class P>
cudaError_t begin_chunk(const void* const* ptrs, int n_ptrs, int M, int K,
                        int n, int n_fc, cudaStream_t stream, P& p,
                        State& st, Scratch& sc) {
  constexpr int kProbPtrs = (int)(sizeof(P) / sizeof(float*));
  if (n_ptrs != kProbPtrs + 2 * kStatePtrs + kScratchPtrs) return cudaErrorInvalidValue;
  const float** pp = reinterpret_cast<const float**>(&p);
  for (int i = 0; i < kProbPtrs; ++i) pp[i] = static_cast<const float*>(ptrs[i]);
  const void* const* in = ptrs + kProbPtrs;
  float** sp = reinterpret_cast<float**>(&st);
  for (int i = 0; i < kStatePtrs; ++i)
    sp[i] = const_cast<float*>(static_cast<const float*>(ptrs[kProbPtrs + kStatePtrs + i]));
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
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
