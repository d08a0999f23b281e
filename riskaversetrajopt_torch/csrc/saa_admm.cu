// Fused scaled OSQP-ADMM iterations of the structured SAA QP, for Hopper
// (kernel B1, the natural layout).
//
// Replaces riskaversetrajopt_tpu/ops/pallas/experimental/saa_admm.py:
// admm_chunk_pallas (the pallas_call at saa_admm.py:793). The math is that
// file's _iter_body / _solve_kkt / _small_updates; the plain PyTorch version
// is riskaversetrajopt_torch/ops/cuda/saa_admm.py:one_iter_ref, in the same
// natural layout: Gs (M, K, n), sample-row state (M, K), per-sample vectors
// (M,), small rows [final (n_fc) | cvar | slack | control (n)].
//
// The design is saa_admm_common.cuh's: one persistent cooperative launch
// per chunk call, each block owning a contiguous range of samples and
// keeping its slab of Gs (and its rows, and Sinv) in shared memory for the
// whole chunk, as the TPU kernel's resident mode keeps Gs in VMEM.
//
// What bounds it on an H100: the work of an iteration (2 x 2 M K n flops in
// the sweeps, 14.4 MFLOP at M=1000, K=n=60) is 0.24 us at the 67 TFLOP/s
// of the CUDA cores, and with Gs resident no byte of it comes from L2 or
// HBM. What remains is the dependency chain: three grid barriers per
// iteration and the Phase-2 reduction of one partial row per block, read
// from L2 by every block, between them; a latency floor of a few us, far
// above the 0.24 us throughput bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsaa_admm.so saa_admm.cu
// Binding: plain C entry points (ctypes); each returns a cudaError_t and
// the caller raises if it is not 0.

#include "saa_admm_common.cuh"

namespace {

// Problem data, in the order of ScaledSAA's fields (ops/cuda/saa_admm.py)
// but sm_free, which picks the kernel (the `free_y` argument).
struct Prob {
  static constexpr int kLayout = kNatural;
  const float *Gs, *eGy, *eGt, *rv_G, *lb_G, *ub_G;
  const float *rv_y, *lb_y, *ub_y, *cy_hat, *yd_hat, *ys_hat, *Dinv, *wD;
  const float *rv_small, *lb_small, *ub_small;
  const float *Fs, *cu, *q_hat_u, *Sinv, *Cbar;
  const float *ct_hat, *cs_hat, *ss_hat, *q_hat_s, *sm_beta, *sm_denom,
      *sigma, *alpha_relax;
  __device__ const float* g() const { return Gs; }
};
constexpr int kProbPtrs = 30;
static_assert(sizeof(Prob) == kProbPtrs * sizeof(float*), "Prob is a pointer list");

// Three grid barriers per iteration and nothing else: the dependency-chain
// floor of the chunk kernel, measured by chip_smoke.py.
__global__ void __launch_bounds__(kThreads, 1) sync_floor_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < iters; ++it) {
    grid.sync();
    grid.sync();
    grid.sync();
  }
}

}  // namespace

extern "C" {

// Runs `chunk` iterations in one cooperative launch on `stream`. ptrs holds,
// in order: the 30 problem arrays (Prob), the 10 input state arrays, the 10
// output state arrays (State) and the 5 scratch arrays (Scratch), all
// float32 device pointers, sized as saa_admm_shape says. `free_y` != 0: the
// structure's sm_free is set (the cancellation-free KKT form).
int saa_admm_chunk(const void* const* ptrs, int n_ptrs, int M, int K, int n,
                   int n_fc, int chunk, int free_y, void* stream_ptr) {
  Prob p;
  State in, out;
  Scratch sc;
  cudaError_t e = unpack(ptrs, n_ptrs, p, in, out, sc);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_chunk<Prob, kHighest>(p, in, out, sc, Dims{M, K, n, n_fc},
                                           chunk, free_y != 0, (cudaStream_t)stream_ptr);
}

// The launch shape of a chunk call on the current device, into
// out[7] = {grid, samples per block, shared-memory bytes per block, G slab
// resident, rows resident, partial row width, G row stride}.
int saa_admm_shape(int M, int K, int n, int n_fc, int* out) {
  return plan_to(Dims{M, K, n, n_fc}, kHighest, out);
}

int saa_admm_max_n() { return kMaxN; }

const char* saa_admm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `iters` triples of grid barriers over `blocks` blocks of the chunk
// kernel's size, one cooperative launch on `stream`.
int saa_admm_sync_floor(int blocks, int iters, void* stream_ptr) {
  void* args[] = {&iters};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)sync_floor_kernel, dim3(blocks),
                                              dim3(kThreads), args, 0,
                                              (cudaStream_t)stream_ptr);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // extern "C"
