// Fused scaled OSQP-ADMM iterations of the structured SAA QP in the lane-flat
// ("F") layout, for Hopper (kernel B2).
//
// Replaces riskaversetrajopt_tpu/ops/pallas/experimental/saa_admm_f.py:
// admm_chunk_pallas_f (saa_admm_f.py:227, the pallas_call at :425). The plain
// PyTorch version is riskaversetrajopt_torch/ops/cuda/saa_admm_f.py:
// one_iter_ref_f, in the same layout: every sample-row array is flat, F = K*M,
// f = k*M + i; G is G2 (F, n) (ScaledSAAF also carries G2T, which the plain
// version and the interop use and this kernel does not read); per-sample
// vectors are (M,); small rows are [final (n_fc) | cvar | slack | control
// (n)]. The iteration is kernel B1's (saa_admm.cu).
//
// The design is saa_admm_common.cuh's, shared with B1: one persistent
// cooperative launch per chunk call. A block owns the samples [m0, m0 + S)
// with all their K rows, which in this layout are K strided segments
// (f = k M + i, i in its range); it loads them, and its slab of G2, into
// shared memory once per chunk and stores its rows back once. One resident
// copy of G serves both sweeps.
//
// sweep_precision is a template argument with the TPU meanings of the G
// products (saa_admm_common.cuh: "highest" float32 FMA, "high" bf16x3,
// "default" bf16 operands with float32 accumulation). At "high" and
// "default" the resident slab is split into bf16 parts once, at load
// ("default" stores the bf16 hi only, half the bytes), so the bf16
// rounding of G leaves the iteration.
//
// What bounds it on an H100: as B1's (saa_admm.cu): 0.20-0.24 us of
// operations per iteration at M=1000, K=n=60, against a dependency chain
// of three grid barriers and the Phase-2 reduction per iteration, a
// latency floor of a few us. Tensor cores are not used: both sweeps are
// matrix-vector products with one right-hand side per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsaa_admm_f.so saa_admm_f.cu
// Binding: plain C entry points (ctypes); each returns a cudaError_t and
// the caller raises if it is not 0.

#include "saa_admm_common.cuh"

namespace {

// Problem data, in the order of ScaledSAAF's fields (ops/cuda/saa_admm_f.py)
// but sm_free, which picks the kernel (the `free_y` argument).
struct ProbF {
  static constexpr int kLayout = kFlat;
  const float *G2, *G2T, *eGy, *eGt, *rv_G, *lb_G, *ub_G;
  const float *rv_y, *lb_y, *ub_y, *cy_hat, *yd_hat, *ys_hat, *Dinv, *wD;
  const float *rv_small, *lb_small, *ub_small;
  const float *Fs, *cu, *q_hat_u, *Sinv, *Cbar;
  const float *ct_hat, *cs_hat, *ss_hat, *q_hat_s, *sm_beta, *sm_denom,
      *sigma, *alpha_relax;
  __device__ const float* g() const { return G2; }
};
constexpr int kProbPtrs = 31;
static_assert(sizeof(ProbF) == kProbPtrs * sizeof(float*), "ProbF is a pointer list");

}  // namespace

extern "C" {

// Runs `chunk` iterations at `precision` (0 highest, 1 high, 2 default) in
// one cooperative launch on `stream`. ptrs holds, in order: the 31 problem
// arrays (ProbF), the 10 input state arrays, the 10 output state arrays
// (State) and the 5 scratch arrays (Scratch), all float32 device pointers,
// sized as saa_admm_f_shape says. `free_y` != 0: the structure's sm_free is
// set (the cancellation-free KKT form).
int saa_admm_f_chunk(const void* const* ptrs, int n_ptrs, int M, int K, int n,
                     int n_fc, int chunk, int precision, int free_y, void* stream_ptr) {
  if (precision < kHighest || precision > kDefault) return (int)cudaErrorInvalidValue;
  ProbF p;
  State in, out;
  Scratch sc;
  cudaError_t e = unpack(ptrs, n_ptrs, p, in, out, sc);
  if (e != cudaSuccess) return (int)e;
  const Dims d{M, K, n, n_fc};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool fr = free_y != 0;
  switch (precision) {
    case kHighest:
      return (int)launch_chunk<ProbF, kHighest>(p, in, out, sc, d, chunk, fr, stream);
    case kHigh:
      return (int)launch_chunk<ProbF, kHigh>(p, in, out, sc, d, chunk, fr, stream);
    default:
      return (int)launch_chunk<ProbF, kDefault>(p, in, out, sc, d, chunk, fr, stream);
  }
}

// The launch shape of a chunk call at `precision` on the current device,
// into out[7], as saa_admm_shape (saa_admm.cu).
int saa_admm_f_shape(int M, int K, int n, int n_fc, int precision, int* out) {
  if (precision < kHighest || precision > kDefault) return (int)cudaErrorInvalidValue;
  return plan_to(Dims{M, K, n, n_fc}, precision, out);
}

int saa_admm_f_max_n() { return kMaxN; }

const char* saa_admm_f_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
