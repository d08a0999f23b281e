// The fused ADMM-chunk kernel shared by B1 (saa_admm.cu, the natural
// (M, K, n) layout) and B2 (saa_admm_f.cu, the lane-flat layout), and the
// host code that plans and launches it.
//
// Both run the same scaled OSQP-ADMM iteration of the structured SAA QP
// (the plain versions are ops/cuda/saa_admm.py:one_iter_ref and
// ops/cuda/saa_admm_f.py:one_iter_ref_f), all in float32. A chunk call is
// ONE persistent cooperative launch (cudaLaunchCooperativeKernel) that runs
// every iteration of the chunk. The grid is as many blocks as are
// co-resident (one per SM at these shared-memory sizes); block b owns the
// contiguous samples [b S, b S + S), S = ceil(M / SMs), with all K rows of
// each, so every per-sample quantity (sum_k eGy w, r_y, y_t, the y-row
// updates) is local to one block in both layouts.
//
// Residency. At chunk start a block copies what it owns into shared memory
// once: its slab of G (split into bf16 parts at load for "high" and
// "default", so that rounding leaves the iteration), its sample-row and
// per-sample arrays, its rows of Cbar, and Sinv. Where the slab does not fit
// (M above ~1450 at K = n = 60 for "highest") it stays in global memory and
// each sweep reads it from there (the template flag GRES); where the rows do
// not fit either (M above ~11600) they are used in place in global memory
// (RRES). Nothing caps M.
//
// One iteration, three phases, three grid barriers:
//   1. per block: the previous iteration's CVaR row (it needs sum cy_hat y_t
//      over all samples, reduced from the partial rows by every block), w of
//      the small rows and of its sample rows, sweep 1 (A^T w) over its slab,
//      the per-sample sums over k, r_y; it writes its partial row.
//                                                       -- grid barrier --
//   2. every block, redundantly and identically: reduces the partial rows in
//      one fixed order and forms r_v, taking Cbar^T g_y through
//      Cbar^T g_y = Cbar^T (Dinv r_y) - coef CtwD, where CtwD = Cbar^T wD is
//      reduced once per chunk from parts each block writes in its prologue;
//      v = r_v Sinv; the small rows but the CVaR row, and u, s, t. Per
//      block: q = r_y - Cbar v of its samples and its sum of wD q.
//                                                       -- grid barrier --
//   3. per block: coef2 = beta sum wD q / denom (reduced by every warp), y_t,
//      the y rows, sweep 2 (G u_t) fused with the relax/clip/dual update of
//      its rows, its sum of cy_hat y_t.                 -- grid barrier --
//   The last iteration's CVaR row is completed at chunk end.
// coef2 is summed per sample, as the plain version sums it: its identity
// form beta (sum wD r_y - CtwD . v) / denom would save the middle barrier,
// but takes the difference of two chunk-wide sums in float32.
// Where some y meets the CVaR row alone (the structure's sm_free, the car's
// gated iteration: Dinv = 1/sigma = 1e6 there), Dinv r_y - coef wD cancels
// terms 1e6 times its result and float32 diverges; then (the template flag
// FREE, chosen by the caller, so that a structure without such y runs a
// kernel compiled without the branch) the same columns carry
// the cancellation-free form of ops/cuda/saa_admm.py:kkt_solve: phase 1
// keeps B1 = yd_hat w_y + sum_k eGy w per sample and writes
// X1 = sum (cy_hat a y - wD B1) and Cbar^T (a y - Dinv B1), a = Dinv
// sigma; phase 2 takes Cbar^T g_y = Cbar^T (a y - Dinv B1) + kappa1 CtwD,
// kappa1 = (w_c - beta X1) / denom, and per sample cv = Cbar v - beta
// cy_hat (cs_hat s_t + ct_hat t_t) and its sum of wD cv; phase 3 forms
// y_t = a y - Dinv (B1 + cv) + wD kappa2 with kappa2 = (w_c - beta (cs_hat
// s_t + ct_hat t_t) - beta (X1 - sum wD cv)) / denom.
// No float atomics: every sum runs in a fixed order, so every block reduces
// to the same bits and two runs from one state agree bit for bit.
//
// Rules for anyone editing this kernel:
// - L1 is not coherent across SMs. Values that OTHER blocks wrote (the
//   partial rows) are stored with __stcg and read with __ldcg (L2) after a
//   grid barrier, never through L1: a stale L1 line gives wrong answers only
//   sometimes.
// - A column of the partial rows may be rewritten only after a grid barrier
//   that follows every block's last read of it. Each column is written in
//   one phase and read in the next (the CVaR column also at chunk end), so
//   the phase that writes it next is always two barriers later.
//
// Tensor cores are not used: both sweeps are matrix-vector products with
// one right-hand side per block, so wgmma / mma.sync would have no second
// dimension to fill.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = kThreads;  // sweep 1 gives each of nr * n threads one column

enum Layout { kNatural = 0, kFlat = 1 };
enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

// Iterate, in the order of ScaledState's (and ScaledStateF's) fields. In B2
// z_G and yd_G are the flat (F,) rows.
struct State {
  float *u, *s, *t, *y, *z_y, *yd_y, *z_G, *yd_G, *z_small, *yd_small;
};
constexpr int kStatePtrs = 10;
static_assert(sizeof(State) == kStatePtrs * sizeof(float*), "State is a pointer list");

struct Scratch {
  float* partials;  // (grid, pw): each block's partial row (after a call: the last iteration's)
  float* rhs_y;     // (M,): r_y, then q, used where the rows are not resident
  float* w;         // (2 M K,): w hi | w lo of the sample rows, likewise
  float* y_t;       // (M,): the last iteration's y_t
  float* vt;        // (n+2,): the last iteration's u_t | s_t | t_t
};
constexpr int kScratchPtrs = 5;
static_assert(sizeof(Scratch) == kScratchPtrs * sizeof(float*), "Scratch is a pointer list");

struct Dims {
  int M, K, n, n_fc;
};

// The launch shape of one chunk call, fixed on the host by plan().
struct Shape {
  int grid;      // blocks, all co-resident
  int S;         // samples per block (the last block may own fewer)
  int smem;      // dynamic shared memory per block, bytes
  int g_res;     // the block's G slab is in shared memory
  int rows_res;  // its sample-row and per-sample arrays and Cbar rows are
  int pw;        // floats per partial row
  int gs;        // row stride of the resident G slab, in elements
};
constexpr int kShapeInts = 7;
static_assert(sizeof(Shape) == kShapeInts * sizeof(int), "Shape is an int list");

// A block's partial row, pw = 3n + 9 floats (nv = n + 2), by the phase that
// writes it:
//   [0, n)            1  u_part, its sweep-1 sum (kept for the sweep checks)
//   n                 1  sum ys_hat w_y
//   n + 1             1  sum eGt w
//   n + 2             1  sum wD r_y
//   [n + 3, n+3+nv)   1  Cbar^T (Dinv r_y)
//   n + 3 + nv        2  sum wD q, q = r_y - Cbar v
//   n + 4 + nv        3  sum cy_hat y_t
//   [n + 5 + nv, pw)     Cbar^T wD, once, in the prologue
struct Cols {
  int p1, wq, cy, ctwd;  // phase 1's are [0, p1)
  __host__ __device__ explicit Cols(int n)
      : p1(2 * n + 5), wq(2 * n + 5), cy(2 * n + 6), ctwd(2 * n + 7) {}
};
__host__ __device__ inline int partial_width(int n) { return 3 * n + 9; }

// Per-sample arrays (S floats each) and sample-row arrays (S K each) of a
// block; where resident, row (s, k) sits at s K + k. kRy holds r_y in
// phases 1 and 2, then q.
enum SampleArr { kY, kZy, kYdy, kRvy, kLby, kUby, kCy, kYdh, kYsh, kDinv, kWd,
                 kRy, kYt, kNSample };
enum RowArr { kZG, kYdG, kRvG, kLbG, kUbG, kEGy, kEGt, kWh, kWl, kNRow };

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Bump {
  int o = 0;
  __host__ __device__ int take(int nf) {
    const int at = o;
    o += (nf + 3) & ~3;  // 16-byte aligned regions
    return at;
  }
};

// Float offsets of a block's shared-memory regions; the G slab follows at
// byte 4 * floats. Host (sizing) and device (carving) call the same code.
struct Carve {
  int red, redd, wsum, pr, rv, v, sinv;  // reductions and the KKT solve
  int wsm, uh, ul, u, zs, yds, st;       // small state and vectors
  int fs, cu, qu, rvs, lbs, ubs;         // small problem arrays
  int sample, row, cbar;                 // the block's data, where resident
  int floats;
};

__host__ __device__ inline Carve carve(const Dims& d, int S, int pw, int rows_res) {
  const int n = d.n, nv = n + 2, ns = d.n_fc + 2 + n;
  Carve c;
  Bump b;
  c.red = b.take(kThreads);
  c.redd = b.take(imax(kThreads, pw));
  c.wsum = b.take(3 * kWarps);
  c.pr = b.take(pw);
  c.rv = b.take(nv);
  c.v = b.take(nv);
  c.sinv = b.take(nv * nv);
  c.wsm = b.take(ns);
  c.uh = b.take(n);
  c.ul = b.take(n);
  c.u = b.take(n);
  c.zs = b.take(ns);
  c.yds = b.take(ns);
  c.st = b.take(2);
  c.fs = b.take(d.n_fc * n);
  c.cu = b.take(n);
  c.qu = b.take(n);
  c.rvs = b.take(ns);
  c.lbs = b.take(ns);
  c.ubs = b.take(ns);
  c.sample = rows_res ? b.take(kNSample * S) : -1;
  c.row = rows_res ? b.take(kNRow * S * d.K) : -1;
  c.cbar = rows_res ? b.take(S * nv) : -1;
  c.floats = b.o;
  return c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void row_update(float al, float& z, float& yd, float zt,
                                           float rv, float lb, float ub) {
  const float z_relax = al * zt + (1.0f - al) * z;
  const float z_next = fminf(fmaxf(z_relax + yd / rv, lb), ub);
  yd = yd + rv * (z_relax - z_next);
  z = z_next;
}

// w = rv z - yd of one row, rounded as the plain version's two tensor ops
// round it (no FMA contraction): from one state, "high" and "default" then
// split the same float32 w into bf16 parts.
__device__ __forceinline__ float row_w(float rv, float z, float yd) {
  return __fsub_rn(__fmul_rn(rv, z), yd);
}

// ---- the sweep precisions (the TPU meanings, ops/saa_qp.py:sweep_matmul) --
// 0 "highest": float32 FMA. 1 "high": bf16x3, each operand split into a bf16
// hi and a bf16 lo part, hi*hi + (hi*lo + lo*hi) in float32. 2 "default":
// operands rounded to bf16, float32 accumulation. A bf16 x bf16 product is
// exact in float32, so the FMAs of "high" and "default" round only in the
// sums.

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// A resident G element as stored: float at "highest", the bf16 (hi, lo)
// pair at "high", the bf16 hi at "default" (half the bytes).
template <int P> struct Slab;
template <> struct Slab<kHighest> {
  using T = float;
  __device__ static T pack(float x) { return x; }
  __device__ static Split unpack(T v) { return {v, 0.0f}; }
};
template <> struct Slab<kHigh> {
  using T = __nv_bfloat162;
  __device__ static T pack(float x) {
    const Split s = split<kHigh>(x);
    return __halves2bfloat162(__float2bfloat16_rn(s.hi), __float2bfloat16_rn(s.lo));
  }
  __device__ static Split unpack(T v) { return {__low2float(v), __high2float(v)}; }
};
template <> struct Slab<kDefault> {
  using T = __nv_bfloat16;
  __device__ static T pack(float x) { return __float2bfloat16_rn(x); }
  __device__ static Split unpack(T v) { return {__bfloat162float(v), 0.0f}; }
};

// ---- the kernel --------------------------------------------------------

// P is the layout's problem struct (Prob or ProbF): the same field names
// but for G, read through p.g(), and P::kLayout. GRES: the G slab is in
// shared memory; RRES: the rows are (Shape's g_res and rows_res). FREE: the
// cancellation-free KKT form of a structure with sm_free set.
template <class P, int PREC, bool GRES, bool RRES, bool FREE>
__global__ void __launch_bounds__(kThreads, 1)
admm_chunk_kernel(P p, State in, State out, Scratch sc, Dims d, Shape sh, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* shf = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  constexpr bool kF = P::kLayout == kFlat;
  using T = typename Slab<PREC>::T;

  const int M = d.M, K = d.K, n = d.n, n_fc = d.n_fc;
  const int nv = n + 2, ns = n_fc + 2 + n, pw = sh.pw;
  const Cols col(n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = sh.S, SK = S * K;
  const int m0 = imin((int)blockIdx.x * S, M);
  const int Sb = imin(S, M - m0), R = Sb * K;  // samples and rows owned (may be 0)
  const Carve c = carve(d, S, pw, RRES);
  float* red = shf + c.red;
  float* redd = shf + c.redd;
  float* wsum = shf + c.wsum;  // per-warp sums, up to three kinds
  float* pr = shf + c.pr;      // the partial rows, reduced
  const float* ctwd = pr + col.ctwd;  // Cbar^T wD, reduced at iteration 0, then kept
  float* rv = shf + c.rv;
  float* v = shf + c.v;  // u_t | s_t | t_t
  const float* Sinv = shf + c.sinv;
  float* wsm = shf + c.wsm;  // w of the small rows
  float* uh = shf + c.uh;    // u_t split for sweep 2
  float* ul = shf + c.ul;
  float* u = shf + c.u;
  float* zs = shf + c.zs;
  float* yds = shf + c.yds;
  float* st = shf + c.st;  // s | t
  float* Fs = shf + c.fs;
  float* cu = shf + c.cu;
  float* qu = shf + c.qu;
  float* rvs = shf + c.rvs;
  float* lbs = shf + c.lbs;
  float* ubs = shf + c.ubs;
  T* slab = reinterpret_cast<T*>(smem + 4 * (size_t)c.floats);
  float* prow = sc.partials + (size_t)blockIdx.x * pw;
  const float* gglob = p.g();

  const float sig = *p.sigma, al = *p.alpha_relax;
  const float beta = *p.sm_beta, denom = *p.sm_denom;
  const float cs_hat = *p.cs_hat, ct_hat = *p.ct_hat, ss_hat = *p.ss_hat;
  const float q_hat_s = *p.q_hat_s;

  // index of row (s, k) of this block in the caller's layout
  auto cidx = [&](int s, int k) -> size_t {
    return kF ? (size_t)k * M + m0 + s : (size_t)(m0 + s) * K + k;
  };
  // where the rows live: resident at s K + k, else in place in the
  // caller's arrays; ridx(s, k) = roff + s rss + k rsk
  const int roff = RRES ? 0 : (kF ? m0 : m0 * K);
  const int rss = RRES || !kF ? K : 1;
  const int rsk = RRES || !kF ? 1 : M;
  auto RA = [&](int a) -> float* {
    if constexpr (RRES) return shf + c.row + a * SK;
    switch (a) {
      case kZG: return out.z_G;
      case kYdG: return out.yd_G;
      case kRvG: return const_cast<float*>(p.rv_G);
      case kLbG: return const_cast<float*>(p.lb_G);
      case kUbG: return const_cast<float*>(p.ub_G);
      case kEGy: return const_cast<float*>(p.eGy);
      case kEGt: return const_cast<float*>(p.eGt);
      case kWh: return sc.w;
      default: return sc.w + (size_t)M * K;
    }
  };
  auto SA = [&](int a) -> float* {
    if constexpr (RRES) return shf + c.sample + a * S;
    const float* g;
    switch (a) {
      case kY: g = out.y; break;
      case kZy: g = out.z_y; break;
      case kYdy: g = out.yd_y; break;
      case kRvy: g = p.rv_y; break;
      case kLby: g = p.lb_y; break;
      case kUby: g = p.ub_y; break;
      case kCy: g = p.cy_hat; break;
      case kYdh: g = p.yd_hat; break;
      case kYsh: g = p.ys_hat; break;
      case kDinv: g = p.Dinv; break;
      case kWd: g = p.wD; break;
      case kRy: g = sc.rhs_y; break;
      default: g = sc.y_t; break;
    }
    return const_cast<float*>(g) + m0;
  };
  const float* cbar = RRES ? shf + c.cbar : p.Cbar + (size_t)m0 * nv;
  // (s, k) of the q-th row a loop visits, in memory order
  auto row_of = [&](int q, int& s, int& k) {
    if (rsk == 1) {
      s = q / K;
      k = q - s * K;
    } else {
      k = q / Sb;
      s = q - k * Sb;
    }
  };
  // (s, k) of the q-th row in the caller's memory order
  auto caller_row = [&](int q, int& s, int& k) {
    if (kF) {
      k = q / Sb;
      s = q - k * Sb;
    } else {
      s = q / K;
      k = q - s * K;
    }
  };
  // element j of G row (s, k) = block row e = s K + k, split for PREC
  auto gload = [&](int s, int k, int e, int j) -> Split {
    if constexpr (GRES) {
      return Slab<PREC>::unpack(slab[(size_t)e * sh.gs + j]);
    } else {
      return split<PREC>(__ldg(gglob + cidx(s, k) * n + j));
    }
  };
  // the sum over the grid of column `at` of the partial rows, in one fixed
  // order: every lane of every warp that calls it gets the same bits
  auto grid_col_sum = [&](int at) -> float {
    float a = 0.0f;
    for (int bb = lane; bb < sh.grid; bb += 32) a += __ldcg(sc.partials + (size_t)bb * pw + at);
    return warp_sum(a);
  };
  // the CVaR row from zt_c = sum cy_hat y_t + cs_hat s_t + ct_hat t_t (one
  // thread)
  auto cvar_row = [&](float cyy) {
    const float zt_c = cyy + cs_hat * v[n] + ct_hat * v[n + 1];
    row_update(al, zs[n_fc], yds[n_fc], zt_c, rvs[n_fc], lbs[n_fc], ubs[n_fc]);
  };

  // ---- prologue: the block's data into shared memory, once per chunk ----
  for (int j = tid; j < n; j += kThreads) {
    u[j] = in.u[j];
    cu[j] = p.cu[j];
    qu[j] = p.q_hat_u[j];
  }
  for (int i = tid; i < ns; i += kThreads) {
    zs[i] = in.z_small[i];
    yds[i] = in.yd_small[i];
    rvs[i] = p.rv_small[i];
    lbs[i] = p.lb_small[i];
    ubs[i] = p.ub_small[i];
  }
  for (int e = tid; e < n_fc * n; e += kThreads) Fs[e] = p.Fs[e];
  for (int e = tid; e < nv * nv; e += kThreads) shf[c.sinv + e] = p.Sinv[e];
  if (tid == 0) {
    st[0] = *in.s;
    st[1] = *in.t;
  }
  for (int q = tid; q < R; q += kThreads) {
    int s, k;
    caller_row(q, s, k);
    const size_t ci = cidx(s, k);
    const int ri = roff + s * rss + k * rsk;
    RA(kZG)[ri] = in.z_G[ci];
    RA(kYdG)[ri] = in.yd_G[ci];
    if constexpr (RRES) {
      RA(kRvG)[ri] = p.rv_G[ci];
      RA(kLbG)[ri] = p.lb_G[ci];
      RA(kUbG)[ri] = p.ub_G[ci];
      RA(kEGy)[ri] = p.eGy[ci];
      RA(kEGt)[ri] = p.eGt[ci];
    }
  }
  for (int s = tid; s < Sb; s += kThreads) {
    SA(kY)[s] = in.y[m0 + s];
    SA(kZy)[s] = in.z_y[m0 + s];
    SA(kYdy)[s] = in.yd_y[m0 + s];
    if constexpr (RRES) {
      SA(kRvy)[s] = p.rv_y[m0 + s];
      SA(kLby)[s] = p.lb_y[m0 + s];
      SA(kUby)[s] = p.ub_y[m0 + s];
      SA(kCy)[s] = p.cy_hat[m0 + s];
      SA(kYdh)[s] = p.yd_hat[m0 + s];
      SA(kYsh)[s] = p.ys_hat[m0 + s];
      SA(kDinv)[s] = p.Dinv[m0 + s];
      SA(kWd)[s] = p.wD[m0 + s];
    }
  }
  if constexpr (RRES)
    for (int e = tid; e < Sb * nv; e += kThreads) shf[c.cbar + e] = p.Cbar[(size_t)m0 * nv + e];
  if constexpr (GRES) {
    // in the caller's memory order, so the reads coalesce; the split into
    // bf16 parts happens here, once
    for (int q = tid; q < R * n; q += kThreads) {
      const int t = q / n, j = q - t * n;
      int s, k;
      caller_row(t, s, k);
      slab[(size_t)(s * K + k) * sh.gs + j] =
          Slab<PREC>::pack(__ldg(gglob + cidx(s, k) * n + j));
    }
  }
  __syncthreads();
  // this block's part of the chunk constant CtwD = Cbar^T wD
  for (int j = tid; j < nv; j += kThreads) {
    float a = 0.0f;
    for (int s = 0; s < Sb; ++s) a += cbar[s * nv + j] * SA(kWd)[s];
    __stcg(prow + col.ctwd + j, a);
  }

  for (int it = 0; it < chunk; ++it) {
    // ======== phase 1 (per block) ========
    // the previous iteration's CVaR row, now that sum cy_hat y_t is known
    // (warp 0), and w of the small rows
    if (warp == 0) {
      const float cyy = it > 0 ? grid_col_sum(col.cy) : 0.0f;
      if (lane == 0) {
        if (it > 0) cvar_row(cyy);
        wsm[n_fc] = row_w(rvs[n_fc], zs[n_fc], yds[n_fc]);
      }
    }
    for (int i = tid; i < ns; i += kThreads)
      if (i != n_fc) wsm[i] = row_w(rvs[i], zs[i], yds[i]);
    __syncthreads();
    // w of the rows (split for sweep 1), the per-sample sums over k and
    // r_y: one warp per sample; lane 0 keeps the warp's running sums of
    // eGt w, ys_hat w_y and wD r_y
    {
      const float* rvG = RA(kRvG);
      const float* zG = RA(kZG);
      const float* ydG = RA(kYdG);
      const float* eGy = RA(kEGy);
      const float* eGt = RA(kEGt);
      float* wh = RA(kWh);
      float* wl = RA(kWl);
      const float wc = wsm[n_fc];
      float egt = 0.0f, ysw = 0.0f, wdr = 0.0f;
      for (int s = warp; s < Sb; s += kWarps) {
        float a = 0.0f, b = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const int ri = roff + s * rss + k * rsk;
          const float w = row_w(rvG[ri], zG[ri], ydG[ri]);
          const Split ws = split<PREC>(w);
          wh[ri] = ws.hi;
          if (PREC == kHigh) wl[ri] = ws.lo;
          a += eGy[ri] * w;
          b += eGt[ri] * w;
        }
        a = warp_sum(a);
        b = warp_sum(b);
        if (lane == 0) {
          const float w_y = row_w(SA(kRvy)[s], SA(kZy)[s], SA(kYdy)[s]);
          egt += b;
          ysw += SA(kYsh)[s] * w_y;
          if constexpr (FREE) {
            const float b1 = SA(kYdh)[s] * w_y + a;
            SA(kRy)[s] = b1;
            wdr += SA(kCy)[s] * (SA(kDinv)[s] * sig) * SA(kY)[s] - SA(kWd)[s] * b1;
          } else {
            const float r_y = sig * SA(kY)[s] + SA(kCy)[s] * wc - SA(kYdh)[s] * w_y - a;
            SA(kRy)[s] = r_y;
            wdr += SA(kWd)[s] * r_y;
          }
        }
      }
      if (lane == 0) {
        wsum[warp] = egt;
        wsum[kWarps + warp] = ysw;
        wsum[2 * kWarps + warp] = wdr;
      }
    }
    __syncthreads();
    // sweep 1: thread (r, j) sums w_e G[e, j] over rows e = r, r + nr, ...
    const int nr = kThreads / n;
    if (tid < nr * n) {
      const int r = tid / n, j = tid - r * n;
      const float* wh = RA(kWh);
      const float* wl = RA(kWl);
      float acc = 0.0f, cross = 0.0f;
      if (rsk == 1 && (GRES || !kF)) {
        // row e of the block at roff + e, its G row at e (resident) or at
        // m0 K + e (natural layout; unrolled deeper to keep more of the
        // loads from L2 in flight)
        if constexpr (GRES) {
#pragma unroll 4
          for (int e = r; e < R; e += nr) {
            const Split w{wh[roff + e], PREC == kHigh ? wl[roff + e] : 0.0f};
            mac<PREC>(acc, cross, w, Slab<PREC>::unpack(slab[(size_t)e * sh.gs + j]));
          }
        } else {
          const float* g = gglob + (size_t)m0 * K * n + j;
#pragma unroll 16
          for (int e = r; e < R; e += nr) {
            const Split w{wh[roff + e], PREC == kHigh ? wl[roff + e] : 0.0f};
            mac<PREC>(acc, cross, w, split<PREC>(__ldg(g + (size_t)e * n)));
          }
        }
      } else {
        int s = r / K, k = r - (r / K) * K;
        for (int e = r; e < R; e += nr) {
          const int ri = roff + s * rss + k * rsk;
          const Split w{wh[ri], PREC == kHigh ? wl[ri] : 0.0f};
          mac<PREC>(acc, cross, w, gload(s, k, e, j));
          k += nr;
          while (k >= K) {
            k -= K;
            ++s;
          }
        }
      }
      red[tid] = acc + cross;
    }
    __syncthreads();
    // the block's partial row: u_part, sum ys_hat w_y, sum eGt w, sum wD r_y
    // and Cbar^T (Dinv r_y) (with FREE: X1 and Cbar^T (a y - Dinv B1))
    for (int j = tid; j < nv; j += kThreads) {
      float x = 0.0f;
      if (j < n) {
        for (int r = 0; r < nr; ++r) x += red[r * n + j];
      } else {
        const float* ws = wsum + (j == n ? kWarps : 0);
        for (int w = 0; w < kWarps; ++w) x += ws[w];
      }
      __stcg(prow + j, x);
      float cd = 0.0f;
      if constexpr (FREE) {
        for (int s = 0; s < Sb; ++s)
          cd += cbar[s * nv + j] *
                ((SA(kDinv)[s] * sig) * SA(kY)[s] - SA(kDinv)[s] * SA(kRy)[s]);
      } else {
        for (int s = 0; s < Sb; ++s) cd += cbar[s * nv + j] * (SA(kDinv)[s] * SA(kRy)[s]);
      }
      __stcg(prow + n + 3 + j, cd);
    }
    if (tid == kThreads - 1) {
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) a += wsum[2 * kWarps + w];
      __stcg(prow + n + 2, a);
    }
    grid.sync();

    // ======== phase 2 (every block, identically) ========
    {
      // phase 1's columns (and CtwD at iteration 0), reduced in one fixed
      // order: thread (g, q) sums rows g, g + ng, ...; then the ng group
      // sums in order
      const int C = it == 0 ? col.p1 + nv : col.p1;
      auto at = [&](int q) { return q < col.p1 ? q : col.ctwd + q - col.p1; };
      const int ng = imax(1, kThreads / C);
      for (int e = tid; e < ng * C; e += kThreads) {
        const int g = e / C, q = e - g * C, cq = at(q);
        float a = 0.0f;
#pragma unroll 8
        for (int bb = g; bb < sh.grid; bb += ng) a += __ldcg(sc.partials + (size_t)bb * pw + cq);
        redd[e] = a;
      }
      __syncthreads();
      for (int q = tid; q < C; q += kThreads) {
        float a = 0.0f;
        for (int g = 0; g < ng; ++g) a += redd[g * C + q];
        pr[at(q)] = a;
      }
    }
    __syncthreads();
    // r_v = rhs - Cbar^T g_y, with Cbar^T g_y = Cbar^T (Dinv r_y) - coef CtwD
    // (FREE: Cbar^T (a y - Dinv B1) + kappa1 CtwD)
    {
      const float wc = wsm[n_fc], ws = wsm[n_fc + 1];
      const float coef = FREE ? -((wc - beta * pr[n + 2]) / denom) : beta * pr[n + 2] / denom;
      for (int j = tid; j < nv; j += kThreads) {
        float rhs;
        if (j < n) {
          float up = pr[j];
          for (int i = 0; i < n_fc; ++i) up += wsm[i] * Fs[i * n + j];
          up += cu[j] * wsm[n_fc + 2 + j];
          rhs = sig * u[j] - qu[j] + up;
        } else if (j == n) {
          rhs = sig * st[0] - q_hat_s + cs_hat * wc - pr[n] - ss_hat * ws;
        } else {
          rhs = sig * st[1] + ct_hat * wc - pr[n + 1];
        }
        rv[j] = rhs - (pr[n + 3 + j] - coef * ctwd[j]);
      }
    }
    __syncthreads();
    // v = r_v Sinv, one thread per column, summed over i in order. Sinv's
    // terms cancel, so v carries the rounding of this sum more than that
    // of r_v, and the rho of the equality rows carries it into yd_small:
    // any two float32 orders of it (the plain version's is cuBLAS's) leave
    // yd_small up to ~1e-2 apart after one iteration at M=50.
    for (int j = tid; j < nv; j += kThreads) {
      float a = 0.0f;
#pragma unroll 8
      for (int i = 0; i < nv; ++i) a = fmaf(rv[i], Sinv[i * nv + j], a);
      v[j] = a;
      if (j < n) {
        const Split us = split<PREC>(a);
        uh[j] = us.hi;
        ul[j] = us.lo;
      }
    }
    __syncthreads();
    const float s_t = v[n], t_t = v[n + 1];
    const float c2 = cs_hat * s_t + ct_hat * t_t;
    // q = r_y - Cbar v of the block's samples (one thread per sample, in
    // order over j) and the block's sum of wD q (FREE: cv = Cbar v - beta
    // cy_hat c2, B1 + cv and the sum of wD cv)
    {
      float wq = 0.0f;
      for (int s = tid; s < Sb; s += kThreads) {
        float a = 0.0f;
        for (int j = 0; j < nv; ++j) a = fmaf(cbar[s * nv + j], v[j], a);
        if constexpr (FREE) {
          const float cv = a - beta * SA(kCy)[s] * c2;
          SA(kRy)[s] += cv;
          wq += SA(kWd)[s] * cv;
        } else {
          const float q = SA(kRy)[s] - a;
          SA(kRy)[s] = q;
          wq += SA(kWd)[s] * q;
        }
      }
      wq = warp_sum(wq);
      if (lane == 0) wsum[warp] = wq;
    }
    // the small rows but the CVaR row (completed in the next phase 1), and
    // u, s, t
    for (int i = tid; i < ns; i += kThreads) {
      if (i == n_fc) continue;
      float zt;
      if (i < n_fc) {
        zt = 0.0f;
        for (int j = 0; j < n; ++j) zt += Fs[i * n + j] * v[j];
      } else if (i == n_fc + 1) {
        zt = -ss_hat * s_t;
      } else {
        zt = cu[i - n_fc - 2] * v[i - n_fc - 2];
      }
      row_update(al, zs[i], yds[i], zt, rvs[i], lbs[i], ubs[i]);
    }
    for (int j = tid; j < n; j += kThreads) u[j] = al * v[j] + (1.0f - al) * u[j];
    if (tid == 0) {
      st[0] = al * s_t + (1.0f - al) * st[0];
      st[1] = al * t_t + (1.0f - al) * st[1];
    }
    __syncthreads();
    if (tid == 0) {
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) a += wsum[w];
      __stcg(prow + col.wq, a);
    }
    grid.sync();

    // ======== phase 3 (per block) ========
    // coef2 = beta sum wD q / denom (every warp reduces it), y_t and the y
    // rows, one thread per sample (FREE: kappa2 in place of -coef2)
    {
      const float swq = grid_col_sum(col.wq);
      const float coef2 =
          FREE ? -((wsm[n_fc] - beta * c2 - beta * (pr[n + 2] - swq)) / denom)
                 : beta * swq / denom;
      float cyy = 0.0f;
      for (int s = tid; s < Sb; s += kThreads) {
        const float yt = FREE ? (SA(kDinv)[s] * sig) * SA(kY)[s] -
                                      SA(kDinv)[s] * SA(kRy)[s] - coef2 * SA(kWd)[s]
                                : SA(kDinv)[s] * SA(kRy)[s] - coef2 * SA(kWd)[s];
        SA(kYt)[s] = yt;
        cyy += SA(kCy)[s] * yt;
        const float zt_y = -SA(kYdh)[s] * yt - SA(kYsh)[s] * s_t;
        SA(kY)[s] = al * yt + (1.0f - al) * SA(kY)[s];
        float z = SA(kZy)[s], yd = SA(kYdy)[s];
        row_update(al, z, yd, zt_y, SA(kRvy)[s], SA(kLby)[s], SA(kUby)[s]);
        SA(kZy)[s] = z;
        SA(kYdy)[s] = yd;
      }
      cyy = warp_sum(cyy);
      if (lane == 0) wsum[warp] = cyy;
    }
    __syncthreads();
    // sweep 2: zt = G u_t - eGy y_t - eGt t_t, one thread per row, fused
    // with the row update
    {
      float* zG = RA(kZG);
      float* ydG = RA(kYdG);
      const float* rvG = RA(kRvG);
      const float* lbG = RA(kLbG);
      const float* ubG = RA(kUbG);
      const float* eGy = RA(kEGy);
      const float* eGt = RA(kEGt);
      const float* yt = SA(kYt);
      for (int q = tid; q < R; q += kThreads) {
        int s, k;
        row_of(q, s, k);
        float acc = 0.0f, cross = 0.0f;
        if constexpr (GRES) {
          const T* g = slab + (size_t)(s * K + k) * sh.gs;
#pragma unroll 4
          for (int j = 0; j < n; ++j)
            mac<PREC>(acc, cross, Split{uh[j], ul[j]}, Slab<PREC>::unpack(g[j]));
        } else {
          const float* g = gglob + cidx(s, k) * n;
#pragma unroll 16
          for (int j = 0; j < n; ++j)
            mac<PREC>(acc, cross, Split{uh[j], ul[j]}, split<PREC>(__ldg(g + j)));
        }
        const int ri = roff + s * rss + k * rsk;
        const float zt = (acc + cross) - eGy[ri] * yt[s] - eGt[ri] * t_t;
        float z = zG[ri], yd = ydG[ri];
        row_update(al, z, yd, zt, rvG[ri], lbG[ri], ubG[ri]);
        zG[ri] = z;
        ydG[ri] = yd;
      }
    }
    if (tid == 0) {
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) a += wsum[w];
      __stcg(prow + col.cy, a);
    }
    grid.sync();
  }

  // ---- epilogue: the last CVaR row, then the state in the caller's layout --
  if (chunk > 0 && warp == 0) {
    const float cyy = grid_col_sum(col.cy);
    if (lane == 0) cvar_row(cyy);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int j = tid; j < n; j += kThreads) out.u[j] = u[j];
    for (int i = tid; i < ns; i += kThreads) {
      out.z_small[i] = zs[i];
      out.yd_small[i] = yds[i];
    }
    if (chunk > 0)
      for (int j = tid; j < nv; j += kThreads) sc.vt[j] = v[j];
    if (tid == 0) {
      *out.s = st[0];
      *out.t = st[1];
    }
  }
  if constexpr (RRES) {
    for (int q = tid; q < R; q += kThreads) {
      int s, k;
      caller_row(q, s, k);
      const size_t ci = cidx(s, k);
      out.z_G[ci] = RA(kZG)[s * K + k];
      out.yd_G[ci] = RA(kYdG)[s * K + k];
    }
    for (int s = tid; s < Sb; s += kThreads) {
      out.y[m0 + s] = SA(kY)[s];
      out.z_y[m0 + s] = SA(kZy)[s];
      out.yd_y[m0 + s] = SA(kYdy)[s];
      if (chunk > 0) sc.y_t[m0 + s] = SA(kYt)[s];
    }
  }
}

// ---- host side ---------------------------------------------------------

// The launch shape of a chunk call on the current device: S samples per
// block over as many blocks as there are SMs, and what of a block's data
// fits in shared memory beside the fixed regions (Sinv among them): its
// rows, then its G slab (the slab only with the rows). Refuses (returns
// cudaErrorInvalidValue) a shape whose fixed part does not fit.
inline cudaError_t plan(const Dims& d, int prec, Shape& sh) {
  if (d.M < 1 || d.K < 1 || d.n < 1 || d.n > kMaxN || d.n_fc < 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  sh.S = (d.M + sms - 1) / sms;
  sh.grid = (d.M + sh.S - 1) / sh.S;
  sh.pw = partial_width(d.n);
  // a resident G row stride that is odd in 4-byte words: the 32 threads of
  // a warp on 32 consecutive rows of sweep 2 then hit 32 banks
  sh.gs = prec == kDefault ? 2 * (((d.n + 1) / 2) | 1) : (d.n | 1);
  const size_t slab = (size_t)sh.S * d.K * sh.gs * (prec == kDefault ? 2 : 4);
  const size_t budget = (size_t)optin;
  auto bytes = [&](int rows) { return 4 * (size_t)carve(d, sh.S, sh.pw, rows).floats; };
  sh.rows_res = bytes(1) <= budget;
  const size_t base = bytes(sh.rows_res);
  sh.g_res = sh.rows_res && base + slab <= budget;
  const size_t total = base + (sh.g_res ? slab : 0);
  if (total > budget) return cudaErrorInvalidValue;
  sh.smem = (int)total;
  return cudaSuccess;
}

// plan() for the Python wrapper: fills out[kShapeInts] in Shape's order.
inline int plan_to(const Dims& d, int prec, int* out) {
  Shape sh;
  const cudaError_t e = plan(d, prec, sh);
  if (e != cudaSuccess) return (int)e;
  const int* v = reinterpret_cast<const int*>(&sh);
  for (int i = 0; i < kShapeInts; ++i) out[i] = v[i];
  return 0;
}

// Unpacks the pointer list of a chunk call: the problem arrays (into `p`, a
// struct of float pointers), the input state, the output state and the
// scratch arrays, all float32 device pointers.
template <class P>
cudaError_t unpack(const void* const* ptrs, int n_ptrs, P& p, State& in, State& out,
                   Scratch& sc) {
  constexpr int kProbPtrs = (int)(sizeof(P) / sizeof(float*));
  if (n_ptrs != kProbPtrs + 2 * kStatePtrs + kScratchPtrs) return cudaErrorInvalidValue;
  const float** pp = reinterpret_cast<const float**>(&p);
  for (int i = 0; i < kProbPtrs; ++i) pp[i] = static_cast<const float*>(ptrs[i]);
  auto fill = [&](float** dst, int at, int count) {
    for (int i = 0; i < count; ++i)
      dst[i] = const_cast<float*>(static_cast<const float*>(ptrs[at + i]));
  };
  fill(reinterpret_cast<float**>(&in), kProbPtrs, kStatePtrs);
  fill(reinterpret_cast<float**>(&out), kProbPtrs + kStatePtrs, kStatePtrs);
  fill(reinterpret_cast<float**>(&sc), kProbPtrs + 2 * kStatePtrs, kScratchPtrs);
  return cudaSuccess;
}

// The chunk kernel for a launch shape, with or without the free-row form.
template <class P, int PREC, bool FREE>
const void* chunk_kernel(const Shape& sh) {
  return sh.g_res      ? (const void*)admm_chunk_kernel<P, PREC, true, true, FREE>
         : sh.rows_res ? (const void*)admm_chunk_kernel<P, PREC, false, true, FREE>
                       : (const void*)admm_chunk_kernel<P, PREC, false, false, FREE>;
}

// One chunk call: plan, then one cooperative launch on `stream`. A launch
// the card refuses (for instance a grid that cannot be co-resident) returns
// its error, which is also cleared so that later calls on the device do not
// see it. free_y: the structure has sm_free set (the cancellation-free KKT
// form).
template <class P, int PREC>
cudaError_t launch_chunk(P p, State in, State out, Scratch sc, Dims d, int chunk,
                         bool free_y, cudaStream_t stream) {
  Shape sh;
  cudaError_t e = plan(d, PREC, sh);
  if (e != cudaSuccess) return e;
  const void* fn = free_y ? chunk_kernel<P, PREC, true>(sh) : chunk_kernel<P, PREC, false>(sh);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
  if (e == cudaSuccess) {
    void* args[] = {&p, &in, &out, &sc, &d, &sh, &chunk};
    e = cudaLaunchCooperativeKernel(fn, dim3(sh.grid), dim3(kThreads), args,
                                    (size_t)sh.smem, stream);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace
