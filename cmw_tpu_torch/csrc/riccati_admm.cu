// The Riccati path's ADMM loop (K2) for a batch of centroidal-MPC QPs,
// float32 and float64, sm_90a.
//
// It replaces no TPU kernel: the JAX package runs this loop as plain XLA
// (`cmw_tpu/cmpc/qp.py` admm_solve with `cmw_tpu/cmpc/riccati.py`
// riccati_apply as its x-update), which fuses it on the TPU. In PyTorch the
// same loop ran as ~370-550 library kernels an iteration inside the solve's
// CUDA graph, and the graph's nodes, not the work, set its time. Here all
// `iters` iterations of one SQP step are one launch. Per scenario it computes
// exactly `qp.admm_solve(None, q, matvec, rmatvec, l, u, rho, (x, zc, y),
// iters, sigma, alpha, apply_fn=riccati_apply(cfg, fac, .))` and its primal
// residual max |A x - zc|, in the twin's own order of operations (below).
//
// What bounds it. Per iteration a scenario reads its gains (A, B, C, K, KP, D1
// per stage and Sinv: 20 x 2,457 + 576 = 49,716 floats at T = 20, 198.9 KB in
// f32; 32,517 floats at T = 13) twice, once in each sweep, for 2 flops an
// element (`ops/roofline.py` riccati_admm_work). Read once per launch, the
// bytes at B = 512, iters = 24, are 125 MB, 0.037 ms at 3.35 TB/s, and the
// operations 2.47 GFLOP, 0.037 ms at the 67 TFLOP/s f32 peak: past B = 132
// (one block per SM) the gains' bytes and their products bound it alike. The
// time the card really takes is the latency of the sweeps' dependent steps:
// 2 T stage steps an iteration, each two short dot products (9 and 24 terms)
// behind a block barrier. At B = 1 that chain is the whole launch.
//
// Design: one thread block per scenario (grid B).
//   - The gains are copied into shared memory once per launch when they fit
//     beside the vectors (f32 to T = 22 at the production sizes) and read
//     from there 2 iters times; otherwise (f64, longer horizons) every read
//     goes to device memory (L2). `plan` chooses from the sizes alone.
//   - The constraint operator is block-local (`formulation.op_matvec`): the 8
//     rows of a corner (3 force, 5 cone) touch only that corner's 3 forces,
//     and the 3 position rows of a slot only its 3 positions. Thread g owns
//     group g (a corner, or past the corners a slot): its rows' zc, y, l, u
//     and rho, its cone coefficients or slot rotation, and its variables' q
//     and x, all in registers. So A^T (rho zc - y), the rhs, A x, the
//     relaxation, the clip and the dual step are thread-local passes, one
//     after the forward sweep and one before the backward sweep, and need no
//     exchange beyond the x and rhs vectors in shared memory.
//   - Each sweep stage is two phases split by __syncthreads, one thread per
//     output, each kind of output in a run of threads that starts on a warp
//     (no warp takes two branches): backward (gv = B'gam9 + gam_u - rhs_t, A'gam9, pi + C'gam9), then
//     (gam = [A'gam9, 0] - K'gv, ff_t = D1 gv, pi -= KP'gv); forward (u_t =
//     -K s - KP P - ff_t, A s9), then (y = A s9 + B u_t + C P, and the half
//     of K_{t+1} s that holds u_t alone, so the next u waits on the other
//     half). The products of P (KP_t P, C_t P) are taken for all stages at
//     once after the P solve.
//     Every read of a gain by neighbouring threads is to neighbouring words
//     (D1 is symmetric, so its row k is read as its column k), so shared
//     memory serves a warp's reads without bank conflicts.
//   - The twin's order of operations, so that at B = 1 (and, measured, 256)
//     a launch is bitwise the twin's loop on the card, and the walking
//     controller's MPC tick bitwise its eager path, as every other graph of
//     the port is: each elementwise operation rounded alone (no multiply-add
//     contracted); the products' sums as cuBLAS's gemv takes them there (two
//     contiguous halves, each a chain of fused multiply-adds from zero, then
//     added); the operator's sums as PyTorch's reductions take them (over the
//     last axis (0 + 2) + 1, over an inner axis (0 + 1) + 2, the five cone
//     rows (((0 + 4) + 1) + 2) + 3). Both measured on an H100;
//     `tools/k2_order_probe.py` measures them again. Any other order fails
//     the benchmark's walk comparison on late ticks, where the controller
//     amplifies a rounding of the MPC's solution ~1e4-fold. At B = 512 cuBLAS
//     takes other kernels and the two differ by round-off.
//   - nu and np are compile-time constants at the presets' 24 and 24 (any
//     other width runs the same code with run-time lengths), so each dot is
//     unrolled whole and issues all its loads before its sums wait. Nothing
//     is atomic: two launches on the same inputs are bitwise equal.
//     Divisions are y / rho, as in the twin.
//
// Shared memory of one block at T = 20, nu = np = 24, float32 (of 232,448 bytes):
//   | gains: 20 stages x 2,457 + Sinv 576 floats                | 198,864 |
//   | rhs, x (n each)                                           |   4,032 |
//   | ff, KP P (T nu each), C P (9 T)                           |   4,560 |
//   | gam, gv, A'gam9, y, A s9, K u, pi + C'gam9, pi, warp maxima |     688 |
//   | total                                                     | 208,144 |
// At T = 13: 136,408 bytes. In float64 only the vectors (18,560 bytes at T = 20).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 512;  // one thread a row group: corners + slots
constexpr int kMinThreads = 128;  // the sweeps' widest phase: 64 + 32 + 24 = 120 threads at nu = np = 24
constexpr int kRows = 8;          // constraint rows of a corner: 3 force + 5 cone
constexpr int kCone = 5;          // rows of the friction pyramid
constexpr size_t kMaxSmem = 232448;  // shared memory one H100 block may use
// nu and np of the ergoCub presets (2 contacts x 4 corners x 3, 2 contacts x 4
// slots x 3): compiled with these widths fixed, every other width at run time
constexpr int kFixedNU = 24, kFixedNP = 24;

struct Sizes {
  int T, nc, ncor, nslot;
  int nu, np, ns;  // forces a stage, contact positions, augmented state 9 + nu
  int nf, n, m;    // force variables T nu, variables, constraint rows
  int ncg, ngroups;  // corner groups T nc ncor, + the nc nslot slots
  int tcc3, tcc5;    // first cone row, first position row - tcc3
};

__host__ __device__ inline Sizes sizes(int T, int nc, int ncor, int nslot) {
  Sizes s;
  s.T = T;
  s.nc = nc;
  s.ncor = ncor;
  s.nslot = nslot;
  s.nu = nc * ncor * 3;
  s.np = nc * nslot * 3;
  s.ns = 9 + s.nu;
  s.nf = T * s.nu;
  s.n = s.nf + s.np;
  s.ncg = T * nc * ncor;
  s.ngroups = s.ncg + nc * nslot;
  s.tcc3 = 3 * s.ncg;
  s.tcc5 = 5 * s.ncg;
  s.m = s.tcc3 + s.tcc5 + s.np;
  return s;
}

// gains of one stage, in this order: A [9, 9], B [9, nu], C [9, np], K [nu, ns], KP [nu, np], D1 [nu, nu]
__host__ __device__ inline size_t stage_gains(const Sizes& s) {
  return 81 + 9 * s.nu + 9 * s.np + static_cast<size_t>(s.nu) * (s.ns + s.np + s.nu);
}
__host__ __device__ inline size_t gain_elems(const Sizes& s) { return s.T * stage_gains(s) + s.np * s.np; }
// rhs, x [n]; ff, kpp [nf]; cpp [9 T]; gam [ns]; gv, ku [nu]; ag, yv, ay [9]; cg, pi [np]; red [kMaxThreads / 32]
__host__ __device__ inline size_t vector_elems(const Sizes& s) {
  return 2 * static_cast<size_t>(s.n) + 2 * s.nf + 9 * s.T + s.ns + 2 * s.nu + 27 + 2 * s.np + kMaxThreads / 32;
}

struct Plan {
  int threads;  // 0: no launch holds these sizes
  bool staged;  // the gains in shared memory
  size_t smem;
};

Plan plan(int T, int nc, int ncor, int nslot, size_t elem) {
  if (T <= 0 || nc <= 0 || ncor <= 0 || nslot <= 0 || T > 4096) return {0, false, 0};
  const Sizes s = sizes(T, nc, ncor, nslot);
  int threads = (s.ngroups + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  const size_t vec = vector_elems(s) * elem;
  if (threads > kMaxThreads || vec > kMaxSmem) return {0, false, 0};
  const size_t all = vec + gain_elems(s) * elem;
  return all <= kMaxSmem ? Plan{threads, true, all} : Plan{threads, false, vec};
}

template <typename Real>
struct Args {
  const Real *fa, *fb, *fc, *fk, *fkp, *fd1, *sinv;  // the RiccatiFactor, [B, T, ...] and [B, np, np]
  const Real *cone, *rot;                            // ConstraintOp: [B, T, nc, 5, 3], [B, nc, nslot, 3, 3]
  const Real *q, *l, *u, *rho, *x0, *zc0, *y0;
  Real *x, *zc, *y, *prim;
  int T, nc, ncor, nslot, iters;
  Real sigma, alpha, beta;  // beta = 1 - alpha, formed in double as Python forms it
};

// Each operation rounded on its own, as the twin's separate PyTorch kernels
// round it: no multiply and add contracted into one.
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }

// sum_i a[i sa] (v[i] - w[i]) over i in [i0, i1) (w null: v[i] alone), one
// chain of fused multiply-adds from zero. With kN > 0 the count is kN and the
// chain is unrolled whole, so every load is issued before the sums wait.
template <int kN, typename Real>
__device__ __forceinline__ Real chain(const Real* __restrict__ a, int sa, const Real* __restrict__ v, int i0, int i1,
                                      const Real* __restrict__ w) {
  Real s = 0;
  if constexpr (kN > 0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) s = fma(a[(i0 + j) * sa], w ? rsub(v[i0 + j], w[i0 + j]) : v[i0 + j], s);
  } else {
    for (int i = i0; i < i1; ++i) s = fma(a[i * sa], w ? rsub(v[i], w[i]) : v[i], s);
  }
  return s;
}

// sum_i a[i sa] (v[i] - w[i]) over i < len in the order cuBLAS's gemv takes
// for the twin's products at B = 1 on an H100 (measured on all twelve of
// them): the terms in two contiguous halves, the first ceil(len / 2), each a
// chain from zero, then the halves added. So a scenario's sums are the
// twin's own where the twin takes that order.
template <int kLen, typename Real>
__device__ __forceinline__ Real dot(const Real* __restrict__ a, int sa, const Real* __restrict__ v, int len,
                                    const Real* __restrict__ w = nullptr) {
  if constexpr (kLen > 0) {
    constexpr int h = (kLen + 1) / 2;
    return radd(chain<h>(a, sa, v, 0, h, w), chain<kLen - h>(a, sa, v, h, kLen, w));
  } else {
    const int h = (len + 1) / 2;
    return radd(chain<0>(a, sa, v, 0, h, w), chain<0>(a, sa, v, h, len, w));
  }
}

__host__ __device__ constexpr int up32(int v) { return (v + 31) / 32 * 32; }

// a NaN wins, as in torch.amax
template <typename Real>
__device__ __forceinline__ Real nan_max(Real a, Real b) {
  return (b > a || b != b) ? b : a;
}

template <typename Real>
__device__ __forceinline__ Real clip(Real v, Real lo, Real hi) {  // torch.clamp: NaN stays NaN
  return v < lo ? lo : (v > hi ? hi : v);
}

// constraint row r of group g
__device__ __forceinline__ int row_of(const Sizes& s, int g, int r) {
  if (g < s.ncg) return r < 3 ? 3 * g + r : s.tcc3 + kCone * g + (r - 3);
  return s.tcc3 + s.tcc5 + 3 * (g - s.ncg) + r;
}

// Copy `count` elements from device memory into shared memory at `dst`;
// returns where the copy lies and advances `dst` past it.
template <typename Real>
__device__ __forceinline__ const Real* stage_in(Real*& dst, const Real* __restrict__ src, size_t count) {
  Real* out = dst;
#pragma unroll 8
  for (size_t i = threadIdx.x; i < count; i += blockDim.x) out[i] = src[i];
  dst += count;
  return out;
}

// kNU, kNP > 0: nu and np known at compile time (kFixedNU, kFixedNP), 0: read from the sizes
template <typename Real, bool kStaged, int kNU, int kNP>
__global__ void __launch_bounds__(kMaxThreads, 1) riccati_admm_kernel(const Args<Real> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Sizes s = sizes(p.T, p.nc, p.ncor, p.nslot);
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t b = blockIdx.x;
  const int nu = kNU > 0 ? kNU : s.nu, np = kNP > 0 ? kNP : s.np, ns = 9 + nu, T = s.T;
  // each phase's outputs in segments that start on a warp, so no warp takes two branches
  const int b1a = up32(nu), b1c = b1a + 32, b1n = b1c + np;         // gv | A'gam9 | pi + C'gam9
  const int b2d = up32(ns), b2p = b2d + up32(nu), b2n = b2p + np;   // gam | D1 gv | pi
  const int f1a = up32(nu), f1n = f1a + 9;                          // u_t | A y_t
  const int f2k = 32, f2n = f2k + nu;                               // y_{t+1} | K_{t+1} u_t
  const int hs = (ns + 1) / 2;  // K s's first half, as dot splits it

  // ---- this scenario's gains: in shared memory when they fit, else in device memory
  const Real* gA = p.fa + b * T * 81;
  const Real* gB = p.fb + b * T * 9 * nu;
  const Real* gC = p.fc + b * T * 9 * np;
  const Real* gK = p.fk + b * T * nu * ns;
  const Real* gKP = p.fkp + b * T * nu * np;
  const Real* gD1 = p.fd1 + b * T * nu * nu;
  const Real* gSinv = p.sinv + b * np * np;
  Real* sm = reinterpret_cast<Real*>(smem_raw);
  if constexpr (kStaged) {
    gA = stage_in(sm, gA, static_cast<size_t>(T) * 81);
    gB = stage_in(sm, gB, static_cast<size_t>(T) * 9 * nu);
    gC = stage_in(sm, gC, static_cast<size_t>(T) * 9 * np);
    gK = stage_in(sm, gK, static_cast<size_t>(T) * nu * ns);
    gKP = stage_in(sm, gKP, static_cast<size_t>(T) * nu * np);
    gD1 = stage_in(sm, gD1, static_cast<size_t>(T) * nu * nu);
    gSinv = stage_in(sm, gSinv, static_cast<size_t>(np) * np);
  }
  Real* rhs = sm;         // [n] rhs of the x-update
  Real* x = rhs + s.n;    // [n] x: u_t by stage, then P
  Real* ff = x + s.n;     // [nf] D1_t gv_t
  Real* kpp = ff + s.nf;  // [nf] KP_t P
  Real* cpp = kpp + s.nf;  // [9 T] C_t P
  Real* gam = cpp + 9 * T;  // [ns]
  Real* gv = gam + ns;      // [nu]
  Real* ag = gv + nu;       // [9] A_t' gam9
  Real* yv = ag + 9;        // [9] y_t of the forward sweep
  Real* ay = yv + 9;        // [9] A_t y_t
  Real* ku = ay + 9;        // [nu] the u_{t-1} part of K_t s
  Real* cg = ku + nu;       // [np] pi + C_t' gam9
  Real* pi = cg + np;       // [np]
  Real* red = pi + np;      // [kMaxThreads / 32] warp maxima
  const Real* P = x + s.nf;

  // ---- this thread's row group, in registers
  const int g = tid;
  const bool corner = g < s.ncg;
  const int nrows = corner ? kRows : (g < s.ngroups ? 3 : 0);
  const int var0 = corner ? 3 * g : s.nf + 3 * (g - s.ncg);
  Real coef[15];  // a corner: cone coefficients [5][3]; a slot: its rotation [3][3]
  Real zc[kRows], yd[kRows], lo[kRows], hi[kRows], rh[kRows], qv[3], xv[3];
#pragma unroll
  for (int k = 0; k < 15; ++k) coef[k] = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) zc[r] = yd[r] = lo[r] = hi[r] = rh[r] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) qv[c] = xv[c] = 0;
  if (nrows) {
    if (corner) {
      const int t = g / (s.nc * s.ncor), i = (g / s.ncor) % s.nc;
      const Real* cf = p.cone + ((b * T + t) * s.nc + i) * (kCone * 3);
#pragma unroll
      for (int k = 0; k < 15; ++k) coef[k] = cf[k];
    } else {
      const Real* rt = p.rot + (b * s.nc * s.nslot + (g - s.ncg)) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) coef[k] = rt[k];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const size_t j = b * s.m + row_of(s, g, r);
        zc[r] = p.zc0[j];
        yd[r] = p.y0[j];
        lo[r] = p.l[j];
        hi[r] = p.u[j];
        rh[r] = p.rho[j];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      qv[c] = p.q[b * s.n + var0 + c];
      xv[c] = p.x0[b * s.n + var0 + c];
    }
  }

  // A x of the group's rows from its variables (formulation.op_matvec)
  auto matvec = [&](Real* ax) {
    if (corner) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ax[c] = xv[c];
#pragma unroll
      for (int d = 0; d < kCone; ++d) {  // a sum over the last axis: (0 + 2) + 1
        ax[3 + d] = radd(radd(rmul(coef[3 * d], xv[0]), rmul(coef[3 * d + 2], xv[2])), rmul(coef[3 * d + 1], xv[1]));
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {  // a sum over an inner axis: (0 + 1) + 2
        ax[a] = radd(radd(rmul(coef[a], xv[0]), rmul(coef[3 + a], xv[1])), rmul(coef[6 + a], xv[2]));
      }
#pragma unroll
      for (int r = 3; r < kRows; ++r) ax[r] = 0;
    }
  };

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma x - q + A' (rho zc - y) of the group's variables (op_rmatvec)
    if (nrows) {
      Real w[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) w[r] = rsub(rmul(rh[r], zc[r]), yd[r]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Real at;
        if (corner) {  // the 5 cone rows summed as PyTorch's reduction over that axis takes them;
                       // a slot's 3 rows as over the last axis, (0 + 2) + 1
          Real pr[kCone];
#pragma unroll
          for (int d = 0; d < kCone; ++d) pr[d] = rmul(w[3 + d], coef[3 * d + c]);
          at = radd(w[c], radd(radd(radd(radd(pr[0], pr[4]), pr[1]), pr[2]), pr[3]));
        } else {
          at = radd(radd(rmul(coef[3 * c], w[0]), rmul(coef[3 * c + 2], w[2])), rmul(coef[3 * c + 1], w[1]));
        }
        rhs[var0 + c] = radd(rsub(rmul(p.sigma, xv[c]), qv[c]), at);
      }
    }
    for (int o = tid; o < ns; o += nth) gam[o] = 0;
    for (int o = tid; o < np; o += nth) pi[o] = 0;
    __syncthreads();

    // ---- backward sweep (riccati_apply), t = T - 1 .. 0
    for (int t = T - 1; t >= 0; --t) {
      const Real* At = gA + t * 81;
      const Real* Bt = gB + t * 9 * nu;
      const Real* Ct = gC + t * 9 * np;
      for (int o = tid; o < b1n; o += nth) {
        if (o < nu) {
          gv[o] = rsub(radd(dot<9>(Bt + o, nu, gam, 9), gam[9 + o]), rhs[t * nu + o]);
        } else if (o >= b1a && o < b1a + 9) {
          ag[o - b1a] = dot<9>(At + (o - b1a), 9, gam, 9);
        } else if (o >= b1c) {
          const int k = o - b1c;
          cg[k] = radd(pi[k], dot<9>(Ct + k, np, gam, 9));
        }
      }
      __syncthreads();
      const Real* Kt = gK + t * nu * ns;
      const Real* KPt = gKP + t * nu * np;
      const Real* D1t = gD1 + t * nu * nu;
      for (int o = tid; o < b2n; o += nth) {
        if (o < ns) {
          gam[o] = rsub(o < 9 ? ag[o] : Real(0), dot<kNU>(Kt + o, ns, gv, nu));
        } else if (o >= b2d && o < b2d + nu) {
          const int k = o - b2d;
          ff[t * nu + k] = dot<kNU>(D1t + k, nu, gv, nu);  // D1 is symmetric: its column k is its row k
        } else if (o >= b2p) {
          const int k = o - b2p;
          pi[k] = rsub(cg[k], dot<kNU>(KPt + k, np, gv, nu));
        }
      }
      __syncthreads();
    }

    // ---- P = -Sinv (pi - rhs_P)
    for (int o = tid; o < np; o += nth) x[s.nf + o] = -dot<kNP>(gSinv + o * np, 1, pi, np, rhs + s.nf);
    __syncthreads();
    // ---- KP_t P and C_t P of every stage; y_0 = 0
    for (int o = tid; o < s.nf + 9 * T; o += nth) {
      if (o < s.nf) {
        const int t = o / nu, k = o % nu;
        kpp[o] = dot<kNP>(gKP + (t * nu + k) * np, 1, P, np);
      } else {
        const int o2 = o - s.nf, t = o2 / 9, a = o2 % 9;
        cpp[o2] = dot<kNP>(gC + (t * 9 + a) * np, 1, P, np);
      }
    }
    for (int o = tid; o < 9; o += nth) yv[o] = 0;
    __syncthreads();

    // ---- forward sweep, t = 0 .. T - 1: s = [y_t, u_{t-1}]. K_t s in dot's
    // order: its first half, y_t and the head of u_{t-1}, waits on y_t; its
    // second half, the tail of u_{t-1} alone where h >= 9, the stage before
    // takes beside y_t
    for (int t = 0; t < T; ++t) {
      const Real* At = gA + t * 81;
      const Real* Kt = gK + t * nu * ns;
      const Real* up = x + (t - 1) * nu;  // u_{t-1}, read where t > 0
      for (int o = tid; o < f1n; o += nth) {
        if (o < nu) {
          const Real* kr = Kt + o * ns;
          Real s0 = 0, s1 = 0;
#pragma unroll
          for (int i = 0; i < hs; ++i) s0 = fma(kr[i], i < 9 ? yv[i] : (t > 0 ? up[i - 9] : Real(0)), s0);
          if (hs >= 9) {
            if (t > 0) s1 = ku[o];
          } else {
            for (int i = hs; i < ns; ++i) s1 = fma(kr[i], i < 9 ? yv[i] : (t > 0 ? up[i - 9] : Real(0)), s1);
          }
          x[t * nu + o] = rsub(rsub(-radd(s0, s1), kpp[t * nu + o]), ff[t * nu + o]);
        } else if (o >= f1a) {
          const int a = o - f1a;
          ay[a] = dot<9>(At + a * 9, 1, yv, 9);
        }
      }
      __syncthreads();
      const Real* Bt = gB + t * 9 * nu;
      const Real* Kn = Kt + nu * ns;  // K_{t+1}
      for (int o = tid; o < f2n; o += nth) {
        if (o < 9) {
          yv[o] = radd(radd(ay[o], dot<kNU>(Bt + o * nu, 1, x + t * nu, nu)), cpp[t * 9 + o]);
        } else if (o >= f2k && t + 1 < T && hs >= 9) {
          const Real* kr = Kn + (o - f2k) * ns;
          Real s1 = 0;
#pragma unroll
          for (int i = hs; i < ns; ++i) s1 = fma(kr[i], x[t * nu + i - 9], s1);
          ku[o - f2k] = s1;
        }
      }
      __syncthreads();
    }

    // ---- A x, relaxation, clip to [l, u], dual step of the group's rows
    if (nrows) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xv[c] = x[var0 + c];
      Real ax[kRows];
      matvec(ax);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nrows) {
          const Real zh = radd(rmul(p.alpha, ax[r]), rmul(p.beta, zc[r]));
          const Real zn = clip(radd(zh, rdiv(yd[r], rh[r])), lo[r], hi[r]);
          yd[r] = radd(yd[r], rmul(rh[r], rsub(zh, zn)));
          zc[r] = zn;
        }
      }
    }
  }

  // ---- outputs and prim_res = max |A x - zc|
  Real mx = 0;
  if (nrows) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p.x[b * s.n + var0 + c] = xv[c];
    Real ax[kRows];
    matvec(ax);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const size_t j = b * s.m + row_of(s, g, r);
        p.zc[j] = zc[r];
        p.y[j] = yd[r];
        mx = nan_max(mx, fabs(rsub(ax[r], zc[r])));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    Real v = red[0];
    for (int w = 1; w < nth / 32; ++w) v = nan_max(v, red[w]);
    p.prim[b] = v;
  }
}

template <typename Real, bool kStaged, int kNU, int kNP>
int launch(const Args<Real>& p, int batch, const Plan& pl, cudaStream_t stream) {
  const auto kernel = riccati_admm_kernel<Real, kStaged, kNU, kNP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, pl.threads, pl.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real, bool kStaged>
int launch_sized(const Args<Real>& p, int batch, const Plan& pl, cudaStream_t stream) {
  const Sizes s = sizes(p.T, p.nc, p.ncor, p.nslot);
  if (s.nu == kFixedNU && s.np == kFixedNP) return launch<Real, kStaged, kFixedNU, kFixedNP>(p, batch, pl, stream);
  return launch<Real, kStaged, 0, 0>(p, batch, pl, stream);
}

template <typename Real>
int run(const Real* fa, const Real* fb, const Real* fc, const Real* fk, const Real* fkp, const Real* fd1,
        const Real* sinv, const Real* cone, const Real* rot, const Real* q, const Real* l, const Real* u,
        const Real* rho, const Real* x0, const Real* zc0, const Real* y0, Real* x, Real* zc, Real* y, Real* prim,
        int batch, int T, int nc, int ncor, int nslot, int iters, double sigma, double alpha,
        cudaStream_t stream) {
  const Plan pl = plan(T, nc, ncor, nslot, sizeof(Real));
  if (batch <= 0 || iters < 0 || pl.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args<Real> p{fa, fb, fc, fk, fkp, fd1, sinv, cone, rot, q, l, u, rho, x0, zc0, y0, x, zc, y, prim,
                     T, nc, ncor, nslot, iters, static_cast<Real>(sigma), static_cast<Real>(alpha),
                     static_cast<Real>(1.0 - alpha)};
  return pl.staged ? launch_sized<Real, true>(p, batch, pl, stream) : launch_sized<Real, false>(p, batch, pl, stream);
}

}  // namespace

// out: threads a block (0: no launch holds the sizes), gains staged (0 / 1), shared memory bytes.
extern "C" int cmw_riccati_admm_plan(int* out, int T, int nc, int ncor, int nslot, int elem_bytes, cudaStream_t) {
  const Plan pl = plan(T, nc, ncor, nslot, static_cast<size_t>(elem_bytes));
  out[0] = pl.threads;
  out[1] = pl.staged ? 1 : 0;
  out[2] = static_cast<int>(pl.smem);
  return 0;
}

extern "C" int cmw_riccati_admm_f32(const float* fa, const float* fb, const float* fc, const float* fk,
                                    const float* fkp, const float* fd1, const float* sinv, const float* cone,
                                    const float* rot, const float* q, const float* l, const float* u,
                                    const float* rho, const float* x0, const float* zc0, const float* y0, float* x,
                                    float* zc, float* y, float* prim, int batch, int T, int nc, int ncor, int nslot,
                                    int iters, double sigma, double alpha, cudaStream_t stream) {
  return run<float>(fa, fb, fc, fk, fkp, fd1, sinv, cone, rot, q, l, u, rho, x0, zc0, y0, x, zc, y, prim, batch, T,
                    nc, ncor, nslot, iters, sigma, alpha, stream);
}

extern "C" int cmw_riccati_admm_f64(const double* fa, const double* fb, const double* fc, const double* fk,
                                    const double* fkp, const double* fd1, const double* sinv, const double* cone,
                                    const double* rot, const double* q, const double* l, const double* u,
                                    const double* rho, const double* x0, const double* zc0, const double* y0,
                                    double* x, double* zc, double* y, double* prim, int batch, int T, int nc,
                                    int ncor, int nslot, int iters, double sigma, double alpha, cudaStream_t stream) {
  return run<double>(fa, fb, fc, fk, fkp, fd1, sinv, cone, rot, q, l, u, rho, x0, zc0, y0, x, zc, y, prim, batch,
                     T, nc, ncor, nslot, iters, sigma, alpha, stream);
}
