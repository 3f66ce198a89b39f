// Fused fixed-iteration ADMM for a batch of QPs, float32, sm_90a.
//
// Replaces the TPU kernel `admm_fused_pallas` (cmw_tpu/ops/admm_fused.py), the
// ADMM loop of the dense KKT path with admm_impl="fused". It runs once per SQP
// iteration (2 launches per solve). For each scenario it takes the dense KKT
// inverse minv [n, n] (symmetric), the dense constraint matrix A [m, n]
// (n = 504, m = 1,304 at the production configuration) and runs `iters`
// OSQP-style iterations, the TPU kernel's body line for line:
//   w = rho zc - y;  rhs = sigma x - q + A^T w;  x = minv rhs;  ax = A x
//   zh = alpha ax + (1 - alpha) zc;  zc = clip(zh + y rinv, l, u);  y += rho (zh - zc)
// with rinv = 1 / rho computed once, as there.
//
// What bounds it here. The TPU kernel keeps minv and A in VMEM for the whole
// loop, so each is read from HBM once per launch. Unpadded they come to
// 1.016 + 2.629 MB per scenario, 16 times the 227 KB of shared memory one
// block may hold, so that design does not carry over. Read once, a launch at
// B = 512, iters = 24 moves 1.87 GB and does 38.5 GFLOP of f32 work: about
// 0.56 ms at 3.35 TB/s and 0.58 ms at the 67 TFLOP/s f32 peak, so the bound is
// the operations, by a hair.
//
// This first design is simple and does not reach that bound: minv and A are
// streamed from device memory in every iteration, A twice (6.3 MB per
// scenario and iteration). One scenario's 3.6 MB stay in the 50 MB L2 at small
// B; at B = 512 that is about 77 GB of HBM traffic per launch.
//   - one block per scenario (grid B) runs all iterations;
//   - every vector lives in shared memory: x, q, rhs (n each) and zc, y, l, u,
//     rho, rinv, w (m each), 42.5 KB at the production sizes;
//   - A^T w: one thread per column, neighbouring threads on neighbouring
//     addresses of a row; each column's sum is taken in 32-row chunks;
//   - minv rhs and A x: one warp per row, lanes stride the row, a shuffle
//     reduction; right after a row's A x its lane 0 does that row's clip and
//     dual update and the next iteration's w;
//   - __syncthreads() between the three products. No padding: every loop stops
//     at n or m.
// Later perf_opt levers, none used here: a thread-block cluster holding minv
// and A in distributed shared memory (16 x 227 KB = 3.72 MB, barely above the
// 3.64 MB unpadded, with little left for the vectors); the structured A (2,952
// non-zeros of its 657k entries) in place of the dense one; one pass over A per
// iteration (A x and the next A^T w share its rows); tensor cores for the bf16
// modes.
//
// mxu_dtype, the template flag kMode (the TPU kernel's MXU operand precision):
//   0 "f32"    exact f32 products;
//   1 "bf16"   matrix entries and the vector operand rounded to bf16 (to
//              nearest even), products summed in f32;
//   2 "bf16x2" each matrix entry split into hi = bf16(a) and lo = bf16(a - hi),
//              the vector operand in bf16; the hi and the lo products are
//              summed apart in f32 and then added.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // rows per partial sum of A^T w
constexpr size_t kMaxSmem = 232448;      // shared memory one H100 block may use
enum Mode : int { kF32 = 0, kBF16 = 1, kBF16x2 = 2 };

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int kMode>
__device__ __forceinline__ float operand(float v) {
  return kMode == kF32 ? v : bf16_round(v);
}

// One thread's sum of a * v, with the matrix entry a rounded as kMode says.
template <int kMode>
struct Dot {
  float hi = 0.0f;
  float lo = 0.0f;  // bf16x2 only

  __device__ __forceinline__ void add(float a, float v) {
    if (kMode == kF32) {
      hi = fmaf(a, v, hi);
    } else {
      const float h = bf16_round(a);
      hi = fmaf(h, v, hi);
      if (kMode == kBF16x2) lo = fmaf(bf16_round(a - h), v, lo);
    }
  }
  __device__ __forceinline__ void add(const Dot& o) {
    hi += o.hi;
    if (kMode == kBF16x2) lo += o.lo;
  }
  __device__ __forceinline__ void warp_sum() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
      if (kMode == kBF16x2) lo += __shfl_xor_sync(0xffffffffu, lo, off);
    }
  }
  __device__ __forceinline__ float value() const { return kMode == kBF16x2 ? hi + lo : hi; }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
admm_fused_kernel(const float* __restrict__ minv_g, const float* __restrict__ a_g,
                  const float* __restrict__ q_g, const float* __restrict__ l_g,
                  const float* __restrict__ u_g, const float* __restrict__ rho_g,
                  const float* __restrict__ x0_g, const float* __restrict__ zc0_g,
                  const float* __restrict__ y0_g, float* __restrict__ x_out,
                  float* __restrict__ zc_out, float* __restrict__ y_out,
                  int n, int m, int iters, float sigma, float alpha) {
  extern __shared__ float smem[];
  float* x = smem;      // [n] primal iterate (full f32)
  float* q = x + n;     // [n]
  float* rhs = q + n;   // [n] x-update right-hand side, stored as the operand
  float* zc = rhs + n;  // [m]
  float* y = zc + m;    // [m]
  float* l = y + m;     // [m]
  float* u = l + m;     // [m]
  float* rho = u + m;   // [m]
  float* rinv = rho + m;  // [m]
  float* w = rinv + m;  // [m] rho zc - y, stored as the operand

  const size_t item = blockIdx.x;
  const float* minv = minv_g + item * n * n;
  const float* A = a_g + item * m * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int c = tid; c < n; c += kThreads) {
    x[c] = x0_g[item * n + c];
    q[c] = q_g[item * n + c];
  }
  for (int r = tid; r < m; r += kThreads) {
    const size_t g = item * m + r;
    zc[r] = zc0_g[g];
    y[r] = y0_g[g];
    l[r] = l_g[g];
    u[r] = u_g[g];
    rho[r] = rho_g[g];
    rinv[r] = 1.0f / rho_g[g];
    w[r] = operand<kMode>(rho_g[g] * zc0_g[g] - y0_g[g]);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - q + A^T w; thread c owns column c
    for (int c = tid; c < n; c += kThreads) {
      Dot<kMode> acc;
      for (int r0 = 0; r0 < m; r0 += kChunk) {
        Dot<kMode> part;
        const int r1 = min(r0 + kChunk, m);
        for (int r = r0; r < r1; ++r) part.add(A[static_cast<size_t>(r) * n + c], w[r]);
        acc.add(part);
      }
      rhs[c] = operand<kMode>(sigma * x[c] - q[c] + acc.value());
    }
    __syncthreads();

    // x = minv rhs; warp per row
    for (int i = warp; i < n; i += kWarps) {
      const float* row = minv + static_cast<size_t>(i) * n;
      Dot<kMode> acc;
      for (int k = lane; k < n; k += 32) acc.add(row[k], rhs[k]);
      acc.warp_sum();
      if (lane == 0) x[i] = acc.value();
    }
    __syncthreads();

    // ax = A x, then that row's clip and dual update; warp per row
    for (int r = warp; r < m; r += kWarps) {
      const float* row = A + static_cast<size_t>(r) * n;
      Dot<kMode> acc;
      for (int k = lane; k < n; k += 32) acc.add(row[k], operand<kMode>(x[k]));
      acc.warp_sum();
      if (lane == 0) {
        const float zh = alpha * acc.value() + (1.0f - alpha) * zc[r];
        const float zn = fminf(fmaxf(zh + y[r] * rinv[r], l[r]), u[r]);
        const float yn = y[r] + rho[r] * (zh - zn);
        zc[r] = zn;
        y[r] = yn;
        w[r] = operand<kMode>(rho[r] * zn - yn);
      }
    }
    __syncthreads();
  }

  for (int c = tid; c < n; c += kThreads) x_out[item * n + c] = x[c];
  for (int r = tid; r < m; r += kThreads) {
    zc_out[item * m + r] = zc[r];
    y_out[item * m + r] = y[r];
  }
}

template <int kMode>
int launch(const float* minv, const float* a, const float* q, const float* l, const float* u,
           const float* rho, const float* x0, const float* zc0, const float* y0, float* x, float* zc,
           float* y, int batch, int n, int m, int iters, float sigma, float alpha, size_t smem,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      admm_fused_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_fused_kernel<kMode><<<batch, kThreads, smem, stream>>>(minv, a, q, l, u, rho, x0, zc0, y0, x, zc,
                                                             y, n, m, iters, sigma, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cmw_admm_fused(const float* minv, const float* a, const float* q, const float* l,
                              const float* u, const float* rho, const float* x0, const float* zc0,
                              const float* y0, float* x, float* zc, float* y, int batch, int n, int m,
                              int iters, int mode, float sigma, float alpha, cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m)) * sizeof(float);
  if (batch <= 0 || n <= 0 || m <= 0 || iters < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case kF32:
      return launch<kF32>(minv, a, q, l, u, rho, x0, zc0, y0, x, zc, y, batch, n, m, iters, sigma, alpha,
                          smem, stream);
    case kBF16:
      return launch<kBF16>(minv, a, q, l, u, rho, x0, zc0, y0, x, zc, y, batch, n, m, iters, sigma, alpha,
                           smem, stream);
    case kBF16x2:
      return launch<kBF16x2>(minv, a, q, l, u, rho, x0, zc0, y0, x, zc, y, batch, n, m, iters, sigma,
                             alpha, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
