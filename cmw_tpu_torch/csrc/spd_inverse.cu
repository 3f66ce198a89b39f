// Batched inverse of symmetric positive-definite matrices, float32, sm_90a.
//
// Replaces the TPU kernel `spd_inverse_pallas` (cmw_tpu/ops/spd_inverse.py),
// which inverts the ADMM KKT matrix M = H + sigma I + A^T rho A of the dense
// KKT path once per solve. That kernel holds a whole [512, 512] matrix in
// VMEM and reduces everything to 128x128 MXU matmuls (block LDL^T with
// Newton-Schulz pivot inverses, bf16 for all but the last iterations).
//
// What bounds it here: a 504x504 f32 matrix is 1 MB, four times the 227 KB
// of shared memory one block may hold, so the working copy lives in device
// memory (mostly L2-resident while its block runs). The factorisation is a
// chain of n dependent column steps, so one block owns one matrix and the
// batch supplies the parallelism across the 132 SMs (B = 512 gives about
// four waves). The contract is accuracy, not the TPU kernel's bit pattern:
// ||I - M X||_inf < 1e-4 on a real walking KKT matrix, whose rows mix
// rho_eq = 1e4 with levenberg = 1e-7.
//
// Design, all f32 with one accumulation order fixed by the code (no atomics,
// no bf16, no TF32, no fast-math):
//   1. Jacobi scaling A = S M S, S = diag(1 / sqrt(m_ii)): unit diagonal, so
//      the badly scaled rows no longer cost precision in the pivots.
//   2. Right-looking Cholesky A = L L^T, one column per step; the new column
//      is staged in shared memory and the trailing lower triangle is updated
//      row-wise by warps (coalesced), two __syncthreads per column.
//   3. X = L^-1 by forward substitution, one column of X per thread; row i of
//      L is staged in shared memory and read as a broadcast. Each warp starts
//      its sums at its first column so that the reads stay uniform.
//   4. M^-1 = S X^T X S as a shared-memory tiled product over the lower
//      32x32 output tiles, each mirrored to the upper triangle. Each sum of
//      up to n terms is taken in two levels (32-term chunk sums, then the
//      chunk sums in order): one running f32 sum over all n terms made this
//      step the largest error of the four and the residual on a walking KKT
//      matrix about 3.6 times cuSOLVER's.
// The output buffer is the working copy of steps 1-2; X goes to a scratch
// buffer of the same shape. Both are allocated by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = kThreads;  // step 3 runs one thread per column
constexpr int kTile = 32;

__global__ void __launch_bounds__(kThreads)
spd_inverse_kernel(const float* __restrict__ M, float* __restrict__ out,
                   float* __restrict__ xbuf, int n) {
  __shared__ float s[kMaxN];    // Jacobi scale 1 / sqrt(m_ii)
  __shared__ float vec[kMaxN];  // column of L (step 2) or row of L (step 3)
  __shared__ float ta[kTile][kTile + 1];
  __shared__ float tb[kTile][kTile + 1];

  const size_t nn = static_cast<size_t>(n) * n;
  const float* m = M + blockIdx.x * nn;
  float* L = out + blockIdx.x * nn;
  float* X = xbuf + blockIdx.x * nn;
  const auto at = [n](int i, int j) { return static_cast<size_t>(i) * n + j; };
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  // --- 1. Jacobi scaling of the lower triangle ---------------------------
  for (int i = tid; i < n; i += kThreads) s[i] = 1.0f / sqrtf(m[at(i, i)]);
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    const float si = s[i];
    for (int j = lane; j <= i; j += 32) {
      L[at(i, j)] = (m[at(i, j)] * si) * s[j];
    }
  }
  __syncthreads();

  // --- 2. right-looking Cholesky, column k per step ----------------------
  for (int k = 0; k < n; ++k) {
    // every thread reads the pivot; it is written back only after the
    // barrier below, in the trailing phase, which never reads it
    const float d = sqrtf(L[at(k, k)]);
    for (int i = k + 1 + tid; i < n; i += kThreads) {
      const float v = L[at(i, k)] / d;
      vec[i] = v;
      L[at(i, k)] = v;
    }
    __syncthreads();
    if (tid == 0) L[at(k, k)] = d;
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      const float li = vec[i];
      float* row = L + at(i, 0);
      for (int j = k + 1 + lane; j <= i; j += 32) row[j] -= li * vec[j];
    }
    __syncthreads();
  }

  // --- 3. X = L^-1, thread j owns column j --------------------------------
  const int j = tid;
  const int j0 = j & ~31;  // warp-uniform start of the sums (X[k][j] = 0 for k < j)
  for (int i = 0; i < n; ++i) {
    for (int k = tid; k <= i; k += kThreads) vec[k] = L[at(i, k)];
    __syncthreads();
    if (j < n) {
      float x = 0.0f;
      if (i >= j) {
        float acc = (i == j) ? 1.0f : 0.0f;
#pragma unroll 8
        for (int k = j0; k < i; ++k) acc -= vec[k] * X[at(k, j)];
        x = acc / vec[i];
      }
      X[at(i, j)] = x;
    }
    __syncthreads();
  }

  // --- 4. out = S X^T X S over the lower output tiles, mirrored ----------
  const int ty = tid / kTile;
  const int tx = tid % kTile;
  const int nt = (n + kTile - 1) / kTile;
  for (int ti = 0; ti < nt; ++ti) {
    for (int tj = 0; tj <= ti; ++tj) {
      const int a = ti * kTile + ty;  // output row
      const int b = tj * kTile + tx;  // output column
      float acc = 0.0f;
      // X is lower triangular: rows k < ti * kTile are zero in tile column ti
      for (int k0 = ti * kTile; k0 < n; k0 += kTile) {
        const int k = k0 + ty;
        const int ca = ti * kTile + tx;
        const int cb = tj * kTile + tx;
        ta[ty][tx] = (k < n && ca < n) ? X[at(k, ca)] : 0.0f;
        tb[ty][tx] = (k < n && cb < n) ? X[at(k, cb)] : 0.0f;
        __syncthreads();
        float part = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kTile; ++kk) part += ta[kk][ty] * tb[kk][tx];
        acc += part;
        __syncthreads();
      }
      const float val = (a < n && b < n) ? (acc * s[a]) * s[b] : 0.0f;
      if (a < n && b < n) L[at(a, b)] = val;
      if (ti != tj) {
        // mirror through shared memory so the transposed store stays coalesced
        ta[ty][tx] = val;
        __syncthreads();
        const int ra = tj * kTile + ty;
        const int cb2 = ti * kTile + tx;
        if (ra < n && cb2 < n) L[at(ra, cb2)] = ta[tx][ty];
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" int cmw_spd_inverse(const float* M, float* out, float* scratch, int batch, int n,
                               cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  spd_inverse_kernel<<<batch, kThreads, 0, stream>>>(M, out, scratch, n);
  return static_cast<int>(cudaGetLastError());
}
