// Batched inverse of symmetric positive-definite matrices, float32, sm_90a.
//
// Replaces the TPU kernel `spd_inverse_pallas` (cmw_tpu/ops/spd_inverse.py),
// which inverts the ADMM KKT matrix M = H + sigma I + A^T rho A of the dense
// KKT path once per solve. That kernel holds a whole [512, 512] matrix in
// VMEM and reduces everything to 128x128 MXU matmuls (block LDL^T with
// Newton-Schulz pivot inverses, bf16 for all but the last iterations).
//
// What bounds it here. At B = 512 the n^3 = 128 MFLOP per matrix (Cholesky,
// triangular inverse and X^T X, n^3/3 each) on the f32 pipes: 65.5 GFLOP, a
// 0.98 ms bound at 67 TFLOP/s (no tensor cores: f32 with TF32 off). At B = 1
// there is too little work to fill the card; the time is the chain of
// launches and the latency of each panel step. The contract is accuracy, not
// the TPU kernel's bit pattern: ||I - M X||_inf < 1e-4 on a real walking KKT
// matrix, whose rows mix rho_eq = 1e4 with levenberg = 1e-7.
//
// Design: the four steps of a Jacobi-scaled Cholesky inverse, each cut into
// 32x32 tiles (T = kT) so that many blocks share every step. With nt =
// ceil(n / T) tiles a side (16 at n = 504, the last one 24 wide), the entry
// point `cmw_spd_inverse` issues 3 nt launches on one stream (48 at
// n = 504). The ragged edge is masked in every load and store, never padded
// in memory. All f32, one accumulation order fixed by the code: no atomics,
// no bf16, no TF32, no fast-math.
//   1. Jacobi scaling A = S M S, S = diag(1 / sqrt(m_ii)): unit diagonal, so
//      the badly scaled rows no longer cost precision in the pivots. Fused
//      into round 0: its diagonal launch writes s to the [B, n] buffer, and
//      its panel and trailing launches read M and scale it on the fly.
//   2. Blocked right-looking Cholesky, one round per diagonal tile k:
//      (a) `diagonal_kernel`, one warp per matrix: the 32x32 tile A_kk is
//      factored in registers (lane r holds row r; 32 column steps of
//      shuffles, no barrier) and L_kk inverted (lane c computes column c),
//      and X_kk = L_kk^-1 goes to the diagonal tile of the X buffer. L_kk
//      itself is never stored: nothing after the round reads it. This chain
//      of 64 dependent steps per tile is what bounds B = 1; timed alone
//      (tools/k3_factor_bench.cu), one warp in registers beats 256 threads
//      in shared memory and a looped one-warp Crout factor.
//      (b) `panel_kernel`, grid (B, tiles below k): L_ik = A_ik X_kk^T.
//      (c) `trailing_kernel`, grid (B, lower tiles of the trailing matrix):
//      A_ij -= L_ik L_jk^T with both panel tiles in shared memory. At B = 1
//      the first round already has 120 tiles, about one wave on 132 SMs.
//      At B = 512 it is bound by the read-modify-write of the trailing
//      tiles in device memory, about 11 MB per matrix.
//   3. X = L^-1, `triinv_kernel`, one block per (matrix, column panel k): the
//      column panel X[k.., k] stays in dynamic shared memory (n x 33 floats,
//      66.5 KB at n = 504) while the block walks down the row tiles,
//      X_ik = -X_ii sum_{j=k}^{i-1} L_ij X_jk; one launch, no barrier per
//      column. Each tile is fetched into registers while the previous
//      product runs, so at B = 1 the chain of 135 products of panel 0 does
//      not wait on device memory at every step.
//   4. M^-1 = S X^T X S, `output_kernel`, one block per lower 64x64 output
//      region (2x2 tiles, 36 at n = 504), mirrored through shared memory so
//      that both stores stay coalesced. The region halves the tile reads of
//      32x32 output tiles. Each sum of up to n terms is taken in two levels
//      (a 32-term partial, then the partials in order): one running f32 sum
//      over all n terms made this step the largest error of the four and the
//      residual on a walking KKT matrix about 3.6 times cuSOLVER's.
// Every tile product keeps both operands k-major in shared memory (rows
// padded: no bank conflicts on the transposing loads) and each thread's
// outputs in registers: 2x2 on 256 threads (trailing update, triangular
// inverse), 4x4 on 64 threads (panel) or on 256 threads over the 64x64
// region (output). Tiles are staged through registers with every load of a
// thread issued before the first store, so a block keeps all its loads in
// flight.
// The output buffer is the working copy of steps 1-2; X goes to a scratch
// buffer of the same shape and s to a [B, n] buffer, all three allocated by
// the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;            // tile width
constexpr int kPad = kT + 1;      // row stride of a tile in shared memory
constexpr int kThreads = 256;     // trailing update and triangular inverse (2 x 2 outputs), output (4 x 4)
constexpr int kThreadsWide = 64;  // panel: 8 x 8 threads, 4 x 4 outputs
constexpr int kR = 2 * kT;        // output region width of step 4
// the column panel of step 3 (n rows of kPad floats) and its two static tiles
// must fit the 227 KB of shared memory one block may hold
constexpr int kSmemPerBlock = 232448;
constexpr int kMaxN = (kSmemPerBlock - 2 * kT * kPad * 4) / (kPad * 4) / kT * kT;  // 1696

using Tile = float[kT][kPad];

__device__ __forceinline__ size_t at(int i, int j, int n) { return static_cast<size_t>(i) * n + j; }

// Thread e of kN holds elements e, e + kN, ... of the wr x wc tile of G at
// (r0, c0), 0 outside it; with a scale vector s (indexed by row / column of
// G), each element is (g * s_row) * s_col.
template <int kN>
__device__ __forceinline__ void fetch_tile(float v[kT * kT / kN], const float* G, int n, int r0, int c0, int wr,
                                           int wc, const float* s = nullptr) {
#pragma unroll
  for (int q = 0; q < kT * kT / kN; ++q) {
    const int e = threadIdx.x + q * kN, r = e / kT, c = e % kT;
    v[q] = (r < wr && c < wc) ? G[at(r0 + r, c0 + c, n)] : 0.0f;
  }
  if (s != nullptr) {
#pragma unroll
    for (int q = 0; q < kT * kT / kN; ++q) {
      const int e = threadIdx.x + q * kN, r = e / kT, c = e % kT;
      if (r < wr && c < wc) v[q] = (v[q] * s[r0 + r]) * s[c0 + c];
    }
  }
}

// Store a fetched tile into shared memory as it is (S[r][c]) or transposed
// (S[c][r], the k-major operand of a product over the tile's columns).
template <int kN, bool kTransposed>
__device__ __forceinline__ void stash_tile(Tile& S, const float v[kT * kT / kN]) {
#pragma unroll
  for (int q = 0; q < kT * kT / kN; ++q) {
    const int e = threadIdx.x + q * kN, r = e / kT, c = e % kT;
    if (kTransposed) {
      S[c][r] = v[q];
    } else {
      S[r][c] = v[q];
    }
  }
}

template <int kN, bool kTransposed>
__device__ __forceinline__ void load_tile(Tile& S, const float* G, int n, int r0, int c0, int wr, int wc,
                                          const float* s = nullptr) {
  float v[kT * kT / kN];
  fetch_tile<kN>(v, G, n, r0, c0, wr, wc, s);
  stash_tile<kN, kTransposed>(S, v);
}

// part[u][v] = sum_m P[m][ty + kW u] Q[m][tx + kW v] on kW x kW threads: one
// 32-term partial of a 32x32 tile product, both operands k-major in shared
// memory.
template <int kW>
__device__ __forceinline__ void tile_product(const float (*P)[kPad], const float (*Q)[kPad],
                                             float part[kT / kW][kT / kW]) {
  constexpr int kU = kT / kW;
  const int ty = threadIdx.x / kW, tx = threadIdx.x % kW;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int v = 0; v < kU; ++v) part[u][v] = 0.0f;
  }
#pragma unroll 4
  for (int m = 0; m < kT; ++m) {
    float p[kU], q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u] = P[m][ty + kW * u];
      q[u] = Q[m][tx + kW * u];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int v = 0; v < kU; ++v) part[u][v] += p[u] * q[v];
    }
  }
}

// Step 2 (a), round k: one warp per matrix factors its diagonal tile
// A_kk = L L^T in registers (lane r holds row r; 32 column steps of
// shuffles, no barrier) and inverts L (lane c computes column c of X), then
// stores X_kk = L_kk^-1 in the diagonal tile of the X buffer. Beyond the
// ragged edge the tile carries an identity. Round 0 first writes s and reads
// the tile from M, scaled.
__global__ void __launch_bounds__(32)
diagonal_kernel(const float* __restrict__ M, const float* __restrict__ A, float* __restrict__ X,
                float* __restrict__ s, int n, int k) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ Tile D;
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x, k0 = k * kT, w = min(kT, n - k0);
  const int lane = threadIdx.x;
  const float* src = A + b * nn;
  const float* sb = nullptr;
  if (k == 0) {
    src = M + b * nn;
    for (int g = lane; g < n; g += 32) s[b * n + g] = 1.0f / sqrtf(src[at(g, g, n)]);
    __syncwarp();  // the warp's own global writes are visible to it after the barrier
    sb = s + b * n;
  }
  float v[kT];
  fetch_tile<32>(v, src, n, k0, k0, w, w, sb);
#pragma unroll
  for (int q = 0; q < kT; ++q) {
    const int e = lane + q * 32, r = e / kT, c = e % kT;
    D[r][c] = (r < w && c < w) ? v[q] : (r == c ? 1.0f : 0.0f);
  }
  __syncwarp();
  float a[kT];  // row `lane` of the tile, then of L
#pragma unroll
  for (int c = 0; c < kT; ++c) a[c] = (c <= lane) ? D[lane][c] : 0.0f;
  float rdiag = 0.0f;  // 1 / L[lane][lane]
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float rd = 1.0f / sqrtf(__shfl_sync(kFull, a[j], j));
    if (lane == j) {
      rdiag = rd;  // L_jj itself is never read again
    } else if (lane > j) {
      a[j] *= rd;
    }
#pragma unroll
    for (int c = j + 1; c < kT; ++c) {
      const float lc = __shfl_sync(kFull, a[j], c);  // L[c][j]
      if (lane >= c) a[c] -= a[j] * lc;
    }
  }
  float x[kT];  // column `lane` of X = L^-1 (zero above the diagonal)
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    float acc = (lane == r) ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 0; m < r; ++m) acc -= __shfl_sync(kFull, a[m], r) * x[m];
    x[r] = acc * __shfl_sync(kFull, rdiag, r);
  }
  float* Xb = X + b * nn;
  if (lane < w) {
#pragma unroll
    for (int m = 0; m < kT; ++m) {
      if (m < w) Xb[at(k0 + m, k0 + lane, n)] = x[m];
    }
  }
}

// Step 2 (b), round k < nt - 1: block (b, y) turns row tile i = k + 1 + y
// into L_ik = A_ik X_kk^T (round 0 reads the scaled M for A_ik).
__global__ void __launch_bounds__(kThreadsWide)
panel_kernel(const float* __restrict__ M, float* __restrict__ A, const float* __restrict__ X,
             const float* __restrict__ s, int n, int k) {
  constexpr int kW = 8, kU = kT / kW;
  __shared__ Tile D;  // X_kk^T
  __shared__ Tile P;  // A_ik^T
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x, i = k + 1 + blockIdx.y;
  const int k0 = k * kT, i0 = i * kT, wi = min(kT, n - i0);  // tile k < nt - 1 is full
  float* Ab = A + b * nn;
  load_tile<kThreadsWide, true>(D, X + b * nn, n, k0, k0, kT, kT);
  if (k == 0) {
    load_tile<kThreadsWide, true>(P, M + b * nn, n, i0, k0, wi, kT, s + b * n);
  } else {
    load_tile<kThreadsWide, true>(P, Ab, n, i0, k0, wi, kT);
  }
  __syncthreads();
  float part[kU][kU];
  tile_product<kW>(P, D, part);
  const int ty = threadIdx.x / kW, tx = threadIdx.x % kW;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int v = 0; v < kU; ++v) {
      const int r = ty + kW * u, c = tx + kW * v;
      if (r < wi) Ab[at(i0 + r, k0 + c, n)] = part[u][v];
    }
  }
}

// Step 2 (c), round k: block (b, t) updates lower tile t of the trailing
// matrix, A_ij -= L_ik L_jk^T (round 0 reads the scaled M for A_ij).
__global__ void __launch_bounds__(kThreads)
trailing_kernel(const float* __restrict__ M, float* __restrict__ A, const float* __restrict__ s, int n, int k) {
  constexpr int kW = 16, kU = kT / kW;
  __shared__ Tile P;  // L_ik^T
  __shared__ Tile Q;  // L_jk^T
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x, t = blockIdx.y;
  int p = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (p * (p + 1) / 2 > t) --p;
  while ((p + 1) * (p + 2) / 2 <= t) ++p;
  const int i = k + 1 + p, j = k + 1 + (t - p * (p + 1) / 2);
  const int k0 = k * kT, i0 = i * kT, j0 = j * kT;
  const int wi = min(kT, n - i0), wj = min(kT, n - j0);
  float* Ab = A + b * nn;
  load_tile<kThreads, true>(P, Ab, n, i0, k0, wi, kT);
  load_tile<kThreads, true>(Q, Ab, n, j0, k0, wj, kT);
  __syncthreads();
  float part[kU][kU];
  tile_product<kW>(P, Q, part);
  const int ty = threadIdx.x / kW, tx = threadIdx.x % kW;
  const float* m = M + b * nn;
  const float* sb = s + b * n;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int v = 0; v < kU; ++v) {
      const int r = ty + kW * u, c = tx + kW * v;
      if (r < wi && c < wj) {
        const size_t g = at(i0 + r, j0 + c, n);
        const float aij = (k == 0) ? (m[g] * sb[i0 + r]) * sb[j0 + c] : Ab[g];
        Ab[g] = aij - part[u][v];
      }
    }
  }
}

// Step 3: block (b, k) computes column panel k of X = L^-1 below its
// diagonal tile, holding the panel (rows k0..n-1) in dynamic shared memory.
// It walks one tile sequence: for each row tile i > k, L_ij for
// j = k..i-1 (summed into acc), then X_ii (X_ik = -X_ii acc); the next tile
// of the sequence is fetched while the current product runs.
__global__ void __launch_bounds__(kThreads)
triinv_kernel(const float* __restrict__ A, float* __restrict__ X, int n) {
  extern __shared__ float panel[];  // row g of the panel at (g - k0) * kPad
  __shared__ Tile P;                // L_ij^T or X_ii^T
  __shared__ Tile S;                // acc = sum_j L_ij X_jk
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x, k = blockIdx.y;
  const int nt = (n + kT - 1) / kT;
  const int k0 = k * kT, wk = min(kT, n - k0);
  const float* Ab = A + b * nn;
  float* Xb = X + b * nn;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    if (r < wk) panel[r * kPad + c] = (c < wk) ? Xb[at(k0 + r, k0 + c, n)] : 0.0f;
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float next[kT * kT / kThreads];
  int i = k + 1, j = k;  // the current tile: L_ij for j < i, X_ii for j == i
  if (i < nt) fetch_tile<kThreads>(next, Ab, n, i * kT, j * kT, min(kT, n - i * kT), kT);
  while (i < nt) {
    const int i0 = i * kT, wi = min(kT, n - i0);
    __syncthreads();
    stash_tile<kThreads, true>(P, next);
    int ni = i, nj = j + 1;
    if (nj > ni) {
      ++ni;
      nj = k;
    }
    if (ni < nt) {
      const int wn = min(kT, n - ni * kT);
      if (nj < ni) {
        fetch_tile<kThreads>(next, Ab, n, ni * kT, nj * kT, wn, kT);  // tiles nj < ni are full
      } else {
        fetch_tile<kThreads>(next, Xb, n, ni * kT, ni * kT, wn, wn);
      }
    }
    float part[2][2];
    if (j < i) {
      __syncthreads();
      tile_product<16>(P, reinterpret_cast<const float(*)[kPad]>(panel + (j * kT - k0) * kPad), part);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) acc[u][v] += part[u][v];
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          S[ty + 16 * u][tx + 16 * v] = acc[u][v];
          acc[u][v] = 0.0f;
        }
      }
      __syncthreads();
      tile_product<16>(P, S, part);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = ty + 16 * u, c = tx + 16 * v;
          if (r < wi) {
            panel[(i0 - k0 + r) * kPad + c] = -part[u][v];
            Xb[at(i0 + r, k0 + c, n)] = -part[u][v];  // k < i, so panel k is full
          }
        }
      }
    }
    i = ni;
    j = nj;
  }
}

// Step 4: block (b, t) computes lower output region t = (ra, rb), ra >= rb,
// of kR x kR (2 x 2 tiles), out = S X^T X S, and its mirror. The sums run
// over row tiles K of X, 32 rows at a time, from the region's first row
// (X is lower triangular).
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ X, const float* __restrict__ s, float* __restrict__ out, int n) {
  constexpr int kW = 16, kU = kR / kW, kE = kT * kR / kThreads;
  __shared__ float buf[2 * kT][kR + 1];  // X_Ka and X_Kb (k-major), then the finished region
  float(*P)[kR + 1] = buf;
  float(*Q)[kR + 1] = buf + kT;
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x, t = blockIdx.y;
  int ra = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (ra * (ra + 1) / 2 > t) --ra;
  while ((ra + 1) * (ra + 2) / 2 <= t) ++ra;
  const int rb = t - ra * (ra + 1) / 2;
  const int a0 = ra * kR, b0 = rb * kR;
  const int wa = min(kR, n - a0), wb = min(kR, n - b0);
  const float* Xb = X + b * nn;
  const int ty = threadIdx.x / kW, tx = threadIdx.x % kW;
  float acc[kU][kU] = {};
  for (int K0 = a0; K0 < n; K0 += kT) {
    const int wK = min(kT, n - K0);
    float va[kE], vb[kE];
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      const int e = threadIdx.x + q * kThreads, r = e / kR, c = e % kR;
      // tiles above the diagonal of X are zero and never stored: mask them
      va[q] = (r < wK && c < wa && a0 + c < K0 + kT) ? Xb[at(K0 + r, a0 + c, n)] : 0.0f;
      vb[q] = (r < wK && c < wb && b0 + c < K0 + kT) ? Xb[at(K0 + r, b0 + c, n)] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      const int e = threadIdx.x + q * kThreads, r = e / kR, c = e % kR;
      P[r][c] = va[q];
      Q[r][c] = vb[q];
    }
    __syncthreads();
    float part[kU][kU] = {};
#pragma unroll 4
    for (int m = 0; m < kT; ++m) {
      float p[kU], q[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u] = P[m][ty + kW * u];
        q[u] = Q[m][tx + kW * u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int v = 0; v < kU; ++v) part[u][v] += p[u] * q[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int v = 0; v < kU; ++v) acc[u][v] += part[u][v];
    }
  }
  __syncthreads();
  const float* sb = s + b * n;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int v = 0; v < kU; ++v) {
      const int r = ty + kW * u, c = tx + kW * v;
      buf[r][c] = (r < wa && c < wb) ? (acc[u][v] * sb[a0 + r]) * sb[b0 + c] : 0.0f;
    }
  }
  __syncthreads();
  float* o = out + b * nn;
#pragma unroll
  for (int q = 0; q < kR * kR / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads, r = e / kR, c = e % kR;
    if (r < wa && c < wb) o[at(a0 + r, b0 + c, n)] = buf[r][c];
    if (ra != rb && r < wb && c < wa) o[at(b0 + r, a0 + c, n)] = buf[c][r];
  }
}

}  // namespace

extern "C" int cmw_spd_inverse(const float* M, float* out, float* scratch, float* s, int batch, int n,
                               cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n + kT - 1) / kT;
  const int panel_bytes = n * kPad * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(triinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, panel_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < nt; ++k) {
    diagonal_kernel<<<batch, 32, 0, stream>>>(M, out, scratch, s, n, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int p = nt - k - 1;  // tiles below the diagonal tile
    if (p > 0) {
      panel_kernel<<<dim3(batch, p), kThreadsWide, 0, stream>>>(M, out, scratch, s, n, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      trailing_kernel<<<dim3(batch, p * (p + 1) / 2), kThreads, 0, stream>>>(M, out, s, n, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  triinv_kernel<<<dim3(batch, nt), kThreads, panel_bytes, stream>>>(out, scratch, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int nr = (n + kR - 1) / kR;
  output_kernel<<<dim3(batch, nr * (nr + 1) / 2), kThreads, 0, stream>>>(scratch, s, out, n);
  return static_cast<int>(cudaGetLastError());
}
