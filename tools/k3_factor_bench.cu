// Micro-benchmark behind the diagonal factor of cmw_tpu_torch/csrc/spd_inverse.cu:
// three ways to factor a 32x32 SPD tile (L L^T) and invert L, one tile per
// block, timed with CUDA events at 1 and 512 blocks, on a CUDA card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o k3_factor_bench tools/k3_factor_bench.cu
//   ./k3_factor_bench
//
// It prints the time per launch of each variant and its largest difference
// from the first. (a) is the variant the kernel uses.
#include <cuda_runtime.h>
#include <cstdio>
#include <vector>
#include <cmath>

constexpr int kT = 32, kPad = 33;
constexpr unsigned kFull = 0xffffffffu;
using Tile = float[kT][kPad];

// (a) one warp, lane r holds row r in registers, shuffles (fully unrolled)
__global__ void factor_regs(const float* A, float* X) {
  __shared__ Tile D;
  const float* a_in = A + blockIdx.x * kT * kT;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) D[e / kT][e % kT] = a_in[e];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float a[kT];
#pragma unroll
  for (int c = 0; c < kT; ++c) a[c] = (c <= lane) ? D[lane][c] : 0.0f;
  float rdiag = 0.0f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float d = sqrtf(__shfl_sync(kFull, a[j], j));
    const float rd = 1.0f / d;
    if (lane == j) { a[j] = d; rdiag = rd; } else if (lane > j) { a[j] *= rd; }
#pragma unroll
    for (int c = j + 1; c < kT; ++c) {
      const float lc = __shfl_sync(kFull, a[j], c);
      if (lane >= c) a[c] -= a[j] * lc;
    }
  }
  float x[kT];
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    float acc = (lane == r) ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 0; m < r; ++m) acc -= __shfl_sync(kFull, a[m], r) * x[m];
    x[r] = acc * __shfl_sync(kFull, rdiag, r);
  }
  float* xo = X + blockIdx.x * kT * kT;
#pragma unroll
  for (int m = 0; m < kT; ++m) xo[m * kT + lane] = x[m];
}

// (b) 256 threads in shared memory, Cholesky and forward elimination of I together
__global__ void factor_smem256(const float* A, float* X) {
  __shared__ Tile W, Xs;
  __shared__ float lcol[kT], xrow[kT];
  const int t = threadIdx.x;
  const float* a_in = A + blockIdx.x * kT * kT;
  for (int e = t; e < kT * kT; e += 256) { W[e / kT][e % kT] = a_in[e]; Xs[e / kT][e % kT] = (e / kT == e % kT); }
  __syncthreads();
  for (int j = 0; j < kT; ++j) {
    const float rd = 1.0f / sqrtf(W[j][j]);
    if (t < kT) {
      lcol[t] = (t > j) ? W[t][j] * rd : 0.0f;
      xrow[t] = (t <= j) ? Xs[j][t] * rd : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + q * 256, r = e / kT, c = e % kT;
      if (r > j) {
        if (c <= j) Xs[r][c] -= lcol[r] * xrow[c];
        else if (c <= r) W[r][c] -= lcol[r] * lcol[c];
      } else if (r == j && c <= j) Xs[j][c] = xrow[c];
    }
    __syncthreads();
  }
  float* xo = X + blockIdx.x * kT * kT;
  for (int e = t; e < kT * kT; e += 256) xo[e] = Xs[e / kT][e % kT];
}

// (c) one warp, shared memory, looped: Crout columns (lane = row), then
// forward substitution (lane = column of X)
__global__ void factor_crout(const float* A, float* X) {
  __shared__ Tile L, Xs;
  __shared__ float rdiag[kT];
  const float* a_in = A + blockIdx.x * kT * kT;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) L[e / kT][e % kT] = a_in[e];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int j = 0; j < kT; ++j) {
    float acc = L[lane][j];  // lane >= j: A[lane][j]
    for (int m = 0; m < j; ++m) acc -= L[lane][m] * L[j][m];
    if (lane == j) {
      const float d = sqrtf(acc);
      L[j][j] = d;
      rdiag[j] = 1.0f / d;
    }
    __syncwarp();
    if (lane > j) L[lane][j] = acc * rdiag[j];
    __syncwarp();
  }
  for (int r = 0; r < kT; ++r) {
    float acc = (lane == r) ? 1.0f : 0.0f;
    for (int m = lane; m < r; ++m) acc -= L[r][m] * Xs[m][lane];
    Xs[r][lane] = acc * rdiag[r];
  }
  __syncwarp();
  float* xo = X + blockIdx.x * kT * kT;
  for (int m = 0; m < kT; ++m) xo[m * kT + lane] = Xs[m][lane];
}

template <class K>
float time_ms(K kernel, int blocks, const float* A, float* X, int reps) {
  cudaEvent_t s, e;
  cudaEventCreate(&s); cudaEventCreate(&e);
  kernel<<<blocks, 256>>>(A, X);
  cudaEventRecord(s);
  for (int i = 0; i < reps; ++i) kernel<<<blocks, 256>>>(A, X);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, s, e);
  return ms / reps;
}

int main() {
  const int B = 512;
  std::vector<float> h(B * kT * kT);
  for (int b = 0; b < B; ++b)
    for (int i = 0; i < kT; ++i)
      for (int j = 0; j < kT; ++j) h[(b * kT + i) * kT + j] = (i == j ? 2.0f : 0.0f) + 0.5f / (1 + i + j + b % 7);
  float *A, *X;
  cudaMalloc(&A, h.size() * 4); cudaMalloc(&X, h.size() * 4);
  cudaMemcpy(A, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
  const char* names[3] = {"regs (1 warp, unrolled shuffles)", "smem 256 threads", "crout (1 warp, smem, looped)"};
  std::vector<float> ref;
  for (int v = 0; v < 3; ++v) {
    for (int blocks : {1, 512}) {
      float ms = v == 0 ? time_ms(factor_regs, blocks, A, X, 200)
               : v == 1 ? time_ms(factor_smem256, blocks, A, X, 200) : time_ms(factor_crout, blocks, A, X, 200);
      printf("%s blocks=%d: %.2f us per launch\n", names[v], blocks, ms * 1e3);
    }
    std::vector<float> out(h.size());
    cudaMemcpy(out.data(), X, out.size() * 4, cudaMemcpyDeviceToHost);
    if (v == 0) ref = out;
    double d = 0;
    for (size_t i = 0; i < out.size(); ++i) d = fmax(d, fabs(out[i] - ref[i]));
    printf("  max |X - X_regs| %.3e (err %s)\n", d, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
