// Batched symmetric matrix-vector product from packed lower-triangle blocks,
// float32, sm_90a.
//
// Replaces the TPU kernel `symv_packed` (cmw_tpu/ops/symv.py), the ADMM
// x-update of the dense KKT path: out = M v, where the symmetric inverse M is
// stored as its lower-triangle 128x128 blocks, packed row-major as
// [B, T = nb (nb + 1) / 2, 128, 128]. It runs 2 x 24 times per solve.
//
// What bounds it here: device-memory bytes. Each call streams the packed
// matrix (640 KB per item at n = 512) for at most 4 FLOPs per stored element,
// far below the card's compute-to-byte ratio, so plain f32 FMAs and no tensor
// cores. The least time is the packed bytes once over 3.35 TB/s.
//
// Each stored block is read once and applied both ways, as on the TPU. The
// TPU kernel does that by accumulating into the output in VMEM across its
// sequential grid; here blocks run in parallel and in no order, so the two
// products of a block go to a scratch buffer and a second launch adds them:
//   1. partials: one thread block per stored block (i, j), 4 warps, a warp
//      per 32 consecutive rows, lane l on columns 4l..4l+3 (16-byte loads, a
//      warp reads one 512-byte row per load); each thread has 8 row loads in
//      flight before its first FMA. From the same registers it forms
//        row partials  B_ij[r, :] v_j, complete over the row: a shuffle
//                      butterfly across the warp gives rowpart(i, j)[r];
//        column partials (i != j only) sum_r B_ij[r, c] v_i[r], each thread
//                      down its own columns and rows, then the 4 warps added
//                      in order: colpart(i, j)[c].
//      The diagonal block (i, i) is stored in full and applied once.
//   2. reduce: one thread per output entry adds, in this fixed order,
//        out_i = sum_{j <= i} rowpart(i, j) + sum_{k > i} colpart(k, i).
// No floating-point atomics and every sum in a fixed order, so two calls on
// the same inputs give bitwise-equal results. Of the ways to add the partials
// across blocks the second launch, from the host, is the one taken:
//   - the last-arriving block of each item behind an integer counter needs
//     zeroed memory on every call: a memset launch of its own, or a counter
//     buffer kept across calls (state shared by every caller and stream);
//   - a thread-block cluster holds at most 8 blocks portably, fewer than the
//     T = 10 stored blocks of one item at n = 512, and 16 with a
//     non-portable opt-in, fewer than the 45 at nb = 9;
//   - the reduction as a tail launch from the device (one host launch; this
//     source built as relocatable device code) was tried and not kept: on an
//     H100 it added more device time per call than the host time it saved.
// The partials take (T + T_off) * 128 floats per item (T_off = nb (nb - 1) / 2
// off-diagonal blocks), 8 KB at nb = 4: written once and read once, that is
// 2.5 % of the matrix bytes.
//
// One thread block per whole stored block: B = 1 at n = 512 launches 10 of
// them on 132 SMs. Row slabs of 64 down to 8 rows, to spread one item over
// more SMs, were built and timed on an H100 and won at no batch: at B = 1 the
// call's time is the host's and the two launches' device time did not fall;
// at B = 512 every thinner slab was slower (longer column partials and
// reduction).
//
// The one cap: the partials launch is a 1-D grid of B T blocks, at most
// 2^31 - 1. Nothing holds all of v, so nb has no other limit.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 128;               // block edge
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // = kBlk: the reduction's thread per column
constexpr int kRows = kBlk / kWarps;    // rows of the block each warp takes
constexpr int kBatch = 8;               // row loads in flight per thread before its first FMA
constexpr unsigned kFull = 0xffffffffu;

// (i, j) of the t-th stored block, row-major over the lower triangle
__device__ __forceinline__ void tri_coords(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ packed, const float* __restrict__ v,
                float* __restrict__ rowbuf, float* __restrict__ colbuf, int nb) {
  const int T = nb * (nb + 1) / 2;
  const int t = blockIdx.x % T;
  const int item = blockIdx.x / T;
  int i, j;
  tri_coords(t, i, j);
  const bool mirror = i != j;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * kRows;  // first row of this warp in the block
  const size_t n = static_cast<size_t>(nb) * kBlk;

  const float4* blk = reinterpret_cast<const float4*>(
      packed + (static_cast<size_t>(item) * T + t) * (kBlk * kBlk) + static_cast<size_t>(row0) * kBlk) + lane;
  const float* vi = v + item * n + i * kBlk + row0;  // v_i at this warp's rows
  const float4 vj = __ldg(reinterpret_cast<const float4*>(v + item * n + j * kBlk) + lane);
  float* rows_out = rowbuf + (static_cast<size_t>(item) * T + t) * kBlk + row0;

  float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int r0 = 0; r0 < kRows; r0 += kBatch) {
    float4 x[kBatch];
    float vr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = __ldg(blk + (r0 + u) * (kBlk / 4));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) vr[u] = __ldg(vi + r0 + u);
    float rp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rp[u] = x[u].x * vj.x + x[u].y * vj.y + x[u].z * vj.z + x[u].w * vj.w;
      if (mirror) {
        col.x += x[u].x * vr[u];
        col.y += x[u].y * vr[u];
        col.z += x[u].z * vr[u];
        col.w += x[u].w * vr[u];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) rp[u] += __shfl_xor_sync(kFull, rp[u], off);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (lane == u) rows_out[r0 + u] = rp[u];
    }
  }
  if (!mirror) return;  // uniform over the block

  __shared__ float4 cs[kWarps][32];  // per warp, column c at float index c
  cs[warp][lane] = col;
  __syncthreads();
  const float* csf = reinterpret_cast<const float*>(cs);
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc += csf[w * kBlk + threadIdx.x];
  const int T_off = nb * (nb - 1) / 2;
  const int o = i * (i - 1) / 2 + j;  // index of (i, j) among the off-diagonal blocks
  colbuf[(static_cast<size_t>(item) * T_off + o) * kBlk + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(kBlk)
reduce_kernel(const float* __restrict__ rowbuf, const float* __restrict__ colbuf,
              float* __restrict__ out, int nb) {
  const int i = blockIdx.x % nb;
  const int item = blockIdx.x / nb;
  const int r = threadIdx.x;
  const int T = nb * (nb + 1) / 2, T_off = nb * (nb - 1) / 2;
  const float* rp = rowbuf + (static_cast<size_t>(item) * T + i * (i + 1) / 2) * kBlk + r;
  float acc = 0.0f;
  for (int j = 0; j <= i; ++j) acc += rp[j * kBlk];
  for (int k = i + 1; k < nb; ++k) {
    acc += colbuf[(static_cast<size_t>(item) * T_off + k * (k - 1) / 2 + i) * kBlk + r];
  }
  out[(static_cast<size_t>(item) * nb + i) * kBlk + r] = acc;
}

}  // namespace

// scratch: batch (T + T_off) * 128 floats, the row partials [batch, T, 128]
// and then the column partials [batch, T_off, 128].
extern "C" int cmw_symv_packed(const float* packed, const float* v, float* scratch, float* out, int batch,
                               int nb, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long T = static_cast<long long>(nb) * (nb + 1) / 2;
  if (batch * T > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  float* rowbuf = scratch;
  float* colbuf = scratch + batch * T * kBlk;
  partials_kernel<<<static_cast<unsigned>(batch * T), kThreads, 0, stream>>>(packed, v, rowbuf, colbuf, nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<static_cast<unsigned>(batch * nb), kBlk, 0, stream>>>(rowbuf, colbuf, out, nb);
  return static_cast<int>(cudaGetLastError());
}
