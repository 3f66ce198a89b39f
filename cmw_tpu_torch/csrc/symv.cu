// Batched symmetric matrix-vector product from packed lower-triangle blocks,
// float32, sm_90a.
//
// Replaces the TPU kernel `symv_packed` (cmw_tpu/ops/symv.py), the ADMM
// x-update of the dense KKT path: out = M v, where the symmetric inverse M is
// stored as its lower-triangle 128x128 blocks, packed row-major as
// [B, nb (nb + 1) / 2, 128, 128]. It runs 2 x 24 times per solve.
//
// What bounds it here: device-memory bandwidth. Each call streams the packed
// matrix (640 KB per item at n = 512) for 2 FLOPs per element, far below the
// card's compute-to-byte ratio. The TPU kernel reads each stored block once
// and applies it both as itself and as its mirror, accumulating into the
// output in VMEM across a sequential loop. Blocks here run in parallel and
// in no order, so that accumulation would need atomics across blocks; this
// design gives every output row-block its own thread block instead:
//   grid (B, nb); block i sums B_ij v_j over the stored blocks j <= i, then
//   B_ki^T v_k over the mirrored blocks k > i, one output row per thread,
//   in registers, in a fixed order: no atomics, deterministic results.
// An off-diagonal block is therefore read twice, once by each of its two
// row-blocks, usually from L2 the second time. The non-transposed part
// stages 128x32 column chunks of the block in shared memory (coalesced
// loads, padded rows against bank conflicts); in the mirrored part
// neighbouring threads already read neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 128;   // block edge = threads per block
constexpr int kChunk = 32;  // columns staged per step
constexpr int kMaxNb = 8;   // n <= 1024

__global__ void __launch_bounds__(kBlk)
symv_packed_kernel(const float* __restrict__ packed, const float* __restrict__ v,
                   float* __restrict__ out, int nb) {
  __shared__ float vs[kMaxNb * kBlk];
  __shared__ float tile[kBlk][kChunk + 1];

  const int item = blockIdx.x;
  const int i = blockIdx.y;  // output row-block
  const int r = threadIdx.x;
  const int n = nb * kBlk;
  const size_t blk_elems = static_cast<size_t>(kBlk) * kBlk;
  const float* P = packed + item * (static_cast<size_t>(nb) * (nb + 1) / 2) * blk_elems;
  const auto block = [&](int row, int col) { return P + (row * (row + 1) / 2 + col) * blk_elems; };

  for (int c = r; c < n; c += kBlk) vs[c] = v[static_cast<size_t>(item) * n + c];
  __syncthreads();

  float acc = 0.0f;
  // stored blocks: out_i += B_ij v_j for j <= i
  for (int j = 0; j <= i; ++j) {
    const float* Bij = block(i, j);
    for (int c0 = 0; c0 < kBlk; c0 += kChunk) {
      for (int e = r; e < kBlk * kChunk; e += kBlk) {
        const int row = e / kChunk;
        const int col = e % kChunk;
        tile[row][col] = Bij[row * kBlk + c0 + col];
      }
      __syncthreads();
      const float* vj = vs + j * kBlk + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc += tile[r][c] * vj[c];
      __syncthreads();
    }
  }
  // mirrored blocks: out_i += B_ki^T v_k for k > i
  for (int k = i + 1; k < nb; ++k) {
    const float* Bki = block(k, i);
    const float* vk = vs + k * kBlk;
#pragma unroll 8
    for (int c = 0; c < kBlk; ++c) acc += Bki[c * kBlk + r] * vk[c];
  }
  out[static_cast<size_t>(item) * n + i * kBlk + r] = acc;
}

}  // namespace

extern "C" int cmw_symv_packed(const float* packed, const float* v, float* out, int batch, int nb,
                               cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || nb > kMaxNb) return static_cast<int>(cudaErrorInvalidValue);
  symv_packed_kernel<<<dim3(batch, nb), kBlk, 0, stream>>>(packed, v, out, nb);
  return static_cast<int>(cudaGetLastError());
}
