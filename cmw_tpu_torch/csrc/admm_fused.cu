// Fused fixed-iteration ADMM for a batch of QPs, float32, sm_90a.
//
// Replaces the TPU kernel `admm_fused_pallas` (cmw_tpu/ops/admm_fused.py), the
// ADMM loop of the dense KKT path with admm_impl="fused". It runs once per SQP
// iteration (2 calls per solve). For each scenario it takes the dense KKT
// inverse minv [n, n] (symmetric), the dense constraint matrix A [m, n]
// (n = 504, m = 1,304 at the production configuration) and runs `iters`
// OSQP-style iterations, the TPU kernel's body line for line:
//   w = rho zc - y;  rhs = sigma x - q + A^T w;  x = minv rhs;  ax = A x
//   zh = alpha ax + (1 - alpha) zc;  zc = clip(zh + y rinv, l, u);  y += rho (zh - zc)
// with rinv = 1 / rho computed once, as there.
//
// What bounds it. The TPU kernel keeps minv and A in VMEM for the whole loop,
// so each is read from HBM once per call. Read once, a call at B = 512,
// iters = 24 moves 1.89 GB: 0.56 ms at 3.35 TB/s. The operations it needs are
// far fewer: A (formulation.constraint_dense) holds 1.3-1.8k non-zeros of its
// 657k entries, so per iteration 2 n^2 for minv rhs and 2 nnz(A) for each A
// product, 6.5 GFLOP at B = 512 (0.1 ms at the 67 TFLOP/s f32 peak). The bound
// is the bytes.
//
// Each call is two launches.
//   1. compact_kernel: one warp per row of A, over B m rows on the whole card,
//      reads the row once (16-byte loads where n % 4 == 0), finds its non-zeros
//      with ballots and writes them in ascending column order into a row list
//      of kRowCap entries (f32 value, 16-bit column; unused slots hold kNoCol).
//      Integer atomics count the entries per column. A scenario with a row
//      above kRowCap or a column above kColCap gets its "dense" flag. In the
//      walking A a row has at most 3 entries (identity rows 1, cone rows
//      D R_k^T and position rows R^T 3) and a column at most 6 (1 identity +
//      5 cone rows).
//   2. loop_kernel: one thread-block cluster of kCluster = 8 CTAs per scenario
//      (grid 8 B). CTA r holds rows [S r, S r + S) of minv, S = ceil(n / 8)
//      (63 at n = 504; the last slice ragged or empty), loaded once by bulk
//      asynchronous copies into an mbarrier. Every CTA holds the row lists,
//      builds column lists from them (entries sorted by row, so every sum runs
//      in a fixed order) and holds all the vectors. Per iteration each CTA
//        - computes rhs = sigma x - q + A^T w from the column lists (all n);
//        - computes its S rows of x = minv rhs, kGroup = 4 rows a warp (one
//          load of rhs serves the 4 rows, their reductions interleave), and
//          writes them into every CTA's x buffer through distributed shared
//          memory (lane k of the warp to CTA k), double-buffered by parity;
//        - meets the others at one cluster barrier;
//        - computes A x from the row lists, then the clip and dual updates and
//          the next w for all m rows, a thread per row (redundantly, so no
//          further exchange).
//      A last cluster barrier precedes the outputs; CTA r writes its x slice
//      and its share of zc and y.
// Each CTA needs 215 KB of shared memory, so an SM holds one; the card runs 15
// clusters at once and B = 512 takes 35 waves. A wave is one scenario's loop,
// ~3.5 us an iteration, set by the latency of the three passes in one 16-warp
// CTA; the cluster barrier is a small part of it. Later levers: row lists
// padded to 4 for vector loads; fewer redundant list passes.
//
// Shared memory of one CTA at n = 504, m = 1,304 (of 232,448 bytes):
//   | mbarrier                                          |      16 |
//   | minv slice (63 x 504 floats)                      | 127,008 |
//   | row lists (1,304 x 3 x (4 + 2) bytes)             |  23,472 |
//   | column lists (504 x 6 x (4 + 2) bytes) + counts   |  20,160 |
//   | vectors: rhs, x twice, q (n); zc y l u rho rinv w (m) | 44,576 |
//   | total                                             | 215,232 |
//
// Longer horizons (`plan`, chosen from n and m alone, never by the caller).
// Past T = 21 (n = 528, m = 1,368) an eighth of minv no longer fits beside the
// rest, so the loop takes the first launch that fits:
//   - 8 CTAs a cluster, as above (T <= 21 at dt = 0.06);
//   - 16 CTAs a cluster, a non-portable size, slices of ceil(n / 16) rows
//     (T = 22-27; 174,080 bytes a CTA at T = 22);
//   - one block per scenario (kCluster = 1): minv streamed from device memory
//     each iteration, one x buffer, no barrier (T = 28-54);
//   - the same without the lists: the compaction is skipped and every scenario
//     takes the dense branch; a block then holds only the vectors, 4 (3 n +
//     7 m) bytes, so any size whose vectors fit one block runs (T up to 111).
//
// The dense branch. A scenario whose flag is set (an A beyond the caps: any
// dense matrix) runs the A products from the dense A in device memory in every
// CTA, a thread per column for A^T w and a warp per row for A x. It is slow
// and exists so that the kernel gives the TPU kernel's function for any A;
// the walking A never takes it. Skipping exact zeros changes no sum for
// finite x (0 v adds a signed zero, bf16(0) = 0).
//
// mxu_dtype, the template flag kMode (the TPU kernel's MXU operand precision):
//   0 "f32"    exact f32 products;
//   1 "bf16"   matrix entries and the vector operand rounded to bf16 (to
//              nearest even), products summed in f32;
//   2 "bf16x2" each matrix entry split into hi = bf16(a) and lo = bf16(a - hi),
//              the vector operand in bf16; the hi and the lo products are
//              summed apart in f32 and then added.
// Matrix entries are rounded where they are used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // loop kernel
constexpr int kWarps = kThreads / 32;
constexpr int kCompactThreads = 256;  // compaction: one warp per row of A
constexpr int kRowCap = 3;            // entries of a row list
constexpr int kColCap = 6;            // entries of a column list
constexpr uint16_t kNoCol = 0xFFFF;   // an unused row-list slot
constexpr int kChunk = 32;            // rows per partial sum of the dense A^T w
constexpr int kGroup = 4;             // rows of minv a warp takes at once
constexpr size_t kMaxSmem = 232448;   // shared memory one H100 block may use
constexpr uint32_t kBulkChunk = 65536;  // bytes per bulk copy
enum Mode : int { kF32 = 0, kBF16 = 1, kBF16x2 = 2 };

// A cluster's CTAs hold minv's row slices behind an mbarrier and keep x
// twice, by iteration parity; one block per scenario streams minv and keeps
// x once.
__host__ __device__ constexpr size_t header_bytes(int cluster) { return cluster > 1 ? 16 : 0; }
__host__ __device__ constexpr int x_buffers(int cluster) { return cluster > 1 ? 2 : 1; }

__host__ __device__ inline size_t minv_bytes(int n, int cluster) {
  const size_t slice = (n + cluster - 1) / cluster;
  return cluster > 1 ? (slice * n * 4 + 15) / 16 * 16 : 0;
}

// mbarrier, minv slice, floats (rhs, x, q: n each; zc, y, l, u, rho, rinv,
// w: m each), then with the lists: row values m kRowCap and column values
// n kColCap floats, column counts (n ints), row columns (m kRowCap) and
// column rows (n kColCap) as uint16.
__host__ __device__ inline size_t smem_bytes(int n, int m, int cluster, bool lists) {
  const size_t nn = n, mm = m;
  const size_t vectors = 4 * ((2 + x_buffers(cluster)) * nn + 7 * mm);
  const size_t list_bytes = lists ? 4 * (mm * kRowCap + nn * kColCap + nn) + 2 * (mm * kRowCap + nn * kColCap) : 0;
  return header_bytes(cluster) + minv_bytes(n, cluster) + vectors + list_bytes;
}

// The loop launch for these sizes: the first of 8 CTAs a cluster, 16 CTAs a
// cluster, one block per scenario, whose CTA holds its share of minv beside
// the lists and vectors; else one block per scenario without the lists, every
// scenario then taking the dense branch. cluster 0: no launch holds them.
struct Plan {
  int cluster = 0;
  bool lists = false;
  size_t smem = 0;
};

Plan plan(int n, int m) {
  if (n <= 0 || m <= 0 || n >= kNoCol || m > 65536) return {};
  for (const int cluster : {8, 16, 1}) {
    const size_t smem = smem_bytes(n, m, cluster, true);
    if (smem <= kMaxSmem) return {cluster, true, smem};
  }
  const size_t smem = smem_bytes(n, m, 1, false);
  return smem <= kMaxSmem ? Plan{1, false, smem} : Plan{};
}

// The caller's scratch, per scenario: column counts and the dense flag (n + 1
// ints, zeroed by cmw_admm_fused), the row values and the row columns.
size_t scratch_bytes(int n, int m, const Plan& pl) {
  return pl.lists ? 4 * (static_cast<size_t>(n) + 1) + (4 + 2) * static_cast<size_t>(m) * kRowCap : 0;
}

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
  __device__ __forceinline__ void add(float4 a, float4 v) {
    add(a.x, v.x);
    add(a.y, v.y);
    add(a.z, v.z);
    add(a.w, v.w);
  }
  __device__ __forceinline__ void add(const Dot& o) {
    hi += o.hi;
    if (kMode == kBF16x2) lo += o.lo;
  }
  // xor butterfly: every lane ends with the same bits (a + b == b + a)
  __device__ __forceinline__ void warp_sum() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
      if (kMode == kBF16x2) lo += __shfl_xor_sync(0xffffffffu, lo, off);
    }
  }
  __device__ __forceinline__ float value() const { return kMode == kBF16x2 ? hi + lo : hi; }
};

// ---------------------------------------------------------------- launch 1
template <bool kVec>
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const float* __restrict__ a_g, float* __restrict__ rval_g, uint16_t* __restrict__ rcol_g,
               int* __restrict__ ccount_g, int* __restrict__ dense_g, int batch, int n, int m) {
  const size_t g = static_cast<size_t>(blockIdx.x) * (kCompactThreads / 32) + (threadIdx.x >> 5);
  if (g >= static_cast<size_t>(batch) * m) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t item = g / m;
  const float* row = a_g + g * n;
  int* ccount = ccount_g + item * n;
  float* rval = rval_g + g * kRowCap;
  uint16_t* rcol = rcol_g + g * kRowCap;
  const unsigned below = (1u << lane) - 1u;
  int found = 0;
  bool over = false;
  for (int c0 = 0; c0 < n; c0 += 128) {  // lane holds columns c .. c + 3
    const int c = c0 + 4 * lane;
    float v[4];
    if (kVec && c < n) {
      const float4 t = *reinterpret_cast<const float4*>(row + c);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = c + j < n ? row[c + j] : 0.0f;
    }
    int pos = found, total = 0;  // pos: this lane's first slot
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned bits = __ballot_sync(0xffffffffu, v[j] != 0.0f);
      pos += __popc(bits & below);
      total += __popc(bits);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] != 0.0f) {  // NaN counts as a non-zero
        if (pos < kRowCap) {
          rval[pos] = v[j];
          rcol[pos] = static_cast<uint16_t>(c + j);
        }
        ++pos;
        over |= atomicAdd(ccount + c + j, 1) >= kColCap;
      }
    }
    found += total;
  }
  if (lane >= found && lane < kRowCap) {
    rval[lane] = 0.0f;
    rcol[lane] = kNoCol;
  }
  if (__any_sync(0xffffffffu, over || found > kRowCap) && lane == 0) dense_g[item] = 1;
}

// ---------------------------------------------------------------- launch 2
struct Args {
  const float *minv, *a, *q, *l, *u, *rho, *x0, *zc0, *y0, *rval;
  const uint16_t* rcol;
  const int* dense;
  float *x, *zc, *y;
  int n, m, iters;
  float sigma, alpha;
  bool lists;  // false: every scenario takes the dense branch
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <int kCluster>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int kMode, int kCluster>
__global__ void __launch_bounds__(kThreads, 1) loop_kernel(const Args p) {
  constexpr int kXBufs = x_buffers(kCluster);
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, m = p.m;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);                           // kCluster > 1
  float* minv_s = reinterpret_cast<float*>(smem + header_bytes(kCluster));      // this CTA's rows of minv
  float* rhs = reinterpret_cast<float*>(smem + header_bytes(kCluster) + minv_bytes(n, kCluster));  // [n] operand
  float* xb = rhs + n;         // [kXBufs][n] x, by iteration parity (full f32)
  float* q = xb + kXBufs * n;  // [n]
  float* zc = q + n;      // [m]
  float* y = zc + m;
  float* l = y + m;
  float* u = l + m;
  float* rho = u + m;
  float* rinv = rho + m;
  float* w = rinv + m;                       // [m] rho zc - y, stored as the operand
  float* rval = w + m;                       // [m][kRowCap], with the lists
  float* cval = rval + m * kRowCap;          // [n][kColCap]
  int* ccnt = reinterpret_cast<int*>(cval + n * kColCap);  // [n]
  uint16_t* rcol = reinterpret_cast<uint16_t*>(ccnt + n);  // [m][kRowCap]
  uint16_t* crow = rcol + m * kRowCap;                     // [n][kColCap], rows ascending

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t item = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;  // == cluster.block_rank() for a 1-D grid
  const int slice = (n + kCluster - 1) / kCluster;
  const int row0 = min(rank * slice, n);
  const int rows = min(slice, n - row0);  // 0 for a CTA past n
  const bool vec = (n & 3) == 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.minv) & 15) == 0;
  // only one block per scenario runs without the lists
  const bool dense = (kCluster == 1 && !p.lists) || p.dense[item] != 0;
  const float* minv_g = p.minv + item * n * n + static_cast<size_t>(row0) * n;
  const float* A = p.a + item * m * n;

  // 1. this CTA's minv rows: bulk copies in flight while the rest is set up
  const bool bulk = kCluster > 1 && vec && aligned && rows > 0;
  if (bulk && tid == 0) {
    const uint32_t bar = smem_addr(mbar);
    const uint32_t bytes = static_cast<uint32_t>(rows) * n * 4;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += kBulkChunk) {
      const uint32_t len = min(kBulkChunk, bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(minv_s) + off),
          "l"(reinterpret_cast<const char*>(minv_g) + off), "r"(len), "r"(bar)
          : "memory");
    }
  } else if (kCluster > 1 && !bulk) {
    for (int e = tid; e < rows * n; e += kThreads) minv_s[e] = minv_g[e];
  }

  // 2. the vectors
  for (int c = tid; c < n; c += kThreads) {
    xb[c] = p.x0[item * n + c];
    q[c] = p.q[item * n + c];
  }
  for (int r = tid; r < m; r += kThreads) {
    const size_t g = item * m + r;
    zc[r] = p.zc0[g];
    y[r] = p.y0[g];
    l[r] = p.l[g];
    u[r] = p.u[g];
    rho[r] = p.rho[g];
    rinv[r] = 1.0f / p.rho[g];
    w[r] = operand<kMode>(p.rho[g] * p.zc0[g] - p.y0[g]);
  }

  // 3. the row lists, and column lists built from them in row order
  if (!dense) {
    for (int e = tid; e < m * kRowCap; e += kThreads) {
      rval[e] = p.rval[item * m * kRowCap + e];
      rcol[e] = p.rcol[item * m * kRowCap + e];
    }
    for (int c = tid; c < n; c += kThreads) ccnt[c] = 0;
    __syncthreads();
    for (int e = tid; e < m * kRowCap; e += kThreads) {
      const int c = rcol[e];
      if (c == kNoCol) continue;
      const int s = atomicAdd(ccnt + c, 1);
      if (s < kColCap) {  // always, in a scenario whose flag is clear
        cval[c * kColCap + s] = rval[e];
        crow[c * kColCap + s] = static_cast<uint16_t>(e / kRowCap);
      }
    }
    __syncthreads();
    for (int c = tid; c < n; c += kThreads) {  // insertion sort by row: a fixed order
      float* cv = cval + c * kColCap;
      uint16_t* cr = crow + c * kColCap;
      const int k1 = min(ccnt[c], kColCap);
      for (int i = 1; i < k1; ++i) {
        const float v = cv[i];
        const uint16_t r = cr[i];
        int j = i - 1;
        for (; j >= 0 && cr[j] > r; --j) {
          cv[j + 1] = cv[j];
          cr[j + 1] = cr[j];
        }
        cv[j + 1] = v;
        cr[j + 1] = r;
      }
    }
  }
  __syncthreads();
  if (bulk) mbar_wait(smem_addr(mbar), 0);
  cluster_sync<kCluster>();  // every CTA of the cluster runs and is set up before the first remote write

  // lane k < kCluster writes a finished row of x into CTA k
  float* xdst = xb;
  if constexpr (kCluster > 1) {
    if (lane < kCluster) xdst = cg::this_cluster().map_shared_rank(xb, lane);
  }
  const float* mrows = kCluster > 1 ? minv_s : minv_g;
  const bool vec_rows = vec && (kCluster > 1 || aligned);

  for (int it = 0; it < p.iters; ++it) {
    const float* x = xb + (kXBufs > 1 ? it & 1 : 0) * n;
    const int nxt = (kXBufs > 1 ? (it + 1) & 1 : 0) * n;

    // rhs = sigma x - q + A^T w
    if (!dense) {
      for (int c = tid; c < n; c += kThreads) {
        const int k1 = ccnt[c];
        float a[kColCap], v[kColCap];  // every load in flight before the first product
#pragma unroll
        for (int k = 0; k < kColCap; ++k) {
          a[k] = cval[c * kColCap + k];
          v[k] = w[k < k1 ? crow[c * kColCap + k] : 0];
        }
        Dot<kMode> acc;
#pragma unroll
        for (int k = 0; k < kColCap; ++k) {
          if (k < k1) acc.add(a[k], v[k]);
        }
        rhs[c] = operand<kMode>(p.sigma * x[c] - q[c] + acc.value());
      }
    } else {
      for (int c = tid; c < n; c += kThreads) {
        Dot<kMode> acc;
        for (int r0 = 0; r0 < m; r0 += kChunk) {
          Dot<kMode> part;
          const int r1 = min(r0 + kChunk, m);
          for (int r = r0; r < r1; ++r) part.add(A[static_cast<size_t>(r) * n + c], w[r]);
          acc.add(part);
        }
        rhs[c] = operand<kMode>(p.sigma * x[c] - q[c] + acc.value());
      }
    }
    __syncthreads();

    // this CTA's rows of x = minv rhs, kGroup rows a warp (one load of rhs
    // serves them all, their reductions interleave), sent to every CTA
    for (int i0 = warp * kGroup; i0 < rows; i0 += kWarps * kGroup) {
      const float* mrow[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) mrow[j] = mrows + static_cast<size_t>(min(i0 + j, rows - 1)) * n;
      Dot<kMode> acc[kGroup];
      if (vec_rows) {
        const float4* r4 = reinterpret_cast<const float4*>(rhs);
        for (int k = lane; k < n / 4; k += 32) {
          const float4 v = r4[k];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[j].add(reinterpret_cast<const float4*>(mrow[j])[k], v);
        }
      } else {
        for (int k = lane; k < n; k += 32) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[j].add(mrow[j][k], rhs[k]);
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j].warp_sum();
      if (lane < kCluster) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (i0 + j < rows) xdst[nxt + row0 + i0 + j] = acc[j].value();
        }
      }
    }
    cluster_sync<kCluster>();  // the new x is whole in every CTA

    // ax = A x, then the clip, the dual update and the next w of that row
    const float* xn = xb + nxt;
    if (!dense) {
      for (int r = tid; r < m; r += kThreads) {
        int c[kRowCap];
        float a[kRowCap], v[kRowCap];  // every load in flight before the first product
#pragma unroll
        for (int k = 0; k < kRowCap; ++k) {
          c[k] = rcol[r * kRowCap + k];
          a[k] = rval[r * kRowCap + k];
          v[k] = xn[c[k] != kNoCol ? c[k] : 0];
        }
        Dot<kMode> acc;
#pragma unroll
        for (int k = 0; k < kRowCap; ++k) {
          if (c[k] != kNoCol) acc.add(a[k], operand<kMode>(v[k]));
        }
        const float zh = p.alpha * acc.value() + (1.0f - p.alpha) * zc[r];
        const float zn = fminf(fmaxf(zh + y[r] * rinv[r], l[r]), u[r]);
        const float yn = y[r] + rho[r] * (zh - zn);
        zc[r] = zn;
        y[r] = yn;
        w[r] = operand<kMode>(rho[r] * zn - yn);
      }
    } else {
      for (int r = warp; r < m; r += kWarps) {
        const float* row = A + static_cast<size_t>(r) * n;
        Dot<kMode> acc;
        for (int k = lane; k < n; k += 32) acc.add(row[k], operand<kMode>(xn[k]));
        acc.warp_sum();
        if (lane == 0) {
          const float zh = p.alpha * acc.value() + (1.0f - p.alpha) * zc[r];
          const float zn = fminf(fmaxf(zh + y[r] * rinv[r], l[r]), u[r]);
          const float yn = y[r] + rho[r] * (zh - zn);
          zc[r] = zn;
          y[r] = yn;
          w[r] = operand<kMode>(rho[r] * zn - yn);
        }
      }
    }
    __syncthreads();
  }
  cluster_sync<kCluster>();  // no CTA leaves while another may still write into it

  const float* xf = xb + (kXBufs > 1 ? p.iters & 1 : 0) * n;
  for (int i = tid; i < rows; i += kThreads) p.x[item * n + row0 + i] = xf[row0 + i];
  const int mslice = (m + kCluster - 1) / kCluster;
  const int r1 = min(rank * mslice + mslice, m);
  for (int r = rank * mslice + tid; r < r1; r += kThreads) {
    p.zc[item * m + r] = zc[r];
    p.y[item * m + r] = y[r];
  }
}

template <int kMode, int kCluster>
cudaLaunchConfig_t loop_config(int batch, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The loop kernel's attributes for a CTA of `smem` bytes; 16 CTAs a cluster
// is a non-portable size, which the kernel must allow.
template <int kMode, int kCluster>
cudaError_t set_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(loop_kernel<kMode, kCluster>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && kCluster > 8) {
    err = cudaFuncSetAttribute(loop_kernel<kMode, kCluster>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

template <int kMode, int kCluster>
int launch_loop(const Args& p, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_attributes<kMode, kCluster>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = loop_config<kMode, kCluster>(batch, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, loop_kernel<kMode, kCluster>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_mode(const Args& p, int batch, const Plan& pl, cudaStream_t stream) {
  switch (pl.cluster) {
    case 8:
      return launch_loop<kMode, 8>(p, batch, pl.smem, stream);
    case 16:
      return launch_loop<kMode, 16>(p, batch, pl.smem, stream);
    default:
      return launch_loop<kMode, 1>(p, batch, pl.smem, stream);
  }
}

// cudaOccupancyMaxActiveClusters of the f32 loop launch, or a negative CUDA error.
template <int kCluster>
int active_clusters(size_t smem) {
  cudaError_t err = set_attributes<kF32, kCluster>(smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = loop_config<kF32, kCluster>(512, smem, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, loop_kernel<kF32, kCluster>, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

}  // namespace

// The launch these sizes take: out[0] its cluster size (1: one block per
// scenario; 0: no launch holds the sizes), out[1] 1 if its CTAs hold the
// lists, out[2] a CTA's shared memory in bytes, out[3] the scratch bytes per
// scenario that cmw_admm_fused takes.
extern "C" int cmw_admm_fused_plan(int* out, int n, int m, cudaStream_t) {
  const Plan pl = plan(n, m);
  out[0] = pl.cluster;
  out[1] = pl.lists ? 1 : 0;
  out[2] = static_cast<int>(pl.smem);
  out[3] = static_cast<int>(scratch_bytes(n, m, pl));
  return 0;
}

// scratch: B times the bytes cmw_admm_fused_plan gives, uninitialised.
extern "C" int cmw_admm_fused(const float* minv, const float* a, const float* q, const float* l,
                              const float* u, const float* rho, const float* x0, const float* zc0,
                              const float* y0, float* x, float* zc, float* y, void* scratch, int batch, int n,
                              int m, int iters, int mode, float sigma, float alpha, cudaStream_t stream) {
  const Plan pl = plan(n, m);
  if (batch <= 0 || iters < 0 || mode < kF32 || mode > kBF16x2 || pl.cluster == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{minv, a, q, l, u, rho, x0, zc0, y0, nullptr, nullptr, nullptr, x, zc, y, n, m, iters, sigma, alpha, pl.lists};
  if (pl.lists) {
    const size_t rows = static_cast<size_t>(batch) * m;
    int* counts = static_cast<int*>(scratch);  // [B n] column counts, then [B] dense flags
    int* dense = counts + static_cast<size_t>(batch) * n;
    float* rval = reinterpret_cast<float*>(dense + batch);
    uint16_t* rcol = reinterpret_cast<uint16_t*>(rval + rows * kRowCap);
    cudaError_t err = cudaMemsetAsync(counts, 0, (static_cast<size_t>(batch) * n + batch) * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((rows + kCompactThreads / 32 - 1) / (kCompactThreads / 32));
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0) {
      compact_kernel<true><<<blocks, kCompactThreads, 0, stream>>>(a, rval, rcol, counts, dense, batch, n, m);
    } else {
      compact_kernel<false><<<blocks, kCompactThreads, 0, stream>>>(a, rval, rcol, counts, dense, batch, n, m);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.rval = rval;
    p.rcol = rcol;
    p.dense = dense;
  }
  switch (mode) {
    case kF32:
      return launch_mode<kF32>(p, batch, pl, stream);
    case kBF16:
      return launch_mode<kBF16>(p, batch, pl, stream);
    default:
      return launch_mode<kBF16x2>(p, batch, pl, stream);
  }
}

// How many clusters of the loop launch (f32) for these sizes the card holds
// at once; a negative CUDA error on failure.
extern "C" int cmw_admm_fused_active_clusters(int n, int m, cudaStream_t) {
  const Plan pl = plan(n, m);
  switch (pl.cluster) {
    case 8:
      return active_clusters<8>(pl.smem);
    case 16:
      return active_clusters<16>(pl.smem);
    case 1:
      return active_clusters<1>(pl.smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}
