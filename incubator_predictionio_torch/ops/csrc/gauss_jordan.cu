// Batched SPD solve x[i] = A[i]^-1 b[i] by normalization-free Gauss-Jordan
// elimination, for A [N, k, k] and b [N, k] in float32, k a multiple of 8 in
// [8, 128] (the wrapper pads k with an identity diagonal).
//
// Replaces the TPU kernels of incubator_predictionio_tpu/ops/pallas_kernels.py:
// _solve_lanes (:137, body _gauss_jordan_kernel :76, which the reference sends
// k <= 96 to) and _solve_slabs_wide (:173, body _gauss_jordan_kernel_wide
// :86, 96 < k <= 128). The TPU split follows VMEM; here the split follows
// what holds a system on this card:
//   k <= 32        the warp kernel    (gauss_jordan_warp_kernel)
//   32 < k <= 128  the wide kernel    (gauss_jordan_wide_kernel)
//
// Algorithm (the reference's _gj_eliminate, :37): no pivoting, because every
// system is SPD by construction (normal equations plus a lambda*I ridge). At
// step j every row i != j subtracts f_i = A[i][j] / A[j][j] times row j; row j
// itself is left as it is (its factor is zero). After k steps A is diagonal
// and one divide by the diagonal gives x. Columns < j of row j are already
// eliminated, so step j only touches columns >= j (and b): about k^3 / 2
// multiply-adds per system, where the reference does k^3.
//
// What bounds it: HBM traffic is one read of A and b and one write of x,
// (k^2 + 2k) * 4 bytes per system, against about k^3 float32 operations. At
// k = 32 the bytes bound it (0.18 ms for 138,493 systems on an H100 SXM); at
// k = 128 the arithmetic does (0.016 ms for 512 systems).
//
// Warp kernel (k <= 32). A group of G lanes owns one system (G = 16 at
// k = 32, 8 below; 2 or 4 systems per warp) and lane g holds rows g + G*r,
// r < k / G, in registers, so each pivot value read serves k / G rows.
//   - The pivot row goes through shared memory, not shuffles: at step j its
//     owner stores it as float4s into a per-group buffer, one __syncwarp,
//     and every lane reads it back as broadcast float4 loads, (k - j) / 4
//     loads instead of k - j shuffles. The buffer is double-buffered by j's
//     parity, so one __syncwarp per step suffices.
//   - Loads are coalesced and overlapped: each warp walks a grid-stride loop
//     over batches of systems (a batch is contiguous in A), copies the next
//     batch into a per-warp staging area with 16-byte cp.async while it
//     eliminates the current one in registers. The staging rows are padded
//     to k + 4 floats so the row-per-lane reads back are free of bank
//     conflicts. The grid is as many blocks as fit on the card at once.
//   - Systems past n are identity rows in registers and are never stored.
//
// Wide kernel (32 < k <= 128). One block of 16 x 16 threads owns one system
// at a time, the augmented [k][k + 1] matrix in REGISTERS, distributed
// cyclically: thread (ty, tx) holds rows ty + 16p and columns tx + 16q, an
// 8 x 9 tile at k = 128. Cyclic ownership keeps every thread busy while the
// trailing columns shrink; a column group q whose columns all lie below the
// current step is skipped at compile time (the step loop is unrolled over
// j / 16 and runs over j % 16).
//   - One barrier per two steps: the owners of columns j, j + 1 and of rows
//     j, j + 1 write them into double-buffered shared vectors (the owner of
//     A[j][j] adds its reciprocal); after one __syncthreads every thread
//     applies step j to its copy of row and column j + 1, then both steps
//     to its tile, in the owners' order of operations, so the result is bit
//     for bit that of one step per barrier. At k = 128 a thread does 144
//     FMAs per 14 vector loads of shared memory (its column entries as
//     float4, its row entries as float2), where the shared-memory kernel it
//     replaces did one FMA per three scalar accesses and two barriers per
//     step. What is left is instruction issue: the per-pair prologue
//     (factors, the pivot reciprocal, masks, the owners' stores) costs
//     about as many instructions as the FMAs.
//   - Templated on K (40, 48, ..., 128) so the tile is compile-time and stays
//     in registers; __launch_bounds__(256, 2) keeps two blocks on an SM.
//   - A persistent grid (as many blocks as fit, at most one per system)
//     loops over systems. Thread 0 fetches the next system with a 1-D TMA
//     bulk copy (cp.async.bulk into shared memory, completion on an
//     mbarrier) as soon as the current one sits in registers, so the load
//     is off the critical path and there is no wave tail.
//   - FP32 FMAs, not tensor cores: TF32 keeps 10 mantissa bits, which does
//     not hold 2e-4 on the nearly singular ALS systems.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 128;
constexpr int kWarpKernelThreads = 128;  // 4 warps per block
constexpr int kWarpsPerBlock = kWarpKernelThreads / 32;
constexpr int kTile = 16;                // wide kernel: 16 x 16 threads
constexpr int kWideThreads = kTile * kTile;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D TMA bulk copy global -> shared; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load_1d(void* dst, const void* src,
                                            uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Warp kernel, k <= 32.

template <int K>
struct WarpShape {
  static constexpr int G = K == 32 ? 16 : 8;  // lanes per system
  static constexpr int R = K / G;             // rows per lane
  static constexpr int S = 32 / G;            // systems per warp (a batch)
  static constexpr int LD = K + 4;            // padded row stride, floats
  // per warp: staged A [S*K][LD], staged b [S*K], pivot rows [S][2][LD]
  static constexpr int kA = S * K * LD;
  static constexpr int kB = S * K;
  static constexpr int kP = S * 2 * LD;
  static constexpr int kWarpFloats = kA + kB + kP;
  static constexpr size_t kSmem = sizeof(float) * kWarpsPerBlock * kWarpFloats;
};

template <int K>
__device__ __forceinline__ void warp_stage(const float* __restrict__ a,
                                           const float* __restrict__ b, float* sa,
                                           float* sb, long long batch, long long n,
                                           int lane) {
  using W = WarpShape<K>;
  const long long first = batch * W::S;
  const long long left = n - first;
  const int cnt = left < W::S ? static_cast<int>(left) : W::S;
  const float* ga = a + first * K * K;
  const int pieces = cnt * K * K / 4;  // contiguous 16-byte pieces of A
  for (int e = lane; e < pieces; e += 32) {
    const int gr = e / (K / 4);  // row within the batch
    const int c4 = e - gr * (K / 4);
    cp_async16(sa + gr * W::LD + 4 * c4, ga + 4 * e);
  }
  const float* gb = b + first * K;
  for (int e = lane; e < cnt * K / 4; e += 32) cp_async16(sb + 4 * e, gb + 4 * e);
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kWarpKernelThreads, 4)
gauss_jordan_warp_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ x, long long n) {
  using W = WarpShape<K>;
  constexpr int G = W::G, R = W::R, S = W::S, LD = W::LD;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int grp = lane / G;  // the system of this lane within the batch
  const int g = lane % G;    // this lane holds rows g + G*r
  float* sa = smem + wib * W::kWarpFloats;
  float* sb = sa + W::kA;
  float* pb = sb + W::kB + grp * 2 * LD;  // this group's two pivot buffers

  const long long nb = (n + S - 1) / S;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long batch = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  if (batch < nb) warp_stage<K>(a, b, sa, sb, batch, n, lane);

  for (; batch < nb; batch += stride) {
    cp_async_wait_all();
    __syncwarp();
    const long long sys = batch * S + grp;
    const bool active = sys < n;
    float row[R][K];
    float rhs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + G * r;
      if (active) {
        const float4* src = reinterpret_cast<const float4*>(sa + (grp * K + i) * LD);
#pragma unroll
        for (int c = 0; c < K / 4; ++c) {
          const float4 v = src[c];
          row[r][4 * c] = v.x;
          row[r][4 * c + 1] = v.y;
          row[r][4 * c + 2] = v.z;
          row[r][4 * c + 3] = v.w;
        }
        rhs[r] = sb[grp * K + i];
      } else {
#pragma unroll
        for (int c = 0; c < K; ++c) row[r][c] = (c == i) ? 1.0f : 0.0f;
        rhs[r] = 0.0f;
      }
    }
    __syncwarp();  // the staging area is free: fetch the next batch
    if (batch + stride < nb) warp_stage<K>(a, b, sa, sb, batch + stride, n, lane);

#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int jr = j / G;       // slot of row j in its owner
      const int c0 = (j / 4) * 4;  // first float4 that holds a column >= j
      float* pj = pb + (j & 1) * LD;
      if (g == j % G) {
#pragma unroll
        for (int c = c0; c < K; c += 4) {
          *reinterpret_cast<float4*>(pj + c) =
              make_float4(row[jr][c], row[jr][c + 1], row[jr][c + 2], row[jr][c + 3]);
        }
        pj[K] = rhs[jr];
      }
      __syncwarp();
      // each float4 of the pivot row is used as soon as it is loaded, so
      // only four of its values are live at a time
      float f[R];
#pragma unroll
      for (int c4 = c0; c4 < K; c4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(pj + c4);
        const float pv[4] = {v.x, v.y, v.z, v.w};
        if (c4 == c0) {
          const float inv = 1.0f / pv[j - c0];
#pragma unroll
          for (int r = 0; r < R; ++r) f[r] = (g + G * r == j) ? 0.0f : row[r][j] * inv;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c4 + u;
          if (c > j) {
#pragma unroll
            for (int r = 0; r < R; ++r) row[r][c] = fmaf(-f[r], pv[u], row[r][c]);
          }
        }
      }
      const float pr = pj[K];
#pragma unroll
      for (int r = 0; r < R; ++r) rhs[r] = fmaf(-f[r], pr, rhs[r]);
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        float diag = row[r][0];
#pragma unroll
        for (int c = 1; c < K; ++c) {
          if (i == c) diag = row[r][c];
        }
        x[sys * K + i] = rhs[r] / diag;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Wide kernel, 32 < k <= 128.

template <int K>
struct WideShape {
  static constexpr int NP = (K + kTile - 1) / kTile;      // row slots
  static constexpr int NQ = (K + 1 + kTile - 1) / kTile;  // column slots (+ b)
  static constexpr int kStage = K * K + K;                // floats: A, then b
  // Shared vectors are stored per owner thread, so a thread reads its own
  // entries with vector loads: a column as [ty][NP4] (float4 reads, two
  // distinct addresses per warp), a row as [tx][NQ2] (float2 reads; NQ2 / 2
  // is odd, so 16 threads hit 32 distinct banks).
  static constexpr int NP4 = (NP + 3) / 4 * 4;
  static constexpr int NQ2 = NQ <= 2 ? 2 : (NQ <= 6 ? 6 : (NQ <= 10 ? 10 : 14));
  // one step pair's vectors: columns j and j + 1, rows j and j + 1, and
  // 1 / A[j][j] (padded to 4)
  static constexpr int kPair = 2 * kTile * NP4 + 2 * kTile * NQ2 + 4;
  // floats: stage, two pair sets (double-buffered), the diagonal [16*NP]
  static constexpr int kFloats = kStage + 2 * kPair + kTile * NP;
  static constexpr size_t kSmem = sizeof(float) * kFloats + sizeof(uint64_t);
};

template <int K>
__global__ void __launch_bounds__(kWideThreads, 2)
gauss_jordan_wide_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ x, long long n) {
  using W = WideShape<K>;
  constexpr int NP = W::NP, NQ = W::NQ, NP4 = W::NP4, NQ2 = W::NQ2;
  constexpr int kRhsQ = K / kTile, kRhsTx = K % kTile;  // owner of column K (b)
  extern __shared__ __align__(128) float smem[];
  float* stage = smem;                      // [K][K] then [K]
  float* pairs = stage + W::kStage;         // [2][kPair]
  float* dg = pairs + 2 * W::kPair;         // [16*NP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + W::kFloats);
  const int tx = threadIdx.x, ty = threadIdx.y;
  __builtin_assume(tx < kTile && ty < kTile);  // lets bounds tests fold
  const bool leader = tx == 0 && ty == 0;
  constexpr uint32_t kBytesA = K * K * sizeof(float);
  constexpr uint32_t kBytesB = K * sizeof(float);

  if (leader) mbar_init(bar, 1);
  __syncthreads();
  long long sys = blockIdx.x;
  if (leader && sys < n) {
    mbar_expect_tx(bar, kBytesA + kBytesB);
    tma_load_1d(stage, a + sys * K * K, kBytesA, bar);
    tma_load_1d(stage + K * K, b + sys * K, kBytesB, bar);
  }

  uint32_t parity = 0;
  for (; sys < n; sys += gridDim.x) {
    mbar_wait(bar, parity);
    parity ^= 1u;
    float t[NP][NQ];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = ty + kTile * p;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = tx + kTile * q;
        float v = 0.0f;  // rows >= K and columns > K stay 0 throughout
        if (i < K && c < K) v = stage[i * K + c];
        if (i < K && c == K) v = stage[K * K + i];
        t[p][q] = v;
      }
    }
    __syncthreads();  // the stage is free: fetch the next system
    if (leader && sys + gridDim.x < n) {
      const long long nxt = sys + gridDim.x;
      mbar_expect_tx(bar, kBytesA + kBytesB);
      tma_load_1d(stage, a + nxt * K * K, kBytesA, bar);
      tma_load_1d(stage + K * K, b + nxt * K, kBytesB, bar);
    }

    // Two steps per barrier: the pair (j, j + 1) shares one __syncthreads.
    // Every thread applies step j + 1's update to its own copy of row j + 1
    // and column j + 1 (from their values before step j, in shared memory),
    // in the same operations and order as the owners would, so the result
    // is bit for bit that of one step per barrier.
#pragma unroll
    for (int jq = 0; jq < NP; ++jq) {
      const int steps = K - kTile * jq < kTile ? K - kTile * jq : kTile;  // even
#pragma unroll 1
      for (int jr = 0; jr < steps; jr += 2) {
        const int j = kTile * jq + jr;
        float* set = pairs + ((j >> 1) & 1) * W::kPair;
        float* c0 = set;                     // column j, row j's entry zeroed
        float* c1 = c0 + kTile * NP4;        // column j + 1
        float* r0 = c1 + kTile * NP4;        // row j, columns >= j
        float* r1 = r0 + kTile * NQ2;        // row j + 1, columns >= j + 1
        float* inv_slot = r1 + kTile * NQ2;  // 1 / A[j][j]
        if (tx == jr || tx == jr + 1) {  // the owners of columns j, j + 1
          float* col = (tx == jr ? c0 : c1) + ty * NP4;
#pragma unroll
          for (int p = 0; p < NP; ++p) col[p] = t[p][jq];
          if (ty == jr && tx == jr) col[jq] = 0.0f;  // row j's own factor
        }
        if (ty == jr || ty == jr + 1) {  // the owners of rows j, j + 1
          float* row = (ty == jr ? r0 : r1) + tx * NQ2;
          row[jq] = (tx + kTile * jq >= j + (ty - jr)) ? t[jq][jq] : 0.0f;
#pragma unroll
          for (int q = jq + 1; q < NQ; ++q) row[q] = t[jq][q];
          if (ty == jr && tx == jr) inv_slot[0] = 1.0f / t[jq][jq];
        }
        __syncthreads();
        // entries of row / column j + 1: owner jr + 1, slot jq
        const float inv0 = inv_slot[0];
        const float f1 = c0[(jr + 1) * NP4 + jq] * inv0;  // row j + 1's factor
        const float r0j1 = r0[(jr + 1) * NQ2 + jq];       // A[j][j+1]
        const float inv1 = 1.0f / fmaf(-f1, r0j1, r1[(jr + 1) * NQ2 + jq]);
        float f[NP], g[NP];
#pragma unroll
        for (int p4 = 0; p4 < NP4; p4 += 4) {
          const float4 a0 = *reinterpret_cast<const float4*>(c0 + ty * NP4 + p4);
          const float4 a1 = *reinterpret_cast<const float4*>(c1 + ty * NP4 + p4);
          const float v0[4] = {a0.x, a0.y, a0.z, a0.w};
          const float v1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p4 + u;
            if (p < NP) {
              f[p] = v0[u] * inv0;
              const float cj1 = fmaf(-f[p], r0j1, v1[u]);  // A[i][j+1] after j
              g[p] = cj1 * inv1;
            }
          }
        }
        if (ty == jr + 1) g[jq] = 0.0f;  // row j + 1's own factor
#pragma unroll
        for (int q2 = jq & ~1; q2 < NQ; q2 += 2) {
          const float2 w0 = *reinterpret_cast<const float2*>(r0 + tx * NQ2 + q2);
          const float2 w1 = *reinterpret_cast<const float2*>(r1 + tx * NQ2 + q2);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = q2 + u;
            if (q >= jq && q < NQ) {
              const float v0 = u ? w0.y : w0.x;
              float v1 = fmaf(-f1, v0, u ? w1.y : w1.x);  // A[j+1][c] after j
              if (q == jq && tx + kTile * q <= j) v1 = 0.0f;
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                t[p][q] = fmaf(-g[p], v1, fmaf(-f[p], v0, t[p][q]));
              }
            }
          }
        }
      }
    }

    if (tx == ty) {
#pragma unroll
      for (int p = 0; p < NP; ++p) dg[ty + kTile * p] = t[p][p];
    }
    __syncthreads();
    if (tx == kRhsTx) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int i = ty + kTile * p;
        if (i < K) x[sys * K + i] = t[p][kRhsQ] / dg[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers: a grid of as many blocks as the card holds at once (queried once
// per kernel, on the first device it runs on), fewer when there is less work.

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      count = 0;
    }
  }
  return count;
}

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <int K>
cudaError_t launch_warp(const float* a, const float* b, float* x, long long n,
                        cudaStream_t stream) {
  using W = WarpShape<K>;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    const cudaError_t err = resident_blocks(gauss_jordan_warp_kernel<K>,
                                            kWarpKernelThreads, W::kSmem, &max_blocks);
    if (err != cudaSuccess) return err;
  }
  const long long batches = (n + W::S - 1) / W::S;
  const long long want = (batches + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long blocks = want < max_blocks ? want : max_blocks;
  gauss_jordan_warp_kernel<K><<<static_cast<unsigned>(blocks), kWarpKernelThreads,
                                W::kSmem, stream>>>(a, b, x, n);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_wide(const float* a, const float* b, float* x, long long n,
                        cudaStream_t stream) {
  using W = WideShape<K>;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    const cudaError_t err = resident_blocks(gauss_jordan_wide_kernel<K>, kWideThreads,
                                            W::kSmem, &max_blocks);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = n < max_blocks ? n : max_blocks;
  gauss_jordan_wide_kernel<K><<<static_cast<unsigned>(blocks), dim3(kTile, kTile),
                                W::kSmem, stream>>>(a, b, x, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; a, b, x must be 16-byte aligned and contiguous.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take (k not a multiple of 8 in [8, 128], n < 0).
// k <= 32 runs the warp kernel, 32 < k <= 128 the wide kernel.
int pio_gauss_jordan_solve(const void* a, const void* b, void* x, long long n,
                           int k, void* stream) {
  if (k < 8 || k > kMaxK || k % 8 != 0 || n < 0 || n > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fx = static_cast<float*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 8: return launch_warp<8>(fa, fb, fx, n, s);
    case 16: return launch_warp<16>(fa, fb, fx, n, s);
    case 24: return launch_warp<24>(fa, fb, fx, n, s);
    case 32: return launch_warp<32>(fa, fb, fx, n, s);
    case 40: return launch_wide<40>(fa, fb, fx, n, s);
    case 48: return launch_wide<48>(fa, fb, fx, n, s);
    case 56: return launch_wide<56>(fa, fb, fx, n, s);
    case 64: return launch_wide<64>(fa, fb, fx, n, s);
    case 72: return launch_wide<72>(fa, fb, fx, n, s);
    case 80: return launch_wide<80>(fa, fb, fx, n, s);
    case 88: return launch_wide<88>(fa, fb, fx, n, s);
    case 96: return launch_wide<96>(fa, fb, fx, n, s);
    case 104: return launch_wide<104>(fa, fb, fx, n, s);
    case 112: return launch_wide<112>(fa, fb, fx, n, s);
    case 120: return launch_wide<120>(fa, fb, fx, n, s);
    case 128: return launch_wide<128>(fa, fb, fx, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
