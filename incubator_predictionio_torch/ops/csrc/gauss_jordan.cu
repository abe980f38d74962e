// Batched SPD solve x[i] = A[i]^-1 b[i] by normalization-free Gauss-Jordan
// elimination, for A [N, k, k] and b [N, k] in float32, k a multiple of 8 in
// [8, 128] (the wrapper pads k with an identity diagonal).
//
// Replaces the TPU kernels of incubator_predictionio_tpu/ops/pallas_kernels.py:
// _gauss_jordan_kernel (:76, batch on lanes, k <= 96) and
// _gauss_jordan_kernel_wide (:86, manual DMA, 96 < k <= 128). The TPU split
// exists only because of VMEM; here the split follows what holds a system:
// registers for k <= 32, shared memory above.
//
// Algorithm (the reference's _gj_eliminate, :37): no pivoting, because every
// system is SPD by construction (normal equations plus a lambda*I ridge). At
// step j every row i != j subtracts f_i = A[i][j] / A[j][j] times row j; row j
// itself is left as it is (its factor is masked to zero). After k steps A is
// diagonal and one divide by the diagonal gives x. Columns < j of row j are
// already zero, so step j only touches columns > j (and b): about k^3 / 2
// multiply-adds per system, where the reference does k^3.
//
// What bounds it: HBM traffic is one read of A and b and one write of x,
// (k^2 + 2k) * 4 bytes per system, against about k^3 float32 operations. At
// k = 32 the bytes bound it (0.18 ms for 138,493 systems on an H100 SXM); at
// k = 128 the arithmetic does.
//
// k <= 32 (the ALS main path, rank 32): one warp owns one system (or a group
// of 8 or 16 lanes owns one, 4 or 2 systems per warp). Lane i holds row i in
// registers and the pivot row travels by warp shuffles: no shared memory and
// no block barrier, so the k steps cost only the shuffles and the FMAs, and
// each lane's load is its row, contiguous, in 16-byte pieces. Systems past n
// are identity rows in registers and are never stored (no batch padding).
//
// 32 < k <= 128: one block owns one system, an augmented [k][k + 1] matrix in
// dynamic shared memory (66,560 bytes at k = 128, above the 48 KB default, so
// the launch opts in with cudaFuncAttributeMaxDynamicSharedMemorySize). The
// row stride k + 1 is odd, so a column read across a warp has no bank
// conflicts. Each step first copies column j's factors into a shared buffer
// and synchronises, then updates: column j would otherwise be overwritten
// while other threads still read it. This kernel is latency-bound (2k block
// barriers per system); tensor-core (wgmma) and TMA variants, and fusing the
// gather and gram into the solve, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kWarpKernelThreads = 128;  // 4 warps per block
constexpr int kThreadsX = 32;            // shared-memory kernel: one row, warp-wide
constexpr int kThreadsY = 8;             // shared-memory kernel: rows at once
constexpr unsigned kFullMask = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarpKernelThreads)
gauss_jordan_warp_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ x, long long n) {
  constexpr int kGroup = K <= 8 ? 8 : (K <= 16 ? 16 : 32);  // lanes per system
  constexpr int kSysPerWarp = 32 / kGroup;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int i = lane % kGroup;  // the row this lane holds
  const long long sys = warp * kSysPerWarp + lane / kGroup;
  const bool active = i < K && sys < n;

  float row[K];
  float rhs = 0.0f;
  if (active) {
    const float4* src = reinterpret_cast<const float4*>(a + (sys * K + i) * K);
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
      const float4 v = __ldg(src + c);
      row[4 * c] = v.x;
      row[4 * c + 1] = v.y;
      row[4 * c + 2] = v.z;
      row[4 * c + 3] = v.w;
    }
    rhs = __ldg(b + sys * K + i);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) row[c] = (c == i) ? 1.0f : 0.0f;
  }

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float inv = 1.0f / __shfl_sync(kFullMask, row[j], j, kGroup);
    const float f = (i == j) ? 0.0f : row[j] * inv;
#pragma unroll
    for (int c = j + 1; c < K; ++c) {
      row[c] -= f * __shfl_sync(kFullMask, row[c], j, kGroup);
    }
    rhs -= f * __shfl_sync(kFullMask, rhs, j, kGroup);
  }

  if (active) {
    float diag = row[0];
#pragma unroll
    for (int c = 1; c < K; ++c) {
      if (i == c) diag = row[c];
    }
    x[sys * K + i] = rhs / diag;
  }
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gauss_jordan_smem_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  const int ld = k + 1;         // augmented row: A[i][0..k), then b[i]
  float* m = smem;              // [k][ld]
  float* f = smem + k * ld;     // [k] elimination factors of a step
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;
  const long long sys = blockIdx.x;
  const float* a_sys = a + sys * k * k;
  const float* b_sys = b + sys * k;

  for (int e = tid; e < k * k; e += nthreads) {
    const int r = e / k;
    m[r * ld + (e - r * k)] = a_sys[e];  // consecutive threads, consecutive A
  }
  for (int r = tid; r < k; r += nthreads) m[r * ld + k] = b_sys[r];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    // Column j's factors first, into f: the update below overwrites column j.
    const float inv = 1.0f / m[j * ld + j];
    for (int r = tid; r < k; r += nthreads) {
      f[r] = (r == j) ? 0.0f : m[r * ld + j] * inv;
    }
    __syncthreads();
    const float* pivot_row = m + j * ld;
    for (int r = threadIdx.y; r < k; r += kThreadsY) {
      if (r == j) continue;  // row j is finished as it is
      const float fr = f[r];
      float* row = m + r * ld;
      for (int c = j + 1 + threadIdx.x; c <= k; c += kThreadsX) {
        row[c] -= fr * pivot_row[c];
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < k; r += nthreads) {
    x[sys * k + r] = m[r * ld + k] / m[r * ld + r];
  }
}

template <int K>
cudaError_t launch_warp(const float* a, const float* b, float* x, long long n,
                        cudaStream_t stream) {
  constexpr int kSysPerBlock = (kWarpKernelThreads / 32) * (K <= 8 ? 4 : (K <= 16 ? 2 : 1));
  const long long blocks = (n + kSysPerBlock - 1) / kSysPerBlock;
  gauss_jordan_warp_kernel<K><<<static_cast<unsigned>(blocks),
                                kWarpKernelThreads, 0, stream>>>(a, b, x, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; a, b, x must be 16-byte aligned and contiguous.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take (k not a multiple of 8 in [8, 128], n < 0).
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
    default: break;
  }
  const size_t smem = static_cast<size_t>(k) * (k + 2) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gauss_jordan_smem_kernel<<<static_cast<unsigned>(n), dim3(kThreadsX, kThreadsY),
                             smem, s>>>(fa, fb, fx, k);
  return cudaGetLastError();
}

}  // extern "C"
