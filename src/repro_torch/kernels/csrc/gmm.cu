// Grouped matmul (GMM) for Hopper (sm_90a): the expert products of a
// dropless mixture-of-experts layer.
//
// Replaces the TPU kernel `repro/kernels/gmm/kernel.py::gmm` (body
// `_gmm_kernel`): with x [M, K] holding tokens sorted by expert, each
// expert's group padded to a multiple of the row tile bm, and w [E, K, N]
// the stacked expert weights,
//
//     out[bm-row tile i] = x[tile i] @ w[group_of_tile[i]]
//
// accumulated in float32 and rounded to the output type once, at the write.
// group_of_tile [M / bm] need not be sorted.
//
// What bounds it on an H100: operations. At the MoE layers' widths (K and N
// of 512 to 1024) every x element is used N times and every weight element
// once per row of its group, far above the ~20 flop/byte ridge of the
// float32 CUDA cores (and the ~295 of the bf16 tensor cores). This first
// kernel runs on the CUDA cores for both input types, so its ceiling is the
// 67 TFLOP/s of float32 FMA; the design aims at keeping those units fed:
//   * a thread block owns one BR x 128 output tile, with BR (64, 32, 16 or 8
//     rows) the largest that divides bm, so a block never straddles two bm
//     tiles and reads its one group id itself (the TPU's scalar prefetch);
//   * the K axis, a sequential grid axis with a VMEM accumulator on the TPU,
//     is a loop inside the block: x and w tiles of depth 16 are staged in
//     shared memory as float32, and each thread keeps a register patch of
//     (BR / 16) x 8 outputs, so one shared-memory load feeds several FMAs;
//   * no atomics and no split-K: each output is written once.
// Numerics: one FMA chain per output over k = 0 .. K-1 in order, so two
// launches are bitwise equal. bf16 inputs are widened exactly with
// __bfloat162float; a bf16 output is rounded once with __float2bfloat16_rn.
// Tensor cores (mma.sync / wgmma) for bf16 are later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/gmm/ops.py.

#include "common.cuh"

namespace {

constexpr int kCols = 128;  // output columns per block
constexpr int kColsPerThread = kCols / 16;
constexpr int kDepth = 16;  // k-depth of one staged tile

// Threads of a block with BR rows: 16 columns lanes x min(BR, 16) row lanes.
template <int BR>
struct Shape {
  static constexpr int kRowLanes = BR < 16 ? BR : 16;
  static constexpr int kRowsPerThread = BR / kRowLanes;
  static constexpr int kThreads = 16 * kRowLanes;
};

template <typename Tin, typename Tout, int BR>
__global__ void __launch_bounds__(Shape<BR>::kThreads)
gmm_kernel(const Tin* __restrict__ x,        // [M, K]
           const Tin* __restrict__ w,        // [E, K, N]
           const int* __restrict__ group,    // [M / bm]
           Tout* __restrict__ out,           // [M, N]
           int K, int N, int bm) {
  constexpr int TY = Shape<BR>::kRowLanes;
  constexpr int RT = Shape<BR>::kRowsPerThread;
  constexpr int NT = Shape<BR>::kThreads;
  constexpr int BRP = BR + 1;  // padded stride of the transposed x tile
  __shared__ float s_x[kDepth * BRP];    // [kDepth, BR]: x tile, transposed
  __shared__ float s_w[kDepth * kCols];  // [kDepth, kCols]

  const int row0 = blockIdx.x * BR;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const Tin* x_b = x + (long long)row0 * K;
  const Tin* w_g = w + (long long)group[row0 / bm] * K * N;

  float acc[RT][kColsPerThread];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int i = tid; i < BR * kDepth; i += NT) {
      const int r = i / kDepth;
      const int kk = i - r * kDepth;
      s_x[kk * BRP + r] = k0 + kk < K ? to_f32(x_b[(long long)r * K + k0 + kk]) : 0.0f;
    }
    for (int i = tid; i < kDepth * kCols; i += NT) {
      const int kk = i / kCols;
      const int c = i - kk * kCols;
      s_w[i] = (k0 + kk < K && col0 + c < N)
                   ? to_f32(w_g[(long long)(k0 + kk) * N + col0 + c])
                   : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[RT];
      float b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = s_x[kk * BRP + ty + TY * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = s_w[kk * kCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    Tout* o = out + (long long)(row0 + ty + TY * i) * N;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) o[c] = from_f32<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout, int BR>
int launch_rows(const void* x, const void* w, const void* group, void* out,
                int M, int K, int N, int bm, void* stream) {
  dim3 grid(M / BR, (N + kCols - 1) / kCols);
  gmm_kernel<Tin, Tout, BR><<<grid, Shape<BR>::kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const int*>(group), static_cast<Tout*>(out), K, N, bm);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* w, const void* group, void* out, int M,
           int K, int N, int bm, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (bm <= 0 || bm % 8 != 0 || M % bm != 0) return (int)cudaErrorInvalidValue;
  // The largest block height that divides bm: a block never spans two groups.
  if (bm % 64 == 0) return launch_rows<Tin, Tout, 64>(x, w, group, out, M, K, N, bm, stream);
  if (bm % 32 == 0) return launch_rows<Tin, Tout, 32>(x, w, group, out, M, K, N, bm, stream);
  if (bm % 16 == 0) return launch_rows<Tin, Tout, 16>(x, w, group, out, M, K, N, bm, stream);
  return launch_rows<Tin, Tout, 8>(x, w, group, out, M, K, N, bm, stream);
}

}  // namespace

extern "C" {

#define GMM_ENTRY(NAME, TIN, TOUT)                                            \
  int NAME(const void* x, const void* w, const void* group, void* out, int M, \
           int K, int N, int bm, void* stream) {                              \
    return launch<TIN, TOUT>(x, w, group, out, M, K, N, bm, stream);          \
  }

GMM_ENTRY(gmm_f32_f32, float, float)
GMM_ENTRY(gmm_f32_bf16, float, __nv_bfloat16)
GMM_ENTRY(gmm_bf16_f32, __nv_bfloat16, float)
GMM_ENTRY(gmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef GMM_ENTRY

REPRO_ERROR_STRING(gmm)

}  // extern "C"
