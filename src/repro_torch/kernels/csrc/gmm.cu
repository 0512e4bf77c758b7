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
// group_of_tile [M / bm] need not be sorted. Every variant gives a block
// rows that divide bm, so no block straddles two groups and each block
// reads its one group id itself (the TPU's scalar prefetch); the K axis,
// a sequential grid axis with a VMEM accumulator on the TPU, is a loop
// inside the block; no split-K and no atomics, so every output is written
// once and two launches are bitwise equal.
//
// What bounds it on an H100 at the MoE layers' widths (K and N of 512 to
// 1024): bf16 in, bytes and tensor-core operations nearly alike (about 295
// flop/byte ridge; the granite gate product needs 0.17 ms for its bytes and
// 0.15 ms for its operations at the published peaks); float32 in,
// operations on the CUDA cores (67 TFLOP/s, TF32 is not used). The
// variants, chosen by the wrapper from type and shape before the launch
// (repro_torch/kernels/gmm/ops.py::gmm_variant):
//
//   * `wgmma` (bf16 in, bm % 64 == 0, K and N multiples of 8). A persistent
//     block per SM walks output tiles of BR x 256 (BR = 128, or 64 when bm
//     is not a multiple of 128), row tile by row tile, so the blocks in
//     flight share x rows and expert weights in L2. One producer thread
//     keeps a ring of 4 shared-memory stages filled by TMA, each stage a
//     BR x 64 x tile and a 64 x 256 w tile (four 64 x 64 boxes) in the
//     128-byte swizzle, completion on an mbarrier; one consumer warpgroup
//     per 64 rows runs two wgmma.mma_async m64n128k16 per 16 k on each
//     stage, keeps one k-step in flight, and frees the stage on a second
//     mbarrier. While the consumers write a tile out, the producer already
//     fills the ring with the next tile's stages. w is described to TMA as
//     the 3-D tensor [E, K, N], so a K tail reads zeros and never the next
//     expert's rows, and it is read N-major through the descriptor's
//     transpose bit: no transposed copy of w is written. The float32
//     accumulator stays in registers and is rounded once, at the write.
//     TMA's row strides must be multiples of 16 bytes, hence K and N
//     multiples of 8.
//   * `regblock` (float32 in, bm % 64 == 0, K and N multiples of 4). A
//     block of 2 BR threads owns a BR x 128 output tile (BR = 128 or 64)
//     and each thread an 8 x 8 register patch (one block an SM at
//     BR = 128: two would cap a thread at 128 registers, and the patch
//     then spills); 16-deep k tiles are staged by cp.async into two
//     shared-memory buffers, the x tile transposed (4-byte copies) so that
//     a thread reads its 8 a and 8 b values as four float4 loads for 64
//     FMAs. One FMA chain per output over k in order.
//   * `simt` (any other shape: bm = 8, 16, 32, ...; K or N ragged). The
//     first kernel of the port: a block of BR (the largest of 64, 32, 16, 8
//     dividing bm) x 128 outputs, 16-deep float32 tiles staged in shared
//     memory, a (BR / 16) x 8 patch a thread, one FMA chain per output.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/gmm/ops.py. The TMA
// descriptor encoder (hopper.cuh) is looked up through the runtime
// (cudaGetDriverEntryPointByVersion), so the library needs no -lcuda.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// simt: any shape, CUDA cores.

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
gmm_simt_kernel(const Tin* __restrict__ x,        // [M, K]
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
int launch_simt_rows(const void* x, const void* w, const void* group, void* out,
                     int M, int K, int N, int bm, void* stream) {
  dim3 grid(M / BR, (N + kCols - 1) / kCols);
  gmm_simt_kernel<Tin, Tout, BR><<<grid, Shape<BR>::kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const int*>(group), static_cast<Tout*>(out), K, N, bm);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_simt(const void* x, const void* w, const void* group, void* out, int M,
                int K, int N, int bm, void* stream) {
  // The largest block height that divides bm: a block never spans two groups.
  if (bm % 64 == 0) return launch_simt_rows<Tin, Tout, 64>(x, w, group, out, M, K, N, bm, stream);
  if (bm % 32 == 0) return launch_simt_rows<Tin, Tout, 32>(x, w, group, out, M, K, N, bm, stream);
  if (bm % 16 == 0) return launch_simt_rows<Tin, Tout, 16>(x, w, group, out, M, K, N, bm, stream);
  return launch_simt_rows<Tin, Tout, 8>(x, w, group, out, M, K, N, bm, stream);
}

// ---------------------------------------------------------------------------
// regblock: float32 in, CUDA cores, 8 x 8 outputs a thread.

constexpr int kRbCols = 128;  // output columns per block
constexpr int kRbDepth = 16;  // k-depth of one stage

template <int BR>
struct RbShape {
  static constexpr int kThreads = 2 * BR;      // 16 column lanes x BR / 8 row lanes
  static constexpr int kXStride = BR + 4;      // transposed x tile row, float4-aligned
  static constexpr int kXFloats = kRbDepth * kXStride;
  static constexpr int kWFloats = kRbDepth * kRbCols;
};

// Stage k-tile [k0, k0 + 16) of the block's x rows (transposed) and of its
// expert's w columns into one buffer; reads past K or N are zero fills.
template <int BR>
__device__ __forceinline__ void rb_stage(float* s_x, float* s_w, const float* x_b,
                                         const float* w_g, int k0, int K, int N, int col0,
                                         int tid) {
  using S = RbShape<BR>;
#pragma unroll
  for (int it = 0; it < BR * kRbDepth / S::kThreads; ++it) {
    const int i = tid + it * S::kThreads;
    const int r = i / kRbDepth;
    const int kk = i % kRbDepth;
    const bool ok = k0 + kk < K;
    cp_async_4(s_x + kk * S::kXStride + r, ok ? x_b + (long long)r * K + k0 + kk : x_b,
               ok ? 4 : 0);
  }
#pragma unroll
  for (int it = 0; it < kRbDepth * kRbCols / 4 / S::kThreads; ++it) {
    const int i = tid + it * S::kThreads;
    const int kk = i / (kRbCols / 4);
    const int c = 4 * (i % (kRbCols / 4));
    const bool ok = k0 + kk < K && col0 + c < N;
    cp_async_16(s_w + kk * kRbCols + c, ok ? w_g + (long long)(k0 + kk) * N + col0 + c : w_g,
                ok ? 16 : 0);
  }
}

template <typename Tout>
__device__ __forceinline__ void store4(Tout* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename Tout, int BR>
__global__ void __launch_bounds__(RbShape<BR>::kThreads, 1)
gmm_regblock_kernel(const float* __restrict__ x,      // [M, K]
                    const float* __restrict__ w,      // [E, K, N]
                    const int* __restrict__ group,    // [M / bm]
                    Tout* __restrict__ out,           // [M, N]
                    int K, int N, int bm) {
  using S = RbShape<BR>;
  __shared__ __align__(16) float s_x[2][S::kXFloats];
  __shared__ __align__(16) float s_w[2][S::kWFloats];

  const int row0 = blockIdx.x * BR;
  const int col0 = blockIdx.y * kRbCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4 tx .. 4 tx + 3 and 64 + the same
  const int ty = tid / 16;  // rows 4 ty .. 4 ty + 3 and BR / 2 + the same
  const float* x_b = x + (long long)row0 * K;
  const float* w_g = w + (long long)group[row0 / bm] * K * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (K + kRbDepth - 1) / kRbDepth;
  rb_stage<BR>(s_x[0], s_w[0], x_b, w_g, 0, K, N, col0, tid);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      rb_stage<BR>(s_x[(t + 1) & 1], s_w[(t + 1) & 1], x_b, w_g, (t + 1) * kRbDepth, K, N,
                   col0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = s_x[t & 1];
    const float* sw = s_w[t & 1];
#pragma unroll
    for (int kk = 0; kk < kRbDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sx + kk * S::kXStride + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sx + kk * S::kXStride + BR / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(sw + kk * kRbCols + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(sw + kk * kRbCols + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled two steps on
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : BR / 2) + 4 * ty + (i & 3);
    Tout* o = out + (long long)(row0 + r) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (c < N) store4<Tout>(o + c, v);  // N % 4 == 0: all four or none
    }
  }
}

template <typename Tout, int BR>
int launch_regblock_rows(const void* x, const void* w, const void* group, void* out, int M,
                         int K, int N, int bm, void* stream) {
  dim3 grid(M / BR, (N + kRbCols - 1) / kRbCols);
  gmm_regblock_kernel<Tout, BR><<<grid, RbShape<BR>::kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(group), static_cast<Tout*>(out), K, N, bm);
  return (int)cudaGetLastError();
}

template <typename Tout>
int launch_regblock(const void* x, const void* w, const void* group, void* out, int M,
                    int K, int N, int bm, void* stream) {
  if (bm % 64 || K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  if (bm % 128 == 0)
    return launch_regblock_rows<Tout, 128>(x, w, group, out, M, K, N, bm, stream);
  return launch_regblock_rows<Tout, 64>(x, w, group, out, M, K, N, bm, stream);
}

// ---------------------------------------------------------------------------
// wgmma: bf16 in, tensor cores, TMA ring, persistent blocks.

constexpr int kWgNB = 2;       // m64n128k16 products a warpgroup issues per k16
constexpr int kWgCols = 128 * kWgNB;  // output columns per tile
constexpr int kWgDepth = 64;   // k-depth of one stage: 128 bytes of bf16
constexpr int kWgStages = 4;   // 48 KiB a stage at BR = 128
constexpr int kWBoxBytes = kWgDepth * 64 * 2;  // one 64 x 64 w box: 8 KiB
constexpr int kWBoxes = kWgCols / 64;          // w boxes a stage

template <typename Tout>
__device__ __forceinline__ void store2(Tout* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// NWG consumer warpgroups of 64 rows each (BR = 64 NWG) and one producer
// warpgroup, of which one thread issues the TMA loads.
template <typename Tout, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,  // [M, K] bf16
                 const __grid_constant__ CUtensorMap w_map,  // [E, K, N] bf16
                 const int* __restrict__ group,              // [M / bm]
                 Tout* __restrict__ out,                     // [M, N]
                 int M, int K, int N, int bm) {
  constexpr int BR = 64 * NWG;
  constexpr int kABytes = BR * kWgDepth * 2;
  constexpr int kBBytes = kWBoxes * kWBoxBytes;
  constexpr unsigned kStageBytes = kABytes + kBBytes;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that grid.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_a = smem;                             // [stages][BR rows][64 k]
  unsigned char* s_b = smem + kWgStages * kABytes;       // [stages][boxes][64 k][64 n]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + kWgStages * kBBytes);
  uint64_t* empty = full + kWgStages;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_ct = (N + kWgCols - 1) / kWgCols;
  const int tiles = (M / BR) * n_ct;
  const int nk = (K + kWgDepth - 1) / kWgDepth;

  if (wg == 0) {
    // Producer: one thread keeps the ring full, tile after tile.
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / n_ct) * BR;
      const int col0 = (tile % n_ct) * kWgCols;
      const int g = group[row0 / bm];
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(s_a + s * kABytes, &x_map, &full[s], kt * kWgDepth, row0);
        unsigned char* b = s_b + s * kBBytes;
        for (int c = 0; c < kWBoxes; ++c)
          tma_load_3d(b + c * kWBoxBytes, &w_map, &full[s], col0 + 64 * c, kt * kWgDepth, g);
      }
    }
    return;
  }

  // Consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 of each tile.
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / n_ct) * BR;
    const int col0 = (tile % n_ct) * kWgCols;
    float d[kWgNB][64];
#pragma unroll
    for (int nb = 0; nb < kWgNB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[nb][i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      const unsigned char* a = s_a + s * kABytes + (wg - 1) * 64 * 128;
      const unsigned char* b = s_b + s * kBBytes;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kWgDepth / 16; ++k16) {
        // A: K-major, 8-row groups 1024 bytes apart, 16 k = 32 bytes on.
        // B: N-major, 64-column boxes 8 KiB apart (leading), 8-k groups
        // 1024 bytes apart (stride), 16 k = 2048 bytes on.
#pragma unroll
        for (int nb = 0; nb < kWgNB; ++nb)
          wgmma_m64n128k16<1>(d[nb], smem_desc(a + 32 * k16, 16, 1024),
                           smem_desc(b + 2 * nb * kWBoxBytes + 2048 * k16, kWBoxBytes, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(it - 1) % kWgStages]);

    // Accumulator layout of m64nNk16: d[4 j + 2 i + c] is row
    // 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c.
    const int r = row0 + (wg - 1) * 64 + 16 * warp + lane / 4;
#pragma unroll
    for (int nb = 0; nb < kWgNB; ++nb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 128 * nb + 8 * j + 2 * (lane % 4);
        if (c < N) {  // N % 8 == 0: both columns or neither
          store2<Tout>(out + (long long)r * N + c, d[nb][4 * j], d[nb][4 * j + 1]);
          store2<Tout>(out + (long long)(r + 8) * N + c, d[nb][4 * j + 2], d[nb][4 * j + 3]);
        }
      }
    }
  }
}

template <typename Tout, int NWG>
int launch_wgmma_rows(const void* x, const void* w, const void* group, void* out, int M,
                      int K, int N, int E, int bm, void* stream) {
  constexpr int BR = 64 * NWG;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kWgDepth, BR};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, kWgDepth, 1};
  if (!make_map(&x_map, x, 2, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&w_map, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int smem = kWgStages * (BR * kWgDepth * 2 + kWBoxes * kWBoxBytes) + 1024 +
                   2 * kWgStages * (int)sizeof(uint64_t);
  auto kernel = gmm_wgmma_kernel<Tout, NWG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M / BR) * ((N + kWgCols - 1) / kWgCols);
  const int blocks = tiles < sms ? tiles : sms;
  kernel<<<blocks, 128 * (NWG + 1), smem, (cudaStream_t)stream>>>(
      x_map, w_map, static_cast<const int*>(group), static_cast<Tout*>(out), M, K, N, bm);
  return (int)cudaGetLastError();
}

template <typename Tout>
int launch_wgmma(const void* x, const void* w, const void* group, void* out, int M, int K,
                 int N, int E, int bm, void* stream) {
  if (bm % 64 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (bm % 128 == 0)
    return launch_wgmma_rows<Tout, 2>(x, w, group, out, M, K, N, E, bm, stream);
  return launch_wgmma_rows<Tout, 1>(x, w, group, out, M, K, N, E, bm, stream);
}

bool bad_shape(int M, int bm) { return bm <= 0 || bm % 8 != 0 || M % bm != 0; }

}  // namespace

extern "C" {

#define GMM_ENTRY(NAME, CALL)                                                            \
  int NAME(const void* x, const void* w, const void* group, void* out, int M, int K,     \
           int N, int E, int bm, void* stream) {                                         \
    if (M == 0 || N == 0) return (int)cudaSuccess;                                       \
    if (bad_shape(M, bm)) return (int)cudaErrorInvalidValue;                             \
    (void)E;                                                                             \
    return CALL;                                                                         \
  }

GMM_ENTRY(gmm_simt_f32_f32, (launch_simt<float, float>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_simt_f32_bf16,
          (launch_simt<float, __nv_bfloat16>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_simt_bf16_f32,
          (launch_simt<__nv_bfloat16, float>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_simt_bf16_bf16,
          (launch_simt<__nv_bfloat16, __nv_bfloat16>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_regblock_f32_f32, (launch_regblock<float>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_regblock_f32_bf16,
          (launch_regblock<__nv_bfloat16>(x, w, group, out, M, K, N, bm, stream)))
GMM_ENTRY(gmm_wgmma_bf16_f32, (launch_wgmma<float>(x, w, group, out, M, K, N, E, bm, stream)))
GMM_ENTRY(gmm_wgmma_bf16_bf16,
          (launch_wgmma<__nv_bfloat16>(x, w, group, out, M, K, N, E, bm, stream)))

#undef GMM_ENTRY

REPRO_ERROR_STRING(gmm)

}  // extern "C"
