// Block-ELL SpMM for Hopper (sm_90a), stacked over compute units.
//
// Replaces the TPU kernel `repro/kernels/spmv/kernel.py::bell_spmm` (body
// `_spmm_kernel`): for every unit u and block-row r,
//
//     out[u, r] = sum over the unit's tiles t with tile_row[u, t] == r of
//                 tiles[u, t] @ xsrc[u or 0, tile_src[u, t]]
//
// with tiles [U, T, bm, bn], xsrc [Ux, S, bn, B] (Ux == 1 means every unit
// reads the same source: the replicated exchange) and out [U, NRB, bm, B]
// float32. One launch serves every unit; the caller sums over units.
//
// What bounds it on an H100: device-memory bytes at small B, and at B = 64,
// for the first kernel, issuing shared-memory loads. Each tile element is
// used for B multiply-adds, so at B = 8 the kernel does about one flop per
// byte read (16x16 float32 tiles: 2*256*8 flops against 1 KiB of tile), far
// below the ~20 flop/byte ridge of the float32 CUDA cores; at B = 64 the
// bytes still bound it in principle, but a kernel that reads both operands
// of every FMA from shared memory is held by the load issue rate first. Two
// variants, chosen by the wrapper from type and shape before the launch
// (repro_torch/kernels/spmv/ops.py::spmm_variant):
//
//   * `stream` (bm = 8, 16, 24 or 32, bn = 8, 16 or 32, any B). A block
//     owns one unit and a span of consecutive block-rows [r0, r1), computed
//     once on the host (ops.py::row_spans) so that spans hold about the
//     same number of tiles and up to 64 output rows; a row is never split
//     between blocks. The span's tiles are one contiguous run
//     tiles[u, row_ptr[u, r0] : row_ptr[u, r1]], and stage k of the block
//     holds the k-th tile of each of its rows, so all rows work at once. Stages stream through a
//     two-stage ring in shared memory with 16-byte cp.async, each tile with
//     the x block tile_src names for it; the copy of stage k + 1 (a tile for
//     every row) runs under stage k's FMAs, one __syncthreads a stage.
//     Against the load issue rate, a thread owns a patch of PR rows x PC
//     columns of one block-row (4 x 4 at B >= 16 with 4 | B, 1 x 1 or 1 x 4
//     below) and reads its tile rows and x rows as 4-wide vectors: at
//     B = 64, 8 shared loads feed 64 FMAs. Tile rows are padded by 16 bytes
//     in shared memory, so the rows a warp reads fall on distinct banks.
//     Registers are capped at 64 a thread, so four 256-thread blocks share
//     an SM and one's copies hide under the others' FMAs. At small B the
//     spans make a block's outputs fill its threads (64 output rows).
//   * `simt` (every other shape: bm up to kMaxOutputs, a float32 tile and
//     x block within kMaxSmemBytes; the first kernel of the port): a block
//     per (unit, block-row, column chunk), each tile and its x block staged
//     synchronously, then read scalar by scalar from shared memory.
//
// In both, each tile is read from device memory once per column chunk, each
// output element is written exactly once (a row with no tiles as 0), no
// atomics, and loops are bounded by the real tile counts (the per-unit row
// pointer), so padding tiles are never read.
//
// Numerics, the one invariant every variant keeps: float32 FMA on the CUDA
// cores (no tensor cores, so no TF32), and each output (m, b) is a single
// fmaf chain from 0.0f over its row's tiles in index order and, inside each
// tile, n = 0 .. bn-1. No split over n, no split of a row across blocks.
// Nothing in that chain depends on B, the column chunk, the patch or the
// variant, so column b of the result is bitwise the same whatever the batch
// width and whichever variant ran. The float16 instantiations read float16
// tiles and x and accumulate in the same float32 chain.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/spmv/ops.py.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
// Outputs each thread owns at most; with kMaxThreads this caps a block at
// 1024 outputs (bm x column chunk).
constexpr int kOutPerThread = 4;
constexpr int kMaxOutputs = kMaxThreads * kOutPerThread;
// Largest dynamic shared memory a launch can ask for: a 128x128 float32 tile
// plus a 128-row x block of kMaxOutputs / 128 columns, with room to spare.
constexpr int kMaxSmemBytes = 96 * 1024;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bell_spmm_kernel(const T* __restrict__ tiles,       // [U, T, bm, bn]
                 const int* __restrict__ row_ptr,   // [U, NRB + 1]
                 const int* __restrict__ tile_src,  // [U, T]
                 const T* __restrict__ xsrc,        // [Ux, S, bn, B]
                 float* __restrict__ out,           // [U, NRB, bm, B]
                 int ntiles, int nrb, int bm, int bn, int batch,
                 long long x_unit_stride, int chunk) {
  extern __shared__ float smem[];
  float* s_tile = smem;            // [bm, bn]
  float* s_x = smem + bm * bn;     // [bn, nb]

  const int r = blockIdx.x;
  const int u = blockIdx.y;
  const int b0 = blockIdx.z * chunk;
  const int nb = min(chunk, batch - b0);
  const int nout = bm * nb;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  const int* ptr = row_ptr + (long long)u * (nrb + 1);
  const int beg = ptr[r];
  const int end = ptr[r + 1];
  const long long tile_elems = (long long)bm * bn;
  const T* tiles_u = tiles + (long long)u * ntiles * tile_elems;
  const int* src_u = tile_src + (long long)u * ntiles;
  const T* x_u = xsrc + (long long)u * x_unit_stride;

  float acc[kOutPerThread];
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.0f;

  for (int t = beg; t < end; ++t) {
    const T* tile = tiles_u + (long long)t * tile_elems;
    const T* xs = x_u + (long long)src_u[t] * bn * batch + b0;
    __syncthreads();  // the previous tile's products are done
    for (int i = tid; i < bm * bn; i += nthreads) s_tile[i] = to_f32(tile[i]);
    for (int i = tid; i < bn * nb; i += nthreads) {
      const int n = i / nb;
      const int b = i - n * nb;
      s_x[i] = to_f32(xs[(long long)n * batch + b]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int o = tid + k * nthreads;
      if (o < nout) {
        const int m = o / nb;
        const int b = o - m * nb;
        const float* a_row = s_tile + m * bn;
        float a = acc[k];
        for (int n = 0; n < bn; ++n) a = fmaf(a_row[n], s_x[n * nb + b], a);
        acc[k] = a;
      }
    }
  }

  float* out_r = out + ((long long)u * nrb + r) * bm * batch + b0;
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int o = tid + k * nthreads;
    if (o < nout) {
      const int m = o / nb;
      const int b = o - m * nb;
      out_r[(long long)m * batch + b] = acc[k];
    }
  }
}

template <typename T>
int launch_simt(const void* tiles, const void* row_ptr, const void* tile_src,
           const void* xsrc, void* out, int units, int ntiles, int nrb, int bm,
           int bn, int batch, long long x_unit_stride, void* stream) {
  if (units == 0 || nrb == 0) return (int)cudaSuccess;
  if (bm > kMaxOutputs) return (int)cudaErrorInvalidValue;  // rows past it unwritten
  // Columns per block: as many as keep bm * chunk within kMaxOutputs.
  int chunk = kMaxOutputs / bm;
  if (chunk < 1) chunk = 1;
  if (chunk > batch) chunk = batch;
  const int nout = bm * chunk;
  int threads = ((nout + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = sizeof(float) * ((size_t)bm * bn + (size_t)bn * chunk);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KiB only by opting in
    cudaError_t e = cudaFuncSetAttribute(
        bell_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nrb, units, (batch + chunk - 1) / chunk);
  bell_spmm_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(row_ptr),
      static_cast<const int*>(tile_src), static_cast<const T*>(xsrc),
      static_cast<float*>(out), ntiles, nrb, bm, bn, batch, x_unit_stride,
      chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// stream: bm a multiple of 8 up to 32, bn in {8, 16, 32}; a block per (row
// span, column chunk).

constexpr int kSpanOutRows = 64;  // output rows a span holds at most (ops.py::SPAN_OUT_ROWS)
constexpr int kSpanRowsMax = kSpanOutRows / 8;  // block-rows of a span at most (bm >= 8)
constexpr int kStages = 2;  // ring depth: the copy of stage s + 1 runs under stage s's FMAs
constexpr int kStageBytesMax = 48 * 1024;  // one stage's tiles and x blocks at most
constexpr int kWideCols = 64;  // columns a block takes with the 4 x 4 patch
constexpr int kStreamMaxThreads = 256;

// Four consecutive values as float32 (8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage k of a span: the k-th tile of each of its rows that has one (slot
// j for row r0 + j), and the x block (columns [b0, b0 + cb)) each of those
// tiles reads. A slot's tile is bm rows of kTRow values (the row plus 16
// bytes of padding); the x blocks follow the slots' tiles, [BN, cb] each.
// x is copied in 16-byte pieces when its rows allow it (the whole block
// when the chunk is all of B), else value by value.
template <typename T, int BN>
__device__ __forceinline__ void stage_copy(T* buf, const T* tiles_u, const int* src_u,
                                           const T* x_u, const int* s_ptr, int nrows, int k,
                                           int bm, int slots, int batch, int cb, int b0,
                                           int tid, int nthreads) {
  constexpr int kE16 = 16 / sizeof(T);  // values in 16 bytes
  constexpr int kRowP = BN / kE16;      // 16-byte pieces of a tile row
  constexpr int kTRow = BN + kE16;
  const int tile_e = bm * kTRow;
  const int xe = BN * cb;
  T* s_x = buf + slots * tile_e;
  const int tp = bm * kRowP;
  for (int i = tid; i < nrows * tp; i += nthreads) {
    const int j = i / tp;
    const int t = s_ptr[j] + k;
    if (t >= s_ptr[j + 1]) continue;
    const int p = i - j * tp;
    const int row = p / kRowP;
    const int c = (p - row * kRowP) * kE16;
    cp_async_16(buf + j * tile_e + row * kTRow + c,
                tiles_u + ((long long)t * bm + row) * BN + c, 16);
  }
  if (cb == batch) {  // the whole [BN, B] block is contiguous
    const int xp = xe / kE16;
    for (int i = tid; i < nrows * xp; i += nthreads) {
      const int j = i / xp;
      const int t = s_ptr[j] + k;
      if (t >= s_ptr[j + 1]) continue;
      const int p = i - j * xp;
      cp_async_16(s_x + j * xe + p * kE16, x_u + (long long)src_u[t] * BN * batch + p * kE16,
                  16);
    }
  } else if (batch % kE16 == 0 && cb % kE16 == 0) {
    const int rp = cb / kE16;
    const int xp = BN * rp;
    for (int i = tid; i < nrows * xp; i += nthreads) {
      const int j = i / xp;
      const int t = s_ptr[j] + k;
      if (t >= s_ptr[j + 1]) continue;
      const int p = i - j * xp;
      const int row = p / rp;
      const int c = (p - row * rp) * kE16;
      const bool ok = b0 + c < batch;
      const T* src = x_u + ((long long)src_u[t] * BN + row) * batch + b0 + c;
      cp_async_16(s_x + j * xe + row * cb + c, ok ? src : x_u, ok ? 16 : 0);
    }
  } else {  // rows not 16-byte aligned: plain loads, visible after the stage's barrier
    for (int i = tid; i < nrows * xe; i += nthreads) {
      const int j = i / xe;
      const int t = s_ptr[j] + k;
      if (t >= s_ptr[j + 1]) continue;
      const int p = i - j * xe;
      const int row = p / cb;
      const int c = p - row * cb;
      if (b0 + c < batch)
        s_x[j * xe + p] = x_u[((long long)src_u[t] * BN + row) * batch + b0 + c];
    }
  }
}

template <typename T, int BN, int PR, int PC>
__global__ void __launch_bounds__(kStreamMaxThreads, 4)
bell_spmm_stream_kernel(const T* __restrict__ tiles,       // [U, T, bm, BN]
                        const int* __restrict__ row_ptr,   // [U, NRB + 1]
                        const int* __restrict__ tile_src,  // [U, T]
                        const T* __restrict__ xsrc,        // [Ux, S, BN, B]
                        const int* __restrict__ spans,     // [NS, 3]: unit, r0, r1
                        float* __restrict__ out,           // [U, NRB, bm, B]
                        int ntiles, int nrb, int bm, int batch, long long x_unit_stride,
                        int cb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_ptr[kSpanRowsMax + 1];  // the span's row pointer
  constexpr int kE16 = 16 / sizeof(T);
  constexpr int kTRow = BN + kE16;
  const int slots = kSpanOutRows / bm;
  const int tile_e = bm * kTRow;
  const int stage_e = slots * (tile_e + BN * cb);

  const int u = spans[3 * blockIdx.x];
  const int r0 = spans[3 * blockIdx.x + 1];
  const int nrows = spans[3 * blockIdx.x + 2] - r0;
  const int b0 = blockIdx.y * cb;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // This thread's patch: rows m0 .. m0 + PR - 1 of block-row r0 + j,
  // columns b0 + c0 .. b0 + c0 + PC - 1.
  const int col_groups = cb / PC;
  const int per_row = (bm / PR) * col_groups;
  const int j = tid / per_row;
  const int rem = tid - j * per_row;
  const int m0 = (rem / col_groups) * PR;
  const int c0 = (rem % col_groups) * PC;
  const bool active = j < nrows && b0 + c0 < batch;

  const int* ptr = row_ptr + (long long)u * (nrb + 1) + r0;
  if (tid <= nrows) s_ptr[tid] = ptr[tid];
  __syncthreads();
  int nst = 0;  // stages: the span's longest run of tiles
  for (int i = 0; i < nrows; ++i) nst = max(nst, s_ptr[i + 1] - s_ptr[i]);
  const int run = active ? s_ptr[j + 1] - s_ptr[j] : 0;
  const T* tiles_u = tiles + (long long)u * ntiles * bm * BN;
  const int* src_u = tile_src + (long long)u * ntiles;
  const T* x_u = xsrc + (long long)u * x_unit_stride;

  float acc[PR][PC];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[i][k] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst)
      stage_copy<T, BN>(smem + s * stage_e, tiles_u, src_u, x_u, s_ptr, nrows, s, bm, slots,
                        batch, cb, b0, tid, nthreads);
    cp_async_commit();  // empty groups too, so the count below holds
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();  // ... for every thread, and stage s - 1 is consumed
    const int sn = s + kStages - 1;
    if (sn < nst)
      stage_copy<T, BN>(smem + (sn % kStages) * stage_e, tiles_u, src_u, x_u, s_ptr, nrows, sn,
                        bm, slots, batch, cb, b0, tid, nthreads);
    cp_async_commit();
    if (s >= run) continue;  // this row's s-th tile, if it has one: tiles in index order
    const T* buf = smem + (s % kStages) * stage_e;
    const T* s_t = buf + j * tile_e + m0 * kTRow;
    const T* s_x = buf + slots * tile_e + j * BN * cb + c0;
#pragma unroll
    for (int n = 0; n < BN; n += 4) {
      float av[PR][4];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float4 v = load4(s_t + i * kTRow + n);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float xv[PC];
        if constexpr (PC == 4) {
          const float4 v = load4(s_x + (n + q) * cb);
          xv[0] = v.x;
          xv[1] = v.y;
          xv[2] = v.z;
          xv[3] = v.w;
        } else {
          xv[0] = to_f32(s_x[(n + q) * cb]);
        }
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[i][k] = fmaf(av[i][q], xv[k], acc[i][k]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (!active) return;
  float* o = out + (((long long)u * nrb + r0 + j) * bm + m0) * batch + b0 + c0;
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    if constexpr (PC == 4) {
      *reinterpret_cast<float4*>(o + (long long)i * batch) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      o[(long long)i * batch] = acc[i][0];
    }
  }
}

template <typename T, int BN, int PR, int PC>
int launch_stream_shape(const void* tiles, const void* row_ptr, const void* tile_src,
                        const void* xsrc, const void* spans, void* out, int nspans, int ntiles,
                        int nrb, int bm, int batch, long long x_unit_stride, void* stream) {
  // Columns a block takes: as many as keep it within kStreamMaxThreads and
  // a stage within kStageBytesMax.
  const int slots = kSpanOutRows / bm;
  const int tile_bytes = bm * (BN + 16 / (int)sizeof(T)) * (int)sizeof(T);
  int cb = min(batch, PR * PC == 16 ? kWideCols : 4 * PR * PC);
  while (cb > PC && slots * (tile_bytes + BN * cb * (int)sizeof(T)) > kStageBytesMax)
    cb = max(PC, cb / 2 / PC * PC);
  const int threads = (kSpanOutRows / PR) * (cb / PC);
  const size_t smem = (size_t)kStages * slots * (tile_bytes + BN * cb * sizeof(T));
  // Above 48 KiB (the span's row pointer included) only by opting in.
  if (smem + sizeof(int) * (kSpanRowsMax + 1) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bell_spmm_stream_kernel<T, BN, PR, PC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nspans, (batch + cb - 1) / cb);
  bell_spmm_stream_kernel<T, BN, PR, PC><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(row_ptr),
      static_cast<const int*>(tile_src), static_cast<const T*>(xsrc),
      static_cast<const int*>(spans), static_cast<float*>(out), ntiles, nrb, bm, batch,
      x_unit_stride, cb);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_stream_bn(const void* tiles, const void* row_ptr, const void* tile_src,
                     const void* xsrc, const void* spans, void* out, int nspans, int ntiles,
                     int nrb, int bm, int batch, long long x_unit_stride, void* stream) {
  // The patch: 4 rows from B = 16 on, 4 columns when 4 | B.
#define STREAM_PATCH(PR, PC)                                                             \
  return launch_stream_shape<T, BN, PR, PC>(tiles, row_ptr, tile_src, xsrc, spans, out,  \
                                            nspans, ntiles, nrb, bm, batch,              \
                                            x_unit_stride, stream);
  if (batch >= 16) {
    if (batch % 4 == 0) STREAM_PATCH(4, 4)
    STREAM_PATCH(4, 1)
  }
  if (batch % 4 == 0) STREAM_PATCH(1, 4)
  STREAM_PATCH(1, 1)
#undef STREAM_PATCH
}

template <typename T>
int launch_stream(const void* tiles, const void* row_ptr, const void* tile_src,
                  const void* xsrc, const void* spans, void* out, int nspans, int ntiles,
                  int nrb, int bm, int bn, int batch, long long x_unit_stride, void* stream) {
  if (nspans == 0) return (int)cudaSuccess;
  if (bm % 8 || bm > 32 || batch < 1) return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 8:
      return launch_stream_bn<T, 8>(tiles, row_ptr, tile_src, xsrc, spans, out, nspans,
                                    ntiles, nrb, bm, batch, x_unit_stride, stream);
    case 16:
      return launch_stream_bn<T, 16>(tiles, row_ptr, tile_src, xsrc, spans, out, nspans,
                                     ntiles, nrb, bm, batch, x_unit_stride, stream);
    case 32:
      return launch_stream_bn<T, 32>(tiles, row_ptr, tile_src, xsrc, spans, out, nspans,
                                     ntiles, nrb, bm, batch, x_unit_stride, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#define SIMT_ENTRY(NAME, T)                                                                \
  int NAME(const void* tiles, const void* row_ptr, const void* tile_src, const void* xsrc,  \
           void* out, int units, int ntiles, int nrb, int bm, int bn, int batch,            \
           long long x_unit_stride, void* stream) {                                        \
    return launch_simt<T>(tiles, row_ptr, tile_src, xsrc, out, units, ntiles, nrb, bm, bn,  \
                          batch, x_unit_stride, stream);                                    \
  }
SIMT_ENTRY(bell_spmm_simt_f32, float)
SIMT_ENTRY(bell_spmm_simt_f16, __half)
#undef SIMT_ENTRY

#define STREAM_ENTRY(NAME, T)                                                               \
  int NAME(const void* tiles, const void* row_ptr, const void* tile_src, const void* xsrc,  \
           const void* spans, void* out, int nspans, int ntiles, int nrb, int bm, int bn,   \
           int batch, long long x_unit_stride, void* stream) {                              \
    return launch_stream<T>(tiles, row_ptr, tile_src, xsrc, spans, out, nspans, ntiles,     \
                            nrb, bm, bn, batch, x_unit_stride, stream);                     \
  }
STREAM_ENTRY(bell_spmm_stream_f32, float)
STREAM_ENTRY(bell_spmm_stream_f16, __half)
#undef STREAM_ENTRY

REPRO_ERROR_STRING(bell_spmm)

}  // extern "C"
