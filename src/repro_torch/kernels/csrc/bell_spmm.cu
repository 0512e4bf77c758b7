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
// What bounds it on an H100: device-memory bytes. Each tile element is used
// for B multiply-adds, so at B = 8 the kernel does about one flop per byte
// read (16x16 float32 tiles: 2*256*8 flops against 1 KiB of tile), far below
// the ~20 flop/byte ridge of the float32 CUDA cores. The design keeps the
// bytes at what the function must move:
//   * each tile is read from device memory exactly once, by one thread block,
//     with coalesced loads into shared memory; the x block it multiplies is
//     staged next to it, so every thread's inner loop reads shared memory only;
//   * each output element is written exactly once: a thread block owns one
//     (unit, block-row, column chunk) and accumulates in registers, so there
//     are no atomics and no second pass over the output;
//   * loops are bounded by the real tile counts (the per-unit row pointer),
//     so padding tiles are never read.
// Numerics: float32 FMA accumulation on the CUDA cores (no tensor cores, so no
// TF32). The order of summation is fixed: for output (m, b) a thread walks its
// row's tiles in index order and, inside each tile, n = 0 .. bn-1. Nothing in
// that order depends on B or on the column chunking, so column b of the result
// is bitwise the same whatever the batch width. The float16 instantiation
// reads float16 tiles and x and accumulates in float32.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/spmv/ops.py.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
// Outputs each thread owns at most; with kMaxThreads this caps a block at
// 1024 outputs (bm x column chunk).
constexpr int kOutPerThread = 4;
constexpr int kMaxOutputs = kMaxThreads * kOutPerThread;
// Largest dynamic shared memory a launch can ask for: a 128x128 float32 tile
// plus a 128-row x block of kMaxOutputs / 128 columns, with room to spare.
constexpr int kMaxSmemBytes = 96 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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
int launch(const void* tiles, const void* row_ptr, const void* tile_src,
           const void* xsrc, void* out, int units, int ntiles, int nrb, int bm,
           int bn, int batch, long long x_unit_stride, void* stream) {
  if (units == 0 || nrb == 0) return (int)cudaSuccess;
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

}  // namespace

extern "C" {

int bell_spmm_f32(const void* tiles, const void* row_ptr, const void* tile_src,
                  const void* xsrc, void* out, int units, int ntiles, int nrb,
                  int bm, int bn, int batch, long long x_unit_stride,
                  void* stream) {
  return launch<float>(tiles, row_ptr, tile_src, xsrc, out, units, ntiles, nrb,
                       bm, bn, batch, x_unit_stride, stream);
}

int bell_spmm_f16(const void* tiles, const void* row_ptr, const void* tile_src,
                  const void* xsrc, void* out, int units, int ntiles, int nrb,
                  int bm, int bn, int batch, long long x_unit_stride,
                  void* stream) {
  return launch<__half>(tiles, row_ptr, tile_src, xsrc, out, units, ntiles,
                        nrb, bm, bn, batch, x_unit_stride, stream);
}

const char* bell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
