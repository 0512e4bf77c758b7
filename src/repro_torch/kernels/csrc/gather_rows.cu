// Gather rows of a stack by an index: out[s] = src[index[s]], a zero row
// where index[s] < 0.
//
// Replaces no TPU kernel: the JAX package's exchange is XLA's gathers. On one
// device the port's selective exchange is one such gather of the padded x
// blocks [NCB, bn, B] into every unit's workspace [Lr, W', bn, B], its index
// composed when the step is built (repro_torch/pmvc/dist.py::_Exchange); a
// slot of a zero block is -1. PyTorch's gather (index_select, advanced
// indexing and embedding all reach vectorized_gather_kernel) gives each index
// its own thread block, so at HPCG's 64^3 (262,144 rows of 64 bytes) it is
// paced by block scheduling, 0.16 ms whatever the row width. Here every
// thread moves one 16-byte vector (4 bytes, or 1, where the rows or the
// pointers are not 16-byte aligned), so the copy runs at the card's bytes:
// 16 MiB written at B = 1, 5 us at 3.35 TB/s. The copy is of bits, so any
// element type gathers, and the result is bitwise the plain version's
// (repro_torch/kernels/spmv/gather.py::gather_rows_plain).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

// `row` vectors of V a row; threads stride over slots * row vectors.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const V* __restrict__ src, const long long* __restrict__ index,
                       V* __restrict__ out, long long slots, long long row) {
  const long long total = slots * row;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += step) {
    const long long s = t / row;
    const long long i = __ldg(index + s);
    V v{};
    if (i >= 0) v = __ldg(src + i * row + (t - s * row));
    out[t] = v;
  }
}

template <typename V>
int launch(const void* src, const void* index, void* out, long long slots, long long row,
           void* stream) {
  const long long blocks = (slots * row + kThreads - 1) / kThreads;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(src), static_cast<const long long*>(index), static_cast<V*>(out),
      slots, row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src: rows of row_bytes bytes, contiguous; index: [slots] int64, each -1
// or a row of src; out: [slots] rows, contiguous.
int gather_rows(const void* src, const void* index, void* out, long long slots,
                long long row_bytes, void* stream) {
  if (slots == 0 || row_bytes == 0) return 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && bases % 16 == 0)
    return launch<uint4>(src, index, out, slots, row_bytes / 16, stream);
  if (row_bytes % 4 == 0 && bases % 4 == 0)
    return launch<unsigned>(src, index, out, slots, row_bytes / 4, stream);
  return launch<unsigned char>(src, index, out, slots, row_bytes, stream);
}

REPRO_ERROR_STRING(gather_rows)

}  // extern "C"
