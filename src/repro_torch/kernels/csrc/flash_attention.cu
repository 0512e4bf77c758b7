// Flash attention (forward) for Hopper (sm_90a): causal and/or one-sided
// sliding-window attention with an online softmax.
//
// Replaces the TPU kernel `repro/kernels/attn/kernel.py::flash_attention`
// (body `_attn_kernel`): for q [BH, S, D] and k, v [BH, T, D],
//
//     o[b, s] = softmax_t(q[b, s] . k[b, t] / sqrt(D), masked) @ v[b]
//
// where key t is visible from query s when (not causal or s >= t) and
// (window <= 0 or s - t <= window). Keys are indexed from 0 for any T; with
// causal off, later keys stay visible. The output is in q's type.
//
// The kernel keeps the reference's semantics exactly where they are subtle:
//   * the q axis is cut into the caller's bq tiles and the key axis into bkv
//     tiles; a (bq x bkv) tile with no visible pair is skipped by the same
//     test as the reference (causal: q_start + bq - 1 >= k_start; window:
//     q_start <= k_start + bkv - 1 + window), and the visited tiles are
//     walked in ascending order;
//   * masked scores are the finite -1e30, not -inf. A row whose first
//     visited tile is fully masked takes p = exp(0) = 1 junk there, which
//     alpha = exp(-1e30 - m) = 0 wipes exactly once a visible key arrives;
//     with -inf the same row would be NaN;
//   * the scale 1/sqrt(D) multiplies the float32 scores after the product;
//     l sums the float32 p, while the PV product takes p rounded to v's type
//     (so bf16 rounds there); the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations. A visible (query, key) pair costs
// 4 D flops against a few bytes, and prefill attention over thousands of
// keys is far above the ridge of either the float32 CUDA cores or the bf16
// tensor cores. This first kernel runs on the CUDA cores for both types
// (67 TFLOP/s float32 FMA), so the design keeps them fed and keeps the score
// matrix out of device memory:
//   * a thread block owns 32 rows of one bq tile (a bq tile of 128 rows is
//     four blocks; each row's softmax is its own, so splitting rows changes
//     no result) and walks that tile's visited kv tiles inside the block;
//   * q rows stay in shared memory, transposed, for the whole walk; keys and
//     values are staged in chunks of 64 rows; scores of one kv tile stay in
//     shared memory; m, l and the scale factor live in shared memory per row
//     and the output accumulator in registers (4 rows x ceil(D / 16) columns
//     a thread), so device memory sees q, k, v read and o written, nothing
//     else;
//   * each thread computes a 4 x 4 patch of scores and a 4 x ceil(D / 16)
//     patch of the PV product, so one shared-memory load feeds several FMAs.
// Any D up to 128 is taken (columns past D are masked; 80 is not a power of
// two). Blocks are issued from the last q tile to the first, so the longest
// causal rows start first. Numerics: every sum is a fixed chain (FMA over d
// or over keys in order; the row max and row sum over four lanes by a fixed
// shuffle pattern), no atomics, so two launches are bitwise equal. Tensor
// cores for bf16 are later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/attn/ops.py.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;            // q rows per block
constexpr int kRowLanes = 8;         // a thread's rows: ty + 8 i
constexpr int kRowsPerThread = kRows / kRowLanes;
constexpr int kKeys = 64;            // keys per staged chunk
constexpr int kKeysPerThread = kKeys / 16;  // a thread's keys: tx + 16 j
constexpr int kLanesPerRow = kThreads / kRows;  // softmax: 4 lanes a row
constexpr int kMaxHeadDim = 128;
constexpr int kRowStride = kRows + 1;  // transposed q tile
constexpr int kKeyStride = kKeys + 1;  // transposed k chunk
constexpr float kMaskValue = -1e30f;

// Row stride of the score tile: bkv rounded up to 32, plus 4, so the four
// lanes of each of a warp's eight rows fall on distinct banks.
__host__ __device__ inline int score_stride(int bkv) { return (bkv + 31) / 32 * 32 + 4; }

__host__ __device__ inline int kv_floats(int D, int DC) {
  const int k_chunk = D * kKeyStride;
  const int v_chunk = kKeys * 16 * DC;
  return k_chunk > v_chunk ? k_chunk : v_chunk;
}

// DC = ceil(D / 16): output columns a thread owns (tx + 16 j).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q,  // [BH, S, D]
            const T* __restrict__ k,  // [BH, T, D]
            const T* __restrict__ v,  // [BH, T, D]
            T* __restrict__ o,        // [BH, S, D]
            int BH, int S, int Tk, int D, int bq, int bkv, int causal,
            int window, float scale) {
  constexpr int DP = 16 * DC;  // padded row of a staged v chunk
  extern __shared__ float smem[];
  float* s_q = smem;                          // [D, kRowStride]
  float* s_kv = s_q + D * kRowStride;         // k chunk [D, kKeyStride] or v chunk [kKeys, DP]
  float* s_p = s_kv + kv_floats(D, DC);       // [kRows, score_stride(bkv)]
  const int sp = score_stride(bkv);
  float* s_m = s_p + kRows * sp;              // [kRows]
  float* s_l = s_m + kRows;                   // [kRows]
  float* s_alpha = s_l + kRows;               // [kRows]

  const int nsub = (bq + kRows - 1) / kRows;
  const int nqt = S / bq;
  const int per_tile = BH * nsub;
  const int qt = nqt - 1 - blockIdx.x / per_tile;  // last q tiles first
  const int bh = (blockIdx.x % per_tile) / nsub;
  const int sub = blockIdx.x % nsub;
  const int q_start = qt * bq;                // the bq tile's first row
  const int r_base = q_start + sub * kRows;   // this block's first row
  const int nr = min(kRows, bq - sub * kRows);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* q_b = q + ((long long)bh * S + r_base) * D;
  const T* k_b = k + (long long)bh * Tk * D;
  const T* v_b = v + (long long)bh * Tk * D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    s_q[d * kRowStride + r] = r < nr ? to_f32(q_b[(long long)r * D + d]) : 0.0f;
  }
  if (tid < kRows) {
    s_m[tid] = kMaskValue;
    s_l[tid] = 0.0f;
  }
  float acc[kRowsPerThread][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;

  const int nkt = Tk / bkv;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_start = kt * bkv;
    // The reference's tile skip: is any (q, k) pair of this tile visible?
    if (causal && q_start + bq - 1 < k_start) continue;
    if (window > 0 && q_start > k_start + bkv - 1 + window) continue;

    // Scores of the tile, masked, into s_p.
    for (int c0 = 0; c0 < bkv; c0 += kKeys) {
      const int nk = min(kKeys, bkv - c0);
      __syncthreads();  // s_kv is free
      const T* k_c = k_b + (long long)(k_start + c0) * D;
      for (int i = tid; i < kKeys * D; i += kThreads) {
        const int c = i / D;
        const int d = i - c * D;
        s_kv[d * kKeyStride + c] = c < nk ? to_f32(k_c[(long long)c * D + d]) : 0.0f;
      }
      __syncthreads();
      float sc[kRowsPerThread][kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) sc[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float a[kRowsPerThread];
        float b[kKeysPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) a[i] = s_q[d * kRowStride + ty + kRowLanes * i];
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) b[j] = s_kv[d * kKeyStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kKeysPerThread; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = ty + kRowLanes * i;
        const int row = r_base + r;
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          const int c = tx + 16 * j;
          if (c < nk) {
            const int col = k_start + c0 + c;
            const bool visible = (!causal || row >= col) && (window <= 0 || row - col <= window);
            s_p[r * sp + c0 + c] = visible ? sc[i][j] * scale : kMaskValue;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: four lanes a row, fixed shuffle pattern.
    {
      const int r = tid / kLanesPerRow;
      const int part = tid % kLanesPerRow;
      float* p_row = s_p + r * sp;
      float mx = kMaskValue;
      for (int c = part; c < bkv; c += kLanesPerRow) mx = fmaxf(mx, p_row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = part; c < bkv; c += kLanesPerRow) {
        const float p = expf(p_row[c] - m_new);
        sum += p;
        p_row[c] = to_f32(from_f32<T>(p));  // p in v's type for the PV product
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[r] = alpha;
        s_l[r] = alpha * s_l[r] + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, v staged in chunks.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float alpha = s_alpha[ty + kRowLanes * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    for (int c0 = 0; c0 < bkv; c0 += kKeys) {
      const int nk = min(kKeys, bkv - c0);
      const T* v_c = v_b + (long long)(k_start + c0) * D;
      for (int i = tid; i < nk * DP; i += kThreads) {
        const int c = i / DP;
        const int d = i - c * DP;
        s_kv[i] = d < D ? to_f32(v_c[(long long)c * D + d]) : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        float p[kRowsPerThread];
        float b[DC];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) p[i] = s_p[(ty + kRowLanes * i) * sp + c0 + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) b[j] = s_kv[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  __syncthreads();

  T* o_b = o + ((long long)bh * S + r_base) * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + kRowLanes * i;
    if (r >= nr) continue;
    const float denom = fmaxf(s_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o_b[(long long)r * D + c] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* o, int BH,
              int S, int Tk, int D, int bq, int bkv, int causal, int window,
              float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)D * kRowStride + kv_floats(D, DC) +
                                       (size_t)kRows * score_stride(bkv) + 3 * kRows);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KiB only by opting in
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)BH * (S / bq) * ((bq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_kernel<T, DC><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH, S, Tk, D, bq, bkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int Tk, int D, int bq, int bkv, int causal, int window, float scale,
           void* stream) {
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxHeadDim || bq <= 0 || bkv <= 0 || S % bq || Tk % bkv)
    return (int)cudaErrorInvalidValue;
#define ATTN_DC(N) \
  case N:          \
    return launch_dc<T, N>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
  switch ((D + 15) / 16) {
    ATTN_DC(1)
    ATTN_DC(2)
    ATTN_DC(3)
    ATTN_DC(4)
    ATTN_DC(5)
    ATTN_DC(6)
    ATTN_DC(7)
    ATTN_DC(8)
  }
#undef ATTN_DC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int Tk, int D, int bq, int bkv,
                        int causal, int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int BH, int S, int Tk, int D, int bq, int bkv,
                         int causal, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window,
                               scale, stream);
}

REPRO_ERROR_STRING(flash_attention)

}  // extern "C"
