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
// Every variant keeps the reference's semantics exactly where they are
// subtle:
//   * the q axis is cut into the caller's bq tiles and the key axis into bkv
//     tiles; a (bq x bkv) tile with no visible pair is skipped by the same
//     test as the reference (causal: q_start + bq - 1 >= k_start; window:
//     q_start <= k_start + bkv - 1 + window), and the visited tiles are
//     walked in ascending order. The visit set is the caller's tile set and
//     no finer one: every row of a bq tile walks the tile's whole set, since
//     for a row that sees no key the visited set is the result (the mean of
//     v over the visited keys, or 0 when no tile is visited);
//   * masked scores are the finite -1e30, not -inf. A row whose first
//     visited keys are all masked takes p = exp(0) = 1 junk there, which
//     alpha = exp(-1e30 - m) = 0 wipes exactly once a visible key arrives;
//     with -inf the same row would be NaN;
//   * the scale 1/sqrt(D) multiplies the float32 scores after the product;
//     l sums the float32 p, while the PV product takes p rounded to v's type
//     (so bf16 rounds there); the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: operations. A visible (query, key) pair costs
// 4 D flops against a few bytes, and prefill attention over thousands of
// keys is far above the ridge of either the float32 CUDA cores or the bf16
// tensor cores. The variants, chosen by the wrapper from type and shape
// before the launch (repro_torch/kernels/attn/ops.py::attention_variant):
//
//   * `wgmma` (bf16, D a multiple of 16 up to 128, bq a multiple of 64, bkv
//     of 16), the Hopper design. A block owns 128 rows of one bq tile
//     where 128 divides bq (else 64): one producer warpgroup and one
//     consumer warpgroup per 64 rows, registers moved to the consumers by
//     setmaxnreg. The producer's first thread loads the q rows once by TMA
//     and then keeps a ring of two stages of 128-key K and V chunks in
//     flight (3-D tensor maps over [BH, T, D], boxes of 64 columns in the
//     128-byte swizzle, columns past D and rows past T read as zeros),
//     each chunk staged once per block, completion on mbarriers (K and V
//     apart, so the scores start before V lands). Each consumer warpgroup
//     runs S = Q K^T as wgmma.mma_async m64n128k16 with both operands in
//     shared memory (K rows are the K-major B operand), the online softmax
//     in registers, then O += P V as wgmma m64nDk16 with P, rounded to
//     bf16, as the register A operand (the score accumulator's layout is
//     the A fragment's) and V read N-major through the transpose bit; it
//     frees the stage on an mbarrier. Both warpgroups walk the bq tile's
//     whole key range from its first key, so a 128-key chunk may start off
//     a 128 multiple and run past the range: keys past it get p = 0
//     exactly (-inf, not -1e30: they are not visited). The copy of chunk
//     j + 1 overlaps the products and softmax of chunk j; the softmax of
//     one warpgroup overlaps the other's products as the scheduler
//     interleaves them. FlashAttention-3's overlap of chunk j's softmax
//     with chunk j - 1's PV product inside a warpgroup, with and without
//     the ping-pong of the two warpgroups, gave the same bits but ran
//     slower on an H100 at the granite and h2o shapes (PERF.md §6).
//   * `mma` (bf16, D, bq and bkv multiples of 16, D <= 128), in the manner
//     of FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, float32
//     accumulated). A warp owns 16 q rows and a block up to 4 warps (64
//     rows) of one bq tile, so a bq = 128 tile is two blocks. The visited
//     tiles of a bq tile are one contiguous key range (both tests are
//     monotone in k_start); its keys and values are staged in 64-key chunks
//     by a double-buffered cp.async ring and read with ldmatrix (ldmatrix
//     .trans for V). The q fragments stay in registers for the whole walk,
//     the scores of a chunk in the accumulator registers, the online
//     softmax in registers (quad shuffles for the row max), and p enters
//     the PV product as the bf16 A operand straight from those registers.
//     Chunks are a coarser grouping of the same ascending walk; the -1e30
//     arithmetic above holds for any grouping.
//   * `regblock` (float32, D a multiple of 16 up to 128, bq and bkv
//     multiples of 64), on the CUDA cores (67 TFLOP/s float32 FMA). A block
//     owns a whole bq tile where 128 rows divide it (else 64 rows), so each
//     key and value chunk is staged once per q tile. q is staged once;
//     keys and values arrive in 32-key chunks through a double-buffered
//     cp.async ring, rows padded to D + 4 floats so the eight rows a
//     quarter-warp reads at one d fall on distinct banks. A thread owns 8
//     rows x 4 keys of a chunk's scores in registers (8 + 4 float4 shared
//     loads feed 128 FMAs), the row max and sum go over the row's 8 lanes by
//     a fixed xor shuffle, and p crosses shared memory once, transposed, for
//     the PV product, where a thread owns its 8 rows x 2 columns of each
//     16-column strip of D (five strips at D = 80). Two barriers a chunk.
//   * `simt` (float32 and bf16 shapes the other variants do not take), the
//     first kernel of the port, on the CUDA cores:
//     a block owns 32 rows of one bq tile (a bq tile of 128 rows is four
//     blocks) and walks that tile's visited kv tiles; q rows stay in shared
//     memory, transposed; keys and values are staged in chunks of 64 rows;
//     scores of one kv tile stay in shared memory; m, l and the scale factor
//     live in shared memory per row and the output accumulator in registers
//     (4 rows x ceil(D / 16) columns a thread); each thread computes a 4 x 4
//     patch of scores and a 4 x ceil(D / 16) patch of the PV product. Any D
//     up to 128 is taken (columns past D are masked).
//
// All issue blocks from the last q tile to the first, so the longest causal
// rows start first, and write each output once. Numerics: every sum is a
// fixed chain (fixed mma and FMA order, the row max and row sum over a
// row's lanes by a fixed shuffle pattern), no atomics, so two launches are
// bitwise equal. The wgmma, mma and regblock variants take each exponent
// of the exact difference s - m wherever a key may be masked (regblock
// everywhere), so a row with no visible key keeps p = 1.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes by repro_torch/kernels/attn/ops.py. The wgmma
// variant's TMA descriptors are encoded on the host by
// cuTensorMapEncodeTiled, looked up through the runtime (hopper.cuh).

#include "hopper.cuh"

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
int launch_simt_dc(const void* q, const void* k, const void* v, void* o, int BH,
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
int launch_simt(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int Tk, int D, int bq, int bkv, int causal, int window, float scale,
           void* stream) {
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxHeadDim || bq <= 0 || bkv <= 0 || S % bq || Tk % bkv)
    return (int)cudaErrorInvalidValue;
#define ATTN_DC(N) \
  case N:          \
    return launch_simt_dc<T, N>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
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

// ---------------------------------------------------------------------------
// mma: bf16 on the tensor cores (mma.sync.m16n8k16), 16 q rows a warp.

constexpr int kMmaWarps = 4;  // warps (16 rows each) a block at most
constexpr int kMmaKeys = 64;  // keys per staged chunk
constexpr int kMmaStages = 2;  // chunks of k and v in the cp.async ring (double buffer)
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulated.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Stage `rows` rows of D bf16 (a row stride of D + 8 in shared memory, so
// the eight rows of an ldmatrix fall on distinct banks) with cp.async.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int tid,
                                           int nthreads) {
  constexpr int kPieces = D / 8;  // 16-byte pieces a row
  for (int i = tid; i < rows * kPieces; i += nthreads) {
    const int r = i / kPieces;
    const int c = 8 * (i % kPieces);
    cp_async_16(dst + r * (D + 8) + c, src + (long long)r * D + c, 16);
  }
}

// Up to D = 80 four blocks share an SM (128 registers a thread, which
// measured faster at h2o-danube's D = 80 than three blocks without the
// cap); wider heads keep their registers, as the cap would spill them.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps, D <= 80 ? 4 : 1)
attn_mma_kernel(const bf16* __restrict__ q,  // [BH, S, D]
                const bf16* __restrict__ k,  // [BH, T, D]
                const bf16* __restrict__ v,  // [BH, T, D]
                bf16* __restrict__ o,        // [BH, S, D]
                int BH, int S, int Tk, int bq, int bkv, int causal, int window,
                float scale) {
  constexpr int DS = D + 8;       // shared-memory row stride
  constexpr int KD = D / 16;      // k-steps of QK^T, pairs of n8 tiles of PV
  constexpr int NT = kMmaKeys / 8;  // n8 tiles of a chunk's scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [64][DS]
  bf16* s_k = s_q + 16 * kMmaWarps * DS;          // [kMmaStages][kMmaKeys][DS]
  bf16* s_v = s_k + kMmaStages * kMmaKeys * DS;   // [kMmaStages][kMmaKeys][DS]

  const int nthreads = blockDim.x;
  const int rows_per_block = 16 * (nthreads / 32);
  const int nsub = (bq + rows_per_block - 1) / rows_per_block;
  const int nqt = S / bq;
  const int per_tile = BH * nsub;
  const int qt = nqt - 1 - blockIdx.x / per_tile;  // last q tiles first
  const int bh = (blockIdx.x % per_tile) / nsub;
  const int sub = blockIdx.x % nsub;
  const int q_start = qt * bq;
  const int r_base = q_start + sub * rows_per_block;
  const int nr = min(rows_per_block, bq - sub * rows_per_block);  // a multiple of 16

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int qd = lane % 4;  // fragment column pair
  const bool active = 16 * warp < nr;
  const int w_row = r_base + 16 * warp;  // the warp's first row

  // The visited kv tiles of this bq tile: one contiguous range.
  const int nkt = Tk / bkv;
  int kt_lo = 0, kt_hi = nkt - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + bq - 1) / bkv);
  if (window > 0 && q_start - window - bkv + 1 > 0)
    kt_lo = (q_start - window - bkv + 1 + bkv - 1) / bkv;
  const int key_lo = kt_lo * bkv;
  const int key_hi = (kt_hi + 1) * bkv;
  const int nchunks = key_hi > key_lo ? (key_hi - key_lo + kMmaKeys - 1) / kMmaKeys : 0;

  const bf16* q_b = q + ((long long)bh * S + r_base) * D;
  const bf16* k_b = k + (long long)bh * Tk * D;
  const bf16* v_b = v + (long long)bh * Tk * D;

  float acc[2 * KD][4];  // output: n8 tiles over D
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};  // rows g and g + 8
  float l[2] = {0.0f, 0.0f};              // this lane's part of the row sums
  unsigned qf[KD][4];

  if (nchunks > 0) {
    stage_rows<D>(s_q, q_b, nr, tid, nthreads);
    const int nk0 = min(kMmaKeys, key_hi - key_lo);
    stage_rows<D>(s_k, k_b + (long long)key_lo * D, nk0, tid, nthreads);
    stage_rows<D>(s_v, v_b + (long long)key_lo * D, nk0, tid, nthreads);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    const int kc0 = key_lo + ch * kMmaKeys;
    const int nk = min(kMmaKeys, key_hi - kc0);  // a multiple of 16
    if (ch + 1 < nchunks) {
      const int kn0 = kc0 + kMmaKeys;
      const int nkn = min(kMmaKeys, key_hi - kn0);
      const int buf = (ch + 1) % kMmaStages;
      stage_rows<D>(s_k + buf * kMmaKeys * DS, k_b + (long long)kn0 * D, nkn, tid, nthreads);
      stage_rows<D>(s_v + buf * kMmaKeys * DS, v_b + (long long)kn0 * D, nkn, tid, nthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* sk = s_k + (ch % kMmaStages) * kMmaKeys * DS;
      const bf16* sv = s_v + (ch % kMmaStages) * kMmaKeys * DS;
      const int mi = lane / 8;  // which 8 x 8 matrix this lane addresses
      const int ri = lane % 8;  // which of its rows
      if (ch == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldmatrix_x4(qf[kd], s_q + (16 * warp + ri + 8 * (mi & 1)) * DS + 16 * kd + 8 * (mi >> 1));
      }
      const int ntiles = nk / 8;

      // Scores: sc[n][e] is row g + 8 (e / 2), key kc0 + 8 n + 2 qd + e % 2.
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (2 * np < ntiles) {
            unsigned b[4];
            ldmatrix_x4(b, sk + (16 * np + ri + 8 * (mi >> 1)) * DS + 16 * kd + 8 * (mi & 1));
            mma_bf16(sc[2 * np], qf[kd], b[0], b[1]);
            mma_bf16(sc[2 * np + 1], qf[kd], b[2], b[3]);
          }
        }
      }

      // A chunk whose keys this warp's rows all see needs no mask, and its
      // exponent is one FMA: 2^(s scale log2e - m log2e). Elsewhere the
      // scores are scaled, masked ones set to -1e30, and the exponent is
      // taken of the exact difference s - m, so that a row with no visible
      // key yet has -1e30 - (-1e30) = 0 and p = 1, as in the reference.
      const bool all_visible = (!causal || w_row >= kc0 + nk - 1) &&
                               (window <= 0 || w_row + 15 - kc0 <= window);
      if (!all_visible) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w_row + g + 8 * (e >> 1);
            const int col = kc0 + 8 * n + 2 * qd + (e & 1);
            const bool visible = (!causal || row >= col) && (window <= 0 || row - col <= window);
            sc[n][e] = visible ? sc[n][e] * scale : kMaskValue;
          }
        }
      }
      const float to_score = all_visible ? scale : 1.0f;  // sc's units to scores

      // Online softmax in registers; a row's four lanes share m by shuffles.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < ntiles) mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * to_score);  // scale > 0 keeps the max
        const float alpha = exp2f((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        float sum = 0.0f;
        if (all_visible) {
          const float c = scale * kLog2e;
          const float off = -m_new * kLog2e;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < ntiles) {
              sc[n][2 * i] = exp2f(fmaf(sc[n][2 * i], c, off));
              sc[n][2 * i + 1] = exp2f(fmaf(sc[n][2 * i + 1], c, off));
              sum += sc[n][2 * i] + sc[n][2 * i + 1];
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < ntiles) {
              sc[n][2 * i] = exp2f((sc[n][2 * i] - m_new) * kLog2e);
              sc[n][2 * i + 1] = exp2f((sc[n][2 * i + 1] - m_new) * kLog2e);
              sum += sc[n][2 * i] + sc[n][2 * i + 1];
            }
          }
        }
        l[i] = alpha * l[i] + sum;
#pragma unroll
        for (int j = 0; j < 2 * KD; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }

      // acc += p (bf16, from the score registers) . v.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (2 * kk < ntiles) {
          const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) {
            unsigned b[4];
            ldmatrix_x4_trans(b, sv + (16 * kk + ri + 8 * (mi & 1)) * DS + 16 * dp + 8 * (mi >> 1));
            mma_bf16(acc[2 * dp], pa, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this chunk's buffer
  }

  if (!active) return;
  bf16* o_b = o + ((long long)bh * S + w_row) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lsum = l[i];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float denom = fmaxf(lsum, 1e-30f);
    bf16* orow = o_b + (long long)(g + 8 * i) * D;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * qd) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int D>
int launch_mma_d(const void* q, const void* k, const void* v, void* o, int BH, int S,
                 int Tk, int bq, int bkv, int causal, int window, float scale, void* stream) {
  const int warps = bq / 16 < kMmaWarps ? bq / 16 : kMmaWarps;
  const size_t smem =
      sizeof(bf16) * (size_t)(16 * kMmaWarps + 2 * kMmaStages * kMmaKeys) * (D + 8);
  if (smem > 48 * 1024) {  // above 48 KiB only by opting in
    cudaError_t e = cudaFuncSetAttribute(
        attn_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)BH * (S / bq) * ((bq + 16 * warps - 1) / (16 * warps));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_mma_kernel<D><<<(unsigned)blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), BH, S, Tk, bq, bkv, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk,
               int D, int bq, int bkv, int causal, int window, float scale, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxHeadDim || D % 16 || bq <= 0 || bq % 16 || bkv <= 0 || bkv % 16 ||
      S % bq || Tk % bkv)
    return (int)cudaErrorInvalidValue;
#define ATTN_MMA_D(N) \
  case N:             \
    return launch_mma_d<N>(q, k, v, o, BH, S, Tk, bq, bkv, causal, window, scale, stream);
  switch (D) {
    ATTN_MMA_D(16)
    ATTN_MMA_D(32)
    ATTN_MMA_D(48)
    ATTN_MMA_D(64)
    ATTN_MMA_D(80)
    ATTN_MMA_D(96)
    ATTN_MMA_D(112)
    ATTN_MMA_D(128)
  }
#undef ATTN_MMA_D
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on Hopper's warpgroup products, fed by TMA from a producer
// warp. A block owns BR = 64 NWG rows of one bq tile (NWG = 2 where 128
// rows divide bq): one producer warpgroup, whose first thread starts every
// copy, and NWG consumer warpgroups of 64 rows each.

constexpr int kWgKeys = 128;   // keys of a staged chunk: the n of the QK^T product
constexpr int kWgStages = 2;   // K and V chunks in the TMA ring
constexpr int kBoxBytes = 128;  // a box row: 64 bf16 columns, the 128-byte swizzle's span
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536

template <int D, int NWG>
struct WgShape {
  static constexpr int kBoxes = (D + 63) / 64;  // 64-column boxes a row
  static constexpr int kRows = 64 * NWG;        // q rows a block
  static constexpr int kQBytes = kBoxes * kRows * kBoxBytes;
  static constexpr int kKeyBoxBytes = kWgKeys * kBoxBytes;  // one box of a K or V chunk
  static constexpr int kChunkBytes = kBoxes * kKeyBoxBytes;
  static constexpr int kBarriers = 1 + 3 * kWgStages;  // q; full K, full V, empty a stage
  // One 1024-byte alignment slack: the swizzle repeats every 1024 bytes.
  static constexpr int kSmem = kQBytes + 2 * kWgStages * kChunkBytes + 1024 + 8 * kBarriers;
};

// Keep the compiler from moving a register's reads or writes across the
// asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,  // [BH, S, D] bf16
                  const __grid_constant__ CUtensorMap k_map,  // [BH, T, D] bf16
                  const __grid_constant__ CUtensorMap v_map,  // [BH, T, D] bf16
                  bf16* __restrict__ o,                       // [BH, S, D]
                  int BH, int S, int Tk, int bq, int bkv, int causal, int window,
                  float scale) {
  using Sh = WgShape<D, NWG>;
  constexpr int NB = Sh::kBoxes;
  constexpr int BR = Sh::kRows;
  constexpr int KD = D / 16;          // k-steps of QK^T
  constexpr int NT = kWgKeys / 8;     // n8 column groups of a chunk's scores
  constexpr int PK = kWgKeys / 16;    // k-steps of PV
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_q = smem;                                // [NB][BR rows][128 B]
  unsigned char* s_k = s_q + Sh::kQBytes;                   // [stages][NB][keys][128 B]
  unsigned char* s_v = s_k + kWgStages * Sh::kChunkBytes;   // [stages][NB][keys][128 B]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(s_v + kWgStages * Sh::kChunkBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kWgStages;
  uint64_t* empty = full_v + kWgStages;

  const int nsub = bq / BR;
  const int nqt = S / bq;
  const int per_tile = BH * nsub;
  const int qt = nqt - 1 - blockIdx.x / per_tile;  // last q tiles first
  const int bh = (blockIdx.x % per_tile) / nsub;
  const int sub = blockIdx.x % nsub;
  const int q_start = qt * bq;
  const int r_base = q_start + sub * BR;

  // The visited kv tiles of the bq tile: one contiguous key range, which
  // every row of the tile walks in 128-key chunks from its first key.
  const int nkt = Tk / bkv;
  int kt_lo = 0, kt_hi = nkt - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + bq - 1) / bkv);
  if (window > 0 && q_start - window - bkv + 1 > 0)
    kt_lo = (q_start - window - bkv + 1 + bkv - 1) / bkv;
  const int key_lo = kt_lo * bkv;
  const int key_hi = (kt_hi + 1) * bkv;
  const int nchunks = key_hi > key_lo ? (key_hi - key_lo + kWgKeys - 1) / kWgKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: q once, then K and V chunk by chunk into the ring, each
    // chunk once for the whole block. Box c holds columns 64 c .. 64 c + 63;
    // columns past D and rows past T arrive as zeros.
    if constexpr (NWG > 1) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && nchunks > 0) {
      mbar_expect_tx(full_q, Sh::kQBytes);
      for (int c = 0; c < NB; ++c)
        tma_load_3d(s_q + c * BR * kBoxBytes, &q_map, full_q, 64 * c, r_base, bh);
      for (int j = 0; j < nchunks; ++j) {
        const int s = j % kWgStages;
        if (j >= kWgStages) mbar_wait(&empty[s], ((j / kWgStages) & 1) ^ 1);
        const int key0 = key_lo + j * kWgKeys;
        mbar_expect_tx(&full_k[s], Sh::kChunkBytes);
        for (int c = 0; c < NB; ++c)
          tma_load_3d(s_k + s * Sh::kChunkBytes + c * Sh::kKeyBoxBytes, &k_map, &full_k[s],
                      64 * c, key0, bh);
        mbar_expect_tx(&full_v[s], Sh::kChunkBytes);
        for (int c = 0; c < NB; ++c)
          tma_load_3d(s_v + s * Sh::kChunkBytes + c * Sh::kKeyBoxBytes, &v_map, &full_v[s],
                      64 * c, key0, bh);
      }
    }
    return;
  }
  if constexpr (NWG > 1) regs_alloc<kConsumerRegs>();

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block;
  // warp w of it rows 16 w .. 16 w + 15, a thread rows g and g + 8 of those.
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int qd = lane % 4;
  const int w_row = r_base + 64 * cw + 16 * warp;  // the warp's first row

  float acc[D / 2];  // output: acc[4 j + 2 i + c] is row g + 8 i, column 8 j + 2 qd + c
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};  // rows g and g + 8
  float l[2] = {0.0f, 0.0f};              // this lane's part of the row sums

  const unsigned char* qa = s_q + cw * 64 * kBoxBytes;
  if (nchunks > 0) mbar_wait(full_q, 0);
  for (int j = 0; j < nchunks; ++j) {
    const int s = j % kWgStages;
    const int phase = (j / kWgStages) & 1;
    const int kc0 = key_lo + j * kWgKeys;
    const unsigned char* kb = s_k + s * Sh::kChunkBytes;
    const unsigned char* vb = s_v + s * Sh::kChunkBytes;

    // Scores: sc[4 n + 2 i + c] is row g + 8 i, key kc0 + 8 n + 2 qd + c.
    // A and B are K-major in the 128-byte swizzle: 8-row groups 1024 bytes
    // apart, 16 d = 32 bytes on within a box, boxes apart by their size.
    float sc[kWgKeys / 2];
    mbar_wait(&full_k[s], phase);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < KD; ++k16) {
      const int c = k16 / 4;
      const int off = 32 * (k16 % 4);
      wgmma_m64n128k16<0>(sc, smem_desc(qa + c * BR * kBoxBytes + off, 16, 1024),
                          smem_desc(kb + c * Sh::kKeyBoxBytes + off, 16, 1024), k16 > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // As in the mma variant: a chunk whose keys this warp's rows all see,
    // all inside the visited range, needs no mask and its exponent is one
    // FMA. Elsewhere scores are scaled, masked ones set to -1e30, keys past
    // the visited range to -inf (p = 0 exactly: they are not visited), and
    // the exponent is taken of the exact difference s - m.
    const bool all_visible = kc0 + kWgKeys <= key_hi &&
                             (!causal || w_row >= kc0 + kWgKeys - 1) &&
                             (window <= 0 || w_row + 15 - kc0 <= window);
    if (!all_visible) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w_row + g + 8 * (e >> 1);
          const int col = kc0 + 8 * n + 2 * qd + (e & 1);
          const bool visible = (!causal || row >= col) && (window <= 0 || row - col <= window);
          float& x = sc[4 * n + e];
          x = col >= key_hi ? -INFINITY : visible ? x * scale : kMaskValue;
        }
      }
    }
    const float to_score = all_visible ? scale : 1.0f;  // sc's units to scores

    // Online softmax in registers; a row's four lanes share m by shuffles.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * to_score);  // scale > 0 keeps the max
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float sum = 0.0f;
      if (all_visible) {
        const float c = scale * kLog2e;
        const float off = -m_new * kLog2e;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          sc[4 * n + 2 * i] = exp2f(fmaf(sc[4 * n + 2 * i], c, off));
          sc[4 * n + 2 * i + 1] = exp2f(fmaf(sc[4 * n + 2 * i + 1], c, off));
          sum += sc[4 * n + 2 * i] + sc[4 * n + 2 * i + 1];
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          sc[4 * n + 2 * i] = exp2f((sc[4 * n + 2 * i] - m_new) * kLog2e);
          sc[4 * n + 2 * i + 1] = exp2f((sc[4 * n + 2 * i + 1] - m_new) * kLog2e);
          sum += sc[4 * n + 2 * i] + sc[4 * n + 2 * i + 1];
        }
      }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        acc[4 * jj + 2 * i] *= alpha;
        acc[4 * jj + 2 * i + 1] *= alpha;
      }
    }

    // p rounded to bf16 in the A-operand layout, which is the score
    // accumulator's: k-step kk takes score columns 16 kk .. 16 kk + 15.
    unsigned pa[PK][4];
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // acc += p . v: V is N-major (d contiguous) in the 128-byte swizzle:
    // 16 keys = 2048 bytes on, 8-key groups 1024 bytes apart, 64-column
    // boxes apart by their size (the leading offset).
    mbar_wait(&full_v[s], phase);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      wgmma_rs_m64nNk16<D>(acc, pa[kk], smem_desc(vb + 2048 * kk, Sh::kKeyBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }

  bf16* o_b = o + ((long long)bh * S + w_row) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lsum = l[i];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float denom = fmaxf(lsum, 1e-30f);
    bf16* orow = o_b + (long long)(g + 8 * i) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * qd) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * i] / denom, acc[4 * jj + 2 * i + 1] / denom);
  }
}

template <int D, int NWG>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int Tk, int bq, int bkv, int causal, int window, float scale,
                   void* stream) {
  using Sh = WgShape<D, NWG>;
  // [BH, rows, D] as TMA sees it: D innermost, boxes of 64 columns.
  CUtensorMap q_map, k_map, v_map;
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t q_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t q_box[3] = {64, (cuuint32_t)Sh::kRows, 1};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)Tk, (cuuint64_t)BH};
  const cuuint64_t kv_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Tk * D * 2};
  const cuuint32_t kv_box[3] = {64, (cuuint32_t)kWgKeys, 1};
  if (!make_map(&q_map, q, 3, q_dims, q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&k_map, k, 3, kv_dims, kv_strides, kv_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&v_map, v, 3, kv_dims, kv_strides, kv_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = attn_wgmma_kernel<D, NWG>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)BH * (S / bq) * (bq / Sh::kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 * (NWG + 1), Sh::kSmem, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), BH, S, Tk, bq, bkv, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk,
                 int D, int bq, int bkv, int causal, int window, float scale, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxHeadDim || D % 16 || bq <= 0 || bq % 64 || bkv <= 0 || bkv % 16 ||
      S % bq || Tk % bkv)
    return (int)cudaErrorInvalidValue;
  // TMA reads from 16-byte aligned bases (the wrapper refuses others first).
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  if (Tk == 0)  // no key, no visited tile: every row is 0
    return (int)cudaMemsetAsync(o, 0, sizeof(bf16) * (size_t)BH * S * D, (cudaStream_t)stream);
  // A block takes the whole bq tile where 128 rows divide it, else 64 rows.
#define ATTN_WG_D(N)                                                                        \
  case N:                                                                                   \
    return bq % 128 == 0                                                                    \
               ? launch_wgmma_d<N, 2>(q, k, v, o, BH, S, Tk, bq, bkv, causal, window,       \
                                      scale, stream)                                        \
               : launch_wgmma_d<N, 1>(q, k, v, o, BH, S, Tk, bq, bkv, causal, window,       \
                                      scale, stream);
  switch (D) {
    ATTN_WG_D(16)
    ATTN_WG_D(32)
    ATTN_WG_D(48)
    ATTN_WG_D(64)
    ATTN_WG_D(80)
    ATTN_WG_D(96)
    ATTN_WG_D(112)
    ATTN_WG_D(128)
  }
#undef ATTN_WG_D
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// regblock: float32 on the CUDA cores. A block owns BR (64 or 128) rows of
// one bq tile; a thread owns 8 rows, 4 keys of each 32-key chunk's scores
// and 2 columns of each 16-column strip of the output.

constexpr int kRbKeys = 32;     // keys per staged chunk
constexpr int kRbRows = 8;      // q rows a thread: 8 ty .. 8 ty + 7
constexpr int kRbKeyLanes = 8;  // threads that share a row: keys tx + 8 j
constexpr int kRbKeysPerThread = kRbKeys / kRbKeyLanes;

// Stage `rows` rows of D floats at a row stride of D + 4 with cp.async.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int rows, int tid,
                                               int nthreads) {
  constexpr int kPieces = D / 4;  // 16-byte pieces a row
  for (int i = tid; i < rows * kPieces; i += nthreads) {
    const int r = i / kPieces;
    const int c = 4 * (i % kPieces);
    cp_async_16(dst + r * (D + 4) + c, src + (long long)r * D + c, 16);
  }
}

template <int D, int BR>
__global__ void __launch_bounds__(BR, 2)
attn_regblock_kernel(const float* __restrict__ q,  // [BH, S, D]
                     const float* __restrict__ k,  // [BH, T, D]
                     const float* __restrict__ v,  // [BH, T, D]
                     float* __restrict__ o,        // [BH, S, D]
                     int BH, int S, int Tk, int bq, int bkv, int causal, int window,
                     float scale) {
  // Row strides: D + 4 puts the eight rows a quarter-warp reads at one d on
  // distinct banks (D is a multiple of 16), and so does BR + 4 for p^T.
  constexpr int DS = D + 4;
  constexpr int PS = BR + 4;
  constexpr int NS = D / 16;  // 16-column strips of the output
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // [BR][DS]
  float* s_k = s_q + BR * DS;           // [2][kRbKeys][DS]
  float* s_v = s_k + 2 * kRbKeys * DS;  // [2][kRbKeys][DS]
  float* s_p = s_v + 2 * kRbKeys * DS;  // [kRbKeys][PS]: p transposed

  const int nsub = bq / BR;
  const int nqt = S / bq;
  const int per_tile = BH * nsub;
  const int qt = nqt - 1 - blockIdx.x / per_tile;  // last q tiles first
  const int bh = (blockIdx.x % per_tile) / nsub;
  const int sub = blockIdx.x % nsub;
  const int q_start = qt * bq;
  const int r_base = q_start + sub * BR;

  const int tid = threadIdx.x;
  const int tx = tid % kRbKeyLanes;
  const int ty = tid / kRbKeyLanes;
  const int row0 = kRbRows * ty;  // the thread's first row in the block

  // The visited kv tiles of this bq tile: one contiguous range, walked by
  // every row of the tile.
  const int nkt = Tk / bkv;
  int kt_lo = 0, kt_hi = nkt - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + bq - 1) / bkv);
  if (window > 0 && q_start - window - bkv + 1 > 0)
    kt_lo = (q_start - window - bkv + 1 + bkv - 1) / bkv;
  const int key_lo = kt_lo * bkv;
  const int key_hi = (kt_hi + 1) * bkv;
  const int nchunks = key_hi > key_lo ? (key_hi - key_lo) / kRbKeys : 0;

  const float* q_b = q + ((long long)bh * S + r_base) * D;
  const float* k_b = k + (long long)bh * Tk * D;
  const float* v_b = v + (long long)bh * Tk * D;

  float acc[kRbRows][2 * NS];
  float m[kRbRows], l[kRbRows];
#pragma unroll
  for (int i = 0; i < kRbRows; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * NS; ++c) acc[i][c] = 0.0f;
  }

  if (nchunks > 0) {
    stage_rows_f32<D>(s_q, q_b, BR, tid, BR);
    stage_rows_f32<D>(s_k, k_b + (long long)key_lo * D, kRbKeys, tid, BR);
    stage_rows_f32<D>(s_v, v_b + (long long)key_lo * D, kRbKeys, tid, BR);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed, and chunk ch - 1 and its p are consumed
    if (ch + 1 < nchunks) {
      const int kn0 = key_lo + (ch + 1) * kRbKeys;
      const int buf = (ch + 1) & 1;
      stage_rows_f32<D>(s_k + buf * kRbKeys * DS, k_b + (long long)kn0 * D, kRbKeys, tid, BR);
      stage_rows_f32<D>(s_v + buf * kRbKeys * DS, v_b + (long long)kn0 * D, kRbKeys, tid, BR);
      cp_async_commit();
    }
    const float* sk = s_k + (ch & 1) * kRbKeys * DS;
    const float* sv = s_v + (ch & 1) * kRbKeys * DS;
    const int kc0 = key_lo + ch * kRbKeys;

    // Scores: sc[i][j] is row row0 + i, key kc0 + tx + 8 j, each a chain over d.
    float sc[kRbRows][kRbKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRbRows; ++i)
#pragma unroll
      for (int j = 0; j < kRbKeysPerThread; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kb[kRbKeysPerThread];
#pragma unroll
      for (int j = 0; j < kRbKeysPerThread; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sk + (tx + kRbKeyLanes * j) * DS + d);
#pragma unroll
      for (int i = 0; i < kRbRows; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(s_q + (row0 + i) * DS + d);
#pragma unroll
        for (int j = 0; j < kRbKeysPerThread; ++j) {
          float t = sc[i][j];
          t = fmaf(qa.x, kb[j].x, t);
          t = fmaf(qa.y, kb[j].y, t);
          t = fmaf(qa.z, kb[j].z, t);
          t = fmaf(qa.w, kb[j].w, t);
          sc[i][j] = t;
        }
      }
    }

    // Scale after the product, mask with the finite -1e30, then the online
    // softmax; each exponent is of the exact difference s - m, so a row with
    // no visible key yet has -1e30 - (-1e30) = 0 and p = 1. The row max and
    // sum go over the row's eight lanes by a fixed xor pattern (every lane
    // ends with the same value).
#pragma unroll
    for (int i = 0; i < kRbRows; ++i) {
      const int row = r_base + row0 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kRbKeysPerThread; ++j) {
        const int col = kc0 + tx + kRbKeyLanes * j;
        const bool visible = (!causal || row >= col) && (window <= 0 || row - col <= window);
        sc[i][j] = visible ? sc[i][j] * scale : kMaskValue;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRbKeysPerThread; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c = 0; c < 2 * NS; ++c) acc[i][c] *= alpha;
    }

    // p crosses shared memory once, transposed: s_p[key][row].
#pragma unroll
    for (int j = 0; j < kRbKeysPerThread; ++j) {
      float* dst = s_p + (tx + kRbKeyLanes * j) * PS + row0;
      *reinterpret_cast<float4*>(dst) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }
    __syncthreads();

    // acc += p . v over the chunk's keys in order; columns 16 s + 2 tx, + 1.
#pragma unroll 4
    for (int key = 0; key < kRbKeys; ++key) {
      const float4 p0 = *reinterpret_cast<const float4*>(s_p + key * PS + row0);
      const float4 p1 = *reinterpret_cast<const float4*>(s_p + key * PS + row0 + 4);
      const float p[kRbRows] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float2 vv = *reinterpret_cast<const float2*>(sv + key * DS + 16 * s + 2 * tx);
#pragma unroll
        for (int i = 0; i < kRbRows; ++i) {
          acc[i][2 * s] = fmaf(p[i], vv.x, acc[i][2 * s]);
          acc[i][2 * s + 1] = fmaf(p[i], vv.y, acc[i][2 * s + 1]);
        }
      }
    }
  }

  float* o_b = o + ((long long)bh * S + r_base + row0) * D;
#pragma unroll
  for (int i = 0; i < kRbRows; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      *reinterpret_cast<float2*>(o_b + (long long)i * D + 16 * s + 2 * tx) =
          make_float2(acc[i][2 * s] / denom, acc[i][2 * s + 1] / denom);
  }
}

template <int D, int BR>
int launch_regblock_d(const void* q, const void* k, const void* v, void* o, int BH, int S,
                      int Tk, int bq, int bkv, int causal, int window, float scale,
                      void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BR + 4 * kRbKeys) * (D + 4) + (size_t)kRbKeys * (BR + 4));
  if (smem > 48 * 1024) {  // above 48 KiB only by opting in
    cudaError_t e = cudaFuncSetAttribute(
        attn_regblock_kernel<D, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)BH * (S / bq) * (bq / BR);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_regblock_kernel<D, BR><<<(unsigned)blocks, BR, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), BH, S, Tk, bq, bkv, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_regblock(const void* q, const void* k, const void* v, void* o, int BH, int S,
                    int Tk, int D, int bq, int bkv, int causal, int window, float scale,
                    void* stream) {
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxHeadDim || D % 16 || bq <= 0 || bq % 64 || bkv <= 0 || bkv % 64 ||
      S % bq || Tk % bkv)
    return (int)cudaErrorInvalidValue;
  // A block takes the whole bq tile where 128 rows divide it, else 64 rows.
#define ATTN_RB_D(N)                                                                        \
  case N:                                                                                   \
    return bq % 128 == 0                                                                    \
               ? launch_regblock_d<N, 128>(q, k, v, o, BH, S, Tk, bq, bkv, causal, window,  \
                                           scale, stream)                                   \
               : launch_regblock_d<N, 64>(q, k, v, o, BH, S, Tk, bq, bkv, causal, window,   \
                                          scale, stream);
  switch (D) {
    ATTN_RB_D(16)
    ATTN_RB_D(32)
    ATTN_RB_D(48)
    ATTN_RB_D(64)
    ATTN_RB_D(80)
    ATTN_RB_D(96)
    ATTN_RB_D(112)
    ATTN_RB_D(128)
  }
#undef ATTN_RB_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_simt_f32(const void* q, const void* k, const void* v, void* o,
                             int BH, int S, int Tk, int D, int bq, int bkv,
                             int causal, int window, float scale, void* stream) {
  return launch_simt<float>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
}

int flash_attention_simt_bf16(const void* q, const void* k, const void* v, void* o,
                              int BH, int S, int Tk, int D, int bq, int bkv,
                              int causal, int window, float scale, void* stream) {
  return launch_simt<__nv_bfloat16>(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window,
                                    scale, stream);
}

int flash_attention_mma_bf16(const void* q, const void* k, const void* v, void* o,
                             int BH, int S, int Tk, int D, int bq, int bkv,
                             int causal, int window, float scale, void* stream) {
  return launch_mma(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
}

int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                               int BH, int S, int Tk, int D, int bq, int bkv,
                               int causal, int window, float scale, void* stream) {
  return launch_wgmma(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
}

int flash_attention_regblock_f32(const void* q, const void* k, const void* v, void* o,
                                 int BH, int S, int Tk, int D, int bq, int bkv,
                                 int causal, int window, float scale, void* stream) {
  return launch_regblock(q, k, v, o, BH, S, Tk, D, bq, bkv, causal, window, scale, stream);
}

REPRO_ERROR_STRING(flash_attention)

}  // extern "C"
