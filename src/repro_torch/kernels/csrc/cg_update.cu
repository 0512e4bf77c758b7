// One iteration of conjugate gradient's vector update, after ap = A p.
//
// Replaces no TPU kernel: the JAX package runs CG on the host. The port's
// device loop (repro_torch/api/solvers.py::_cg_device) computed this update
// as some 35 PyTorch operations an iteration, each a launch the host must
// enqueue; on HPCG's 64^3 stencil at one right-hand side those launches, not
// the card, set the solve's pace. Here it is three launches. For state
// [B, N] (float32 z, r, p, ap; float64 rs[B]) and each row b:
//
//     denom  = sum_i p[b, i] ap[b, i]                       (float64)
//     ok     = |denom| >= 1e-30
//     alpha  = rs[b] / denom
//     z'     = f32(z + alpha p),   r' = f32(r - alpha ap)   (float64 inside)
//     rs'    = sum_i r'[b, i]^2                             (float64)
//     p'     = f32(r' + rs' / max(rs[b], 1e-30) p)
//
// and a row that is not ok keeps z, r, p and rs as they were. The residual
// sqrt(max_b rs) goes to one slot of a float64 history buffer.
//
// What bounds it on an H100: device-memory bytes. It reads and writes some
// 11 float32 vectors of N (about 11 MB at N = 262,144, B = 1, mostly from the
// 50 MB L2), 3.3 us at 3.35 TB/s; the launches themselves cost more. The two
// sums cross blocks, so each of them ends one kernel and is finished by the
// next:
//
//   cg_dot     block (g, b) writes its chunk's sum of p ap;
//   cg_zr      every block sums row b's partials (the same fixed order in
//              each block), updates its chunk of z and r in place, and
//              writes its chunk's sum of r'^2; block (0, b) writes ok[b];
//   cg_p       every block sums those partials, updates its chunk of p in
//              place; block (0, 0) writes rs' (rs where a row is not ok) for
//              every row into the other half of the rs double buffer, and
//              the residual.
//
// No atomics: a block sums its threads' values by warp shuffles and then over
// its warps, always in the same order, and the grid depends only on N, B and
// the card's SM count (ops.py::cg_grid), so a solve is bitwise the same from
// run to run. The float64 arithmetic is written with __dmul_rn / __dadd_rn,
// which the compiler never contracts into an FMA: each product and sum is
// rounded once, as PyTorch's separate elementwise kernels round them in the
// plain version (repro_torch/kernels/spmv/cg_update.py::cg_update_plain). The
// order of the two sums is then the only difference from it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The block's sum of one value a thread, in a fixed order: warp shuffles,
// then warp 0 over the warps' sums. Every thread gets the sum. `slots`
// holds kWarps + 1 doubles; every thread of the block must call it.
__device__ double block_sum(double v, double* slots) {
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double s = lane < kWarps ? slots[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) slots[kWarps] = s;
  }
  __syncthreads();
  const double total = slots[kWarps];
  __syncthreads();  // the slots are free again for the next call
  return total;
}

// Row b's sum over its g partials.
__device__ double sum_partials(const double* part, int g, double* slots) {
  double v = 0.0;
  for (int i = threadIdx.x; i < g; i += kThreads) v = __dadd_rn(v, part[i]);
  return block_sum(v, slots);
}

__global__ void __launch_bounds__(kThreads)
cg_dot_kernel(const float* __restrict__ p, const float* __restrict__ ap, long long ap_row,
              long long ap_col, int n, int chunk, double* __restrict__ part) {
  __shared__ double slots[kWarps + 1];
  const int g = blockIdx.x, b = blockIdx.y;
  const long long lo = (long long)g * chunk, hi = min((long long)n, lo + chunk);
  const float* pb = p + (long long)b * n;
  const float* ab = ap + b * ap_row;
  double v = 0.0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    v = __dadd_rn(v, __dmul_rn((double)pb[i], (double)ab[i * ap_col]));
  v = block_sum(v, slots);
  if (threadIdx.x == 0) part[(long long)b * gridDim.x + g] = v;
}

__global__ void __launch_bounds__(kThreads)
cg_zr_kernel(float* __restrict__ z, float* __restrict__ r, const float* __restrict__ p,
             const float* __restrict__ ap, long long ap_row, long long ap_col,
             const double* __restrict__ rs, int n, int chunk, const double* __restrict__ dots,
             int* __restrict__ ok_out, double* __restrict__ part) {
  __shared__ double slots[kWarps + 1];
  const int g = blockIdx.x, b = blockIdx.y, grid = gridDim.x;
  const double denom = sum_partials(dots + (long long)b * grid, grid, slots);
  const bool ok = fabs(denom) >= 1e-30;
  if (g == 0 && threadIdx.x == 0) ok_out[b] = ok;
  double v = 0.0;
  if (ok) {
    const double alpha = __ddiv_rn(rs[b], denom);
    const long long lo = (long long)g * chunk, hi = min((long long)n, lo + chunk);
    float* zb = z + (long long)b * n;
    float* rb = r + (long long)b * n;
    const float* pb = p + (long long)b * n;
    const float* ab = ap + b * ap_row;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      zb[i] = __double2float_rn(__dadd_rn((double)zb[i], __dmul_rn(alpha, (double)pb[i])));
      const float rn =
          __double2float_rn(__dadd_rn((double)rb[i], -__dmul_rn(alpha, (double)ab[i * ap_col])));
      rb[i] = rn;
      v = __dadd_rn(v, __dmul_rn((double)rn, (double)rn));
    }
  }
  v = block_sum(v, slots);  // ok is the same for the whole block
  if (threadIdx.x == 0) part[(long long)b * grid + g] = v;
}

__global__ void __launch_bounds__(kThreads)
cg_p_kernel(const float* __restrict__ r, float* __restrict__ p, const double* __restrict__ rs,
            double* __restrict__ rs_out, int n, int batch, int chunk,
            const int* __restrict__ ok, const double* __restrict__ part,
            double* __restrict__ resid) {
  __shared__ double slots[kWarps + 1];
  const int g = blockIdx.x, b = blockIdx.y, grid = gridDim.x;
  if (ok[b]) {
    const double rs_new = sum_partials(part + (long long)b * grid, grid, slots);
    const double beta = __ddiv_rn(rs_new, rs[b] < 1e-30 ? 1e-30 : rs[b]);
    const long long lo = (long long)g * chunk, hi = min((long long)n, lo + chunk);
    const float* rb = r + (long long)b * n;
    float* pb = p + (long long)b * n;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      pb[i] = __double2float_rn(__dadd_rn((double)rb[i], __dmul_rn(beta, (double)pb[i])));
  }
  if (g != 0 || b != 0) return;
  // Every row's new rs, summed as the row's own blocks summed it, and the
  // largest (a NaN wins, as in torch.max).
  double most = 0.0;
  for (int row = 0; row < batch; ++row) {
    const double v =
        ok[row] ? sum_partials(part + (long long)row * grid, grid, slots) : rs[row];
    if (threadIdx.x == 0) {
      rs_out[row] = v;
      if (row == 0 || v > most || v != v) most = v;
    }
  }
  if (threadIdx.x == 0) resid[0] = __dsqrt_rn(most);
}

int launch(void* z, void* r, void* p, const void* ap, long long ap_row, long long ap_col,
           const void* rs, void* rs_out, void* ok, void* dots, void* part, void* resid, int n,
           int batch, int grid, void* stream) {
  if (n < 1 || batch < 1 || grid < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int chunk = (int)((n + (long long)grid - 1) / grid);
  const dim3 blocks(grid, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_dot_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(p),
                                            static_cast<const float*>(ap), ap_row, ap_col, n,
                                            chunk, static_cast<double*>(dots));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_zr_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<float*>(z), static_cast<float*>(r), static_cast<const float*>(p),
      static_cast<const float*>(ap), ap_row, ap_col, static_cast<const double*>(rs), n, chunk,
      static_cast<const double*>(dots), static_cast<int*>(ok), static_cast<double*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_p_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(r), static_cast<float*>(p), static_cast<const double*>(rs),
      static_cast<double*>(rs_out), n, batch, chunk, static_cast<const int*>(ok),
      static_cast<const double*>(part), static_cast<double*>(resid));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z, r, p: [batch, n] float32, contiguous, updated in place. ap: float32,
// element (b, i) at ap + b * ap_row + i * ap_col. rs: [batch] float64 in;
// rs_out: [batch] float64 out (another buffer). ok: [batch] int32 out.
// dots, part: [batch, grid] float64 scratch. resid: one float64 out.
int cg_update_f32(void* z, void* r, void* p, const void* ap, long long ap_row,
                  long long ap_col, const void* rs, void* rs_out, void* ok, void* dots,
                  void* part, void* resid, int n, int batch, int grid, void* stream) {
  return launch(z, r, p, ap, ap_row, ap_col, rs, rs_out, ok, dots, part, resid, n, batch, grid,
                stream);
}

REPRO_ERROR_STRING(cg_update)

}  // extern "C"
