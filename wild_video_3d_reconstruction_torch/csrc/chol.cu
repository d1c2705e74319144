// Cholesky solve of one small SPD system S x = y (Hopper, sm_90a).
//
// Replaces the JAX package's TPU kernel `_chol_solve_kernel`
// (ops/pallas_chol.py:37, launched by `chol_solve_small`): S [D, D] fp32
// with D <= 256, factorised S = L L^T right-looking, then L z = y and
// L^T x = z. A non-positive pivot gives NaN, as the TPU kernel's rsqrt
// does: the column is scaled by 1 / sqrt(pivot), which is NaN for a
// negative pivot and makes 0 * inf = NaN of a zero one, and the NaN
// reaches every later entry and x.
//
// Design. One block (512 threads) per system. The lower triangle lives
// packed in dynamic shared memory (D (D + 1) / 2 floats, 131.6 KB at
// D = 256; the full matrix would need 262 KB, more than a block can
// have). Step k scales column k (copied to a contiguous vector) and then
// updates the trailing triangle, one warp per row and the lanes along the
// row, so neighbouring lanes touch neighbouring words. The substitutions
// run column by column: each step fixes one unknown and updates the rest
// of the right-hand side in parallel (the forward pass walks the columns
// of L, the backward pass its rows, which are contiguous in the packed
// layout).
//
// Bound. D^3 / 3 multiply-adds on 0.4 MB at most: far below a
// microsecond of the card's rates. The 3 D barriers of the dependent
// chain bound it; batching many systems in one launch (one block each) is
// how such a kernel fills the card, for a caller that has them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ y,
                  float* __restrict__ x, int D) {
  extern __shared__ float L[];          // packed lower triangle
  __shared__ float col[kMaxD];          // column k of L
  __shared__ float v[kMaxD];            // right-hand side, then z, then x
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;

  for (int idx = t; idx < D * D; idx += kThreads) {
    const int i = idx / D, j = idx % D;
    if (j <= i) L[tri(i, j)] = S[idx];
  }
  for (int i = t; i < D; i += kThreads) v[i] = y[i];
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    const float r = 1.0f / sqrtf(L[tri(k, k)]);
    __syncthreads();                    // every thread has read the pivot
    for (int i = k + t; i < D; i += kThreads) {
      const float l = L[tri(i, k)] * r;
      L[tri(i, k)] = l;
      col[i] = l;
    }
    __syncthreads();
    // trailing update A[i, j] -= L[i, k] L[j, k] for k < j <= i
    for (int i = k + 1 + warp; i < D; i += kWarps) {
      const float li = col[i];
      float* row = L + tri(i, 0);
      for (int j = k + 1 + lane; j <= i; j += 32) row[j] -= li * col[j];
    }
    __syncthreads();
  }

  // L z = y, column by column
  for (int k = 0; k < D; ++k) {
    const float zk = v[k] / L[tri(k, k)];
    __syncthreads();
    if (t == 0) v[k] = zk;
    for (int i = k + 1 + t; i < D; i += kThreads) v[i] -= L[tri(i, k)] * zk;
    __syncthreads();
  }
  // L^T x = z, row k of L is column k of L^T
  for (int k = D - 1; k >= 0; --k) {
    const float xk = v[k] / L[tri(k, k)];
    __syncthreads();
    if (t == 0) v[k] = xk;
    for (int j = t; j < k; j += kThreads) v[j] -= L[tri(k, j)] * xk;
    __syncthreads();
  }
  for (int i = t; i < D; i += kThreads) x[i] = v[i];
}

}  // namespace

// S [D, D] and y [D] fp32 on the card, D <= 256; x [D] fp32. Returns the
// cudaError_t of the launch.
extern "C" int wv3d_chol_solve(const void* S, const void* y, void* x, int D,
                               void* stream) {
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(D) * (D + 1) / 2 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(y),
      static_cast<float*>(x), D);
  return static_cast<int>(cudaGetLastError());
}
