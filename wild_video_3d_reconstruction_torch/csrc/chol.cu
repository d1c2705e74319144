// Cholesky solve of one small SPD system S x = y (Hopper, sm_90a).
//
// Replaces the JAX package's TPU kernel `_chol_solve_kernel`
// (ops/pallas_chol.py:37, launched by `chol_solve_small`): S [D, D] fp32
// with D <= 256, factorised S = L L^T, then L z = y and L^T x = z, in fp32
// FMAs (no TF32). A pivot that is not positive gives NaN, as the TPU
// kernel's rsqrt does: its inverse square root is NaN, every later entry
// of L is formed from it, and so is every entry of x (no step skips a
// zero, clamps a pivot or takes a min / max that would drop the NaN).
//
// Bound. D^3 / 3 multiply-adds on at most 0.4 MB: under a microsecond of
// the card's rates. What bounds the kernel is the dependent chain of D
// pivots, each on one warp, and the block barriers between the stages
// that feed them.
//
// Design. One block per system (128 threads up to D = 128, 256 above).
// The lower triangle lives packed by rows in dynamic shared memory, with
// y appended as row D: the factorisation of that augmented triangle
// leaves z = L^-1 y in row D, so the forward substitution is part of the
// factorisation. S comes in as 16-byte loads that all go out before their
// stores. Panels of kNB = 16 columns (the last one ragged):
//   1. one warp factors the diagonal block in registers, two columns a
//      step (lane = row; the columns reach the other lanes through shared
//      memory, one __syncwarp a step, no block barrier) and keeps
//      1 / L[k][k] for the stages below;
//   2. every thread solves one row below the block (y's row included)
//      against it in registers, and writes the row to a panel copy;
//   3. the trailing triangle takes the rank-16 update from the panel
//      copy: warp 0 first updates the next diagonal block, an entry per
//      lane, and factors it (stage 1 of the next panel), while the other
//      warps update the rest in 4 x 4 register tiles of 16-term fp32 dot
//      products.
// Two block barriers per panel (about 11 at D = 72, where the column-at-
// a-time design had three per column). The backward substitution goes
// panel by panel from the last: warp 0 takes the block just solved out of
// the previous block's right-hand side and solves that 16-wide triangle
// by shuffles, while the other warps take it out of the rest; one block
// barrier per panel. Up to D = 136 the shared memory fits the 48 KB a
// launch gets without asking (17.4 KB at D = 72); above it the launcher
// raises the limit once per process (152 KB at D = 256).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kMaxD = 256;
constexpr int kNB = 16;                  // panel width
constexpr int kTile = 4;                 // trailing-update tile side
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// 1 / sqrt(d) for a positive pivot, NaN for any other (NaN included)
__device__ __forceinline__ float pivot_rsqrt(float d) {
  return d > 0.0f ? rsqrtf(d) : __int_as_float(0x7fc00000);
}

// Dynamic shared memory of a system of size D, in floats: the panel copy
// [(D + 1) x kNB], the factored diagonal block by columns [kNB x kNB],
// the column exchange [2 x 2 x 32], 1 / L[k][k] [D + kNB] and the packed rows
// 0..D.
__host__ __device__ constexpr size_t panel_floats(int D) {
  return static_cast<size_t>(D + 1) * kNB;
}
constexpr size_t kBlockFloats = kNB * kNB + 4 * 32;
__host__ __device__ constexpr size_t packed_floats(int D) {
  return static_cast<size_t>(D) * (D + 1) / 2 + D;
}
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return (panel_floats(D) + kBlockFloats + D + kNB + packed_floats(D)) *
         sizeof(float);
}

// S's lower triangle into the packed rows, y into row D. A thread's loads
// (y's first) all go out before its stores, so the copy waits for device
// memory once or a few times, not once per element (S is 16-byte aligned;
// D * D is a multiple of 4 or one more).
template <int kThreads>
__device__ void load_system(const float* S, const float* y, float* L,
                            float* v, int D, int t) {
  constexpr int kLoads = 16;
  constexpr int kYLoads = kMaxD / kThreads;
  float yv[kYLoads];
#pragma unroll
  for (int u = 0; u < kYLoads; ++u)
    yv[u] = u * kThreads + t < D ? __ldg(y + u * kThreads + t) : 0.0f;
  const int n4 = D * D / 4;
  const float4* S4 = reinterpret_cast<const float4*>(S);
  for (int base = 0; base < n4; base += kThreads * kLoads) {
    float4 f[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = base + u * kThreads + t;
      f[u] = k < n4 ? __ldg(S4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = base + u * kThreads + t;
      if (k >= n4) break;
      const float e[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
      int i = 4 * k / D, j = 4 * k - i * D;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (j <= i) L[tri(i, j)] = e[r];
        if (++j == D) j = 0, ++i;
      }
    }
  }
  if (t == 0 && D * D % 4) L[tri(D - 1, D - 1)] = S[D * D - 1];
#pragma unroll
  for (int u = 0; u < kYLoads; ++u)
    if (u * kThreads + t < D) v[u * kThreads + t] = yv[u];
}

// 16 floats of shared memory (16-byte aligned) into registers
__device__ __forceinline__ void load16(const float* p, float (&r)[kNB]) {
#pragma unroll
  for (int q = 0; q < kNB / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

// Stage 1, one warp: factor the kb x kb diagonal block at k0 in place,
// two columns a step. Lane i holds row i in registers. Column c + 1 needs
// only L[c + 1][c] from column c, one shuffle; then both columns go to the
// lanes through shared memory (float4 broadcasts, where a shuffle per
// entry would wait on each in turn), double-buffered so that one
// __syncwarp a step orders them. Every lane keeps the block's diagonal up
// to date from those broadcasts (the same FMAs as the row's own lane), so
// the pivots are at hand. Column c also goes to blk as row c
// (blk[c][c2] = L[k0 + c2][k0 + c] for c < c2 < kb, zero elsewhere), and
// 1 / L[k][k] to rinv.
__device__ void factor_diagonal(float* L, float* blk, float* col,
                                float* rinv, int k0, int kb, int lane) {
  const bool row = lane < kb;
  float a[kNB], dg[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    a[c] = row && c <= lane ? L[tri(k0 + lane, k0 + c)] : 0.0f;
    dg[c] = c < kb ? L[tri(k0 + c, k0 + c)] : 0.0f;
  }
  // a[c] of lane i is A[i][c]; entries above the diagonal (c > i), and
  // with an odd kb the column past it, are updated too but never read by
  // another lane nor stored
#pragma unroll
  for (int c = 0; c < kNB; c += 2) {
    if (c < kb) {
      const bool two = c + 1 < kb;
      const float r0 = pivot_rsqrt(dg[c]);
      const float l0 = lane == c ? dg[c] * r0 : a[c] * r0;
      a[c] = l0;
      const float l10 = __shfl_sync(kAll, l0, c + 1);   // L[c + 1][c]
      a[c + 1] -= l0 * l10;
      const float d1 = dg[c + 1] - l10 * l10;
      const float r1 = pivot_rsqrt(d1);
      const float l1 = lane == c + 1 ? d1 * r1 : a[c + 1] * r1;
      a[c + 1] = l1;
      const float below0 = lane > c && row ? l0 : 0.0f;
      const float below1 = lane > c + 1 && row && two ? l1 : 0.0f;
      float* cs = col + 64 * (c / 2 % 2);
      cs[lane] = below0;
      cs[32 + lane] = below1;
      if (lane < kNB) {
        blk[c * kNB + lane] = below0;
        if (two) blk[(c + 1) * kNB + lane] = below1;
      }
      if (lane == c) rinv[k0 + c] = r0;
      if (lane == c + 1 && two) rinv[k0 + c + 1] = r1;
      __syncwarp();
      float lc0[kNB], lc1[kNB];
      load16(cs, lc0);
      load16(cs + 32, lc1);
#pragma unroll
      for (int c2 = c + 2; c2 < kNB; ++c2) {
        a[c2] -= l0 * lc0[c2];
        a[c2] -= l1 * lc1[c2];
        dg[c2] -= lc0[c2] * lc0[c2];
        dg[c2] -= lc1[c2] * lc1[c2];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (row && c <= lane) L[tri(k0 + lane, k0 + c)] = a[c];
}

// The panel copy holds row r's four float4 in swizzled order, so that
// the tiles of one warp, whose rows lie 4 apart, read 4 different banks
__device__ __forceinline__ int panel_slot(int r, int q) {
  return 4 * r + (q ^ ((r >> 2) & 3));
}

// Stage 2: rows k0 + kb .. D (D: the right-hand side) against the
// factored block; each row also goes to the panel copy (zero past kb).
template <int kThreads>
__device__ void solve_panel_rows(float* L, float4* P4, const float* blk,
                                 const float* rinv, int k0, int kb, int D,
                                 int t) {
  const int t0 = k0 + kb;
  for (int i = t0 + t; i <= D; i += kThreads) {
    float* Li = L + tri(i, k0);
    float x[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) x[c] = c < kb ? Li[c] : 0.0f;
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      x[c] = c < kb ? x[c] * rinv[k0 + c] : 0.0f;
      float bc[kNB];
      load16(blk + c * kNB, bc);
#pragma unroll
      for (int c2 = c + 1; c2 < kNB; ++c2) x[c2] -= x[c] * bc[c2];
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (c < kb) Li[c] = x[c];
    const int r = i - t0;
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q)
      P4[panel_slot(r, q)] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

// Stage 3: A[i][j] -= <P[i], P[j]> for t0 <= j <= i <= D, j < D (row D
// is the right-hand side, which has no diagonal entry); thread tiles of
// kTile x kTile over the lower triangle of tiles only.
constexpr int kDiagTiles = (kNB / kTile) * (kNB / kTile + 1) / 2;
// Tiles are numbered row by row, idx = bi (bi + 1) / 2 + bj: the first
// kDiagTiles cover the next panel's diagonal block. Tiles first, first +
// stride, ... of them are this thread's.
__device__ void update_trailing(float* L, const float4* P4, int t0, int D,
                                int first, int last, int stride) {
  const int m = D + 1 - t0;              // rows, the right-hand side's too
  const int nb = (m + kTile - 1) / kTile;
  last = min(last, nb * (nb + 1) / 2);
  for (int idx = first; idx < last; idx += stride) {
    // idx = bi (bi + 1) / 2 + bj with bj <= bi
    int bi = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
    if (bi * (bi + 1) / 2 > idx) --bi;
    if ((bi + 1) * (bi + 2) / 2 <= idx) ++bi;
    const int bj = idx - bi * (bi + 1) / 2;
    float acc[kTile][kTile] = {};
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      float4 pi[kTile], pj[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        // rows past the last read the last one; their sums are not stored
        pi[a] = P4[panel_slot(min(kTile * bi + a, m - 1), q)];
        pj[a] = P4[panel_slot(min(kTile * bj + a, m - 1), q)];
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b)
          acc[a][b] += pi[a].x * pj[b].x + pi[a].y * pj[b].y +
                       pi[a].z * pj[b].z + pi[a].w * pj[b].w;
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int i = t0 + kTile * bi + a;
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int j = t0 + kTile * bj + b;
        if (i <= D && j <= i && j < D) L[tri(i, j)] -= acc[a][b];
      }
    }
  }
}

// Stage 3 on the next panel's diagonal block (the tiles below kDiagTiles),
// one warp, an entry per lane at a time: rows t0 .. t0 + 15 (row D, the
// right-hand side, where it falls among them) and columns t0 .. t0 + 15.
__device__ void update_diagonal_block(float* L, const float4* P4, int t0,
                                      int D, int lane) {
  for (int e = lane; e < kNB * (kNB + 1) / 2; e += 32) {
    int ri = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    if (ri * (ri + 1) / 2 > e) --ri;
    if ((ri + 1) * (ri + 2) / 2 <= e) ++ri;
    const int rj = e - ri * (ri + 1) / 2;
    const int i = t0 + ri, j = t0 + rj;
    if (i > D || j >= D) continue;
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      const float4 pi = P4[panel_slot(ri, q)];
      const float4 pj = P4[panel_slot(rj, q)];
      acc += pi.x * pj.x + pi.y * pj.y + pi.z * pj.z + pi.w * pj.w;
    }
    L[tri(i, j)] -= acc;
  }
}

// Backward substitution, one warp: L[k0.., k0..]^T x = v on the kb-wide
// block, in place in v.
__device__ void solve_block_transposed(const float* L, const float* rinv,
                                       float* v, int k0, int kb, int lane) {
  float col[kNB];   // col[c] = L[k0 + c][k0 + lane] below the diagonal
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    col[c] = c < kb && c > lane ? L[tri(k0 + c, k0 + lane)] : 0.0f;
  const float ri = lane < kb ? rinv[k0 + lane] : 0.0f;
  float xv = lane < kb ? v[k0 + lane] : 0.0f;
#pragma unroll
  for (int c = kNB - 1; c >= 0; --c) {
    if (c < kb) {
      if (lane == c) xv *= ri;
      const float xc = __shfl_sync(kAll, xv, c);
      if (lane < c) xv -= col[c] * xc;
    }
  }
  if (lane < kb) v[k0 + lane] = xv;
}

// v[j] -= sum over the solved block at k0 of L[k0 + c][j] x[k0 + c]
__device__ __forceinline__ void take_out(const float* L, float* v, int k0,
                                         int kb, int j) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (c < kb) s += L[tri(k0 + c, j)] * v[k0 + c];
  v[j] -= s;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ y,
                  float* __restrict__ x, int D) {
  extern __shared__ float4 dyn_smem[];
  float4* P4 = dyn_smem;                           // panel copy
  float* blk = reinterpret_cast<float*>(dyn_smem) + panel_floats(D);
  float* col = blk + kNB * kNB;                    // column exchange
  float* rinv = blk + kBlockFloats;                // 1 / L[k][k]
  float* L = rinv + D + kNB;                       // packed rows 0..D
  float* v = L + tri(D, 0);                        // row D: y, z, then x
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;

  load_system<kThreads>(S, y, L, v, D, t);
  __syncthreads();
  if (warp == 0) factor_diagonal(L, blk, col, rinv, 0, min(kNB, D), lane);
  __syncthreads();

  // Per panel: its rows, then the trailing update, where warp 0 first
  // updates the next diagonal block and factors it while the other warps
  // update the rest.
  for (int k0 = 0; k0 < D; k0 += kNB) {
    const int kb = min(kNB, D - k0);
    const int t0 = k0 + kb;
    solve_panel_rows<kThreads>(L, P4, blk, rinv, k0, kb, D, t);
    __syncthreads();
    if (t0 == D) break;
    if (warp == 0) {
      update_diagonal_block(L, P4, t0, D, lane);
      __syncwarp();
      factor_diagonal(L, blk, col, rinv, t0, min(kNB, D - t0), lane);
    } else {
      update_trailing(L, P4, t0, D, kDiagTiles + t - 32, INT_MAX,
                      kThreads - 32);
    }
    __syncthreads();
  }

  // Backward, per panel from the last: warp 0 takes the solved block out
  // of the previous block's right-hand side and solves that block, while
  // the other warps take it out of the rest.
  int k0 = (D - 1) / kNB * kNB;
  if (warp == 0) solve_block_transposed(L, rinv, v, k0, D - k0, lane);
  __syncthreads();
  for (; k0 > 0; k0 -= kNB) {
    const int kb = min(kNB, D - k0);
    const int j0 = k0 - kNB;              // the previous block (full)
    if (warp == 0) {
      if (lane < kNB) take_out(L, v, k0, kb, j0 + lane);
      __syncwarp();
      solve_block_transposed(L, rinv, v, j0, kNB, lane);
    } else {
      for (int j = t - 32; j < j0; j += kThreads - 32)
        take_out(L, v, k0, kb, j);
    }
    __syncthreads();
  }
  for (int i = t; i < D; i += kThreads) x[i] = v[i];
}

template <int kThreads>
int launch_chol(const float* S, const float* y, float* x, int D,
                cudaStream_t st) {
  const size_t smem = smem_bytes(D);
  if (smem > kDefaultSmem) {
    // once per process, for the largest system
    static const cudaError_t attr = cudaFuncSetAttribute(
        chol_solve_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxD)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  chol_solve_kernel<kThreads><<<1, kThreads, smem, st>>>(S, y, x, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S [D, D] and y [D] fp32 on the card, D <= 256; x [D] fp32. Returns the
// cudaError_t of the launch.
extern "C" int wv3d_chol_solve(const void* S, const void* y, void* x, int D,
                               void* stream) {
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(S);
  const float* yy = static_cast<const float*>(y);
  float* xx = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128) return launch_chol<128>(s, yy, xx, D, st);
  return launch_chol<256>(s, yy, xx, D, st);
}
