// Exact patch correlation over a two-level feature pyramid (Hopper, sm_90a).
//
// Replaces the TPU kernels `_corr_kernel` (ops/pallas_corr.py:83, launched
// by `_surfaces`) and `_corr_kernel4` (ops/pallas_corr.py:123, launched by
// `_surfaces4`) of the JAX package. Those compute correlation "surfaces"
// over a bounded region and leave the window selection and the bilinear
// blend to XLA; patches spread wider than the region get zeroed windows.
// This kernel computes the function they serve, `ops/corr.py`
// `patch_corr_pyramid`, exactly: for every edge, patch pixel and level it
// takes the 128-d dot products of gmap[kk] against the 8x8 integer window
// of fmap[jj] around floor(coords / scale) (zero outside the map), blends
// the four integer shifts bilinearly to 7x7 and writes the [E, 882] feature
// in the layout the update operator reads: (dx, dy, pi, pj, level).
//
// Design. One block of 576 threads per edge: thread (p, a, b) owns patch
// pixel p and window position (a, b). The edge's 9x128 patch features are
// staged once in shared memory as fp32 and read as warp-wide broadcasts.
// Each thread streams its 256-byte feature row with 16-byte loads and
// accumulates in fp32; neighbouring pixels of a patch share most of their
// windows, so the repeated rows come from L1. The 9x64 raw correlations go
// to shared memory, 441 threads blend them, and the 882 outputs of the edge
// are written as one contiguous row.
//
// Bound. The kernel moves the edge's feature rows (18 windows of 64 rows)
// through L1/L2 and writes 3.5 KB per edge; at the shapes of the SLAM path
// the device-memory bytes (the output row plus the fmaps and gmap read
// once) bound it, and the L1/L2 re-reads of overlapping windows are what
// this simple form spends beyond that bound. Staging the union window of a
// patch once, and tensor-core products, are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                   // feature channels
constexpr int kNP = 9;                    // patch pixels (3x3)
constexpr int kR = 3;                     // correlation radius
constexpr int kD = 2 * kR + 2;            // raw window side (8)
constexpr int kDO = 2 * kR + 1;           // blended side (7)
constexpr int kThreads = kNP * kD * kD;   // 576
constexpr int kOut = kDO * kDO * kNP * 2; // 882

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_pyramid_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                    const T* __restrict__ fmap2,
                    const float* __restrict__ coords,
                    const int* __restrict__ kk, const int* __restrict__ jj,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ out, int H1, int W1, int H2, int W2) {
  __shared__ float g_s[kNP * kC];     // patch features, [pixel][channel]
  __shared__ float c_s[kNP * kD * kD];  // raw correlations, [pixel][y][x]
  __shared__ float o_s[kOut];         // the edge's output row

  const int e = blockIdx.x;
  const int t = threadIdx.x;
  const size_t k = static_cast<size_t>(kk[e]);
  const int j = jj[e];
  const float v = valid[e] ? 1.0f : 0.0f;

  // gmap[k] is [C, 3, 3]: element i = c * 9 + p
  for (int i = t; i < kNP * kC; i += kThreads)
    g_s[(i % kNP) * kC + i / kNP] = to_float(gmap[k * kNP * kC + i]);

  const int p = t / (kD * kD);
  const int a = (t / kD) % kD;
  const int b = t % kD;
  const float* cp = coords + static_cast<size_t>(e) * kNP * 2;

  for (int l = 0; l < 2; ++l) {
    const T* fmap = l ? fmap2 : fmap1;
    const int H = l ? H2 : H1;
    const int W = l ? W2 : W1;
    const float s = l ? 4.0f : 1.0f;
    const int yy = static_cast<int>(floorf(cp[2 * p + 1] / s)) + a - kR;
    const int xx = static_cast<int>(floorf(cp[2 * p] / s)) + b - kR;
    __syncthreads();  // g_s written (level 0); c_s consumed (level 1)
    float acc = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* row = fmap + ((static_cast<size_t>(j) * H + yy) * W + xx) * kC;
      const float* g = g_s + p * kC;
#pragma unroll 4
      for (int c = 0; c < kC; c += 8) {
        float f[8];
        load8(row + c, f);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc = fmaf(f[q], g[c + q], acc);
      }
    }
    c_s[t] = acc;
    __syncthreads();
    if (t < kDO * kDO * kNP) {
      // output index t = (dx * 7 + dy) * 9 + pixel
      const int dx = t / (kDO * kNP);
      const int dy = (t / kNP) % kDO;
      const int pp = t % kNP;
      const float x = cp[2 * pp] / s;
      const float y = cp[2 * pp + 1] / s;
      const float fx = x - floorf(x);
      const float fy = y - floorf(y);
      const float* c = c_s + pp * kD * kD + dy * kD + dx;
      const float o = (1.0f - fx) * (1.0f - fy) * c[0] +
                      fx * (1.0f - fy) * c[1] +
                      (1.0f - fx) * fy * c[kD] + fx * fy * c[kD + 1];
      o_s[2 * t + l] = o * v;
    }
  }
  __syncthreads();
  float* orow = out + static_cast<size_t>(e) * kOut;
  for (int i = t; i < kOut; i += kThreads) orow[i] = o_s[i];
}

}  // namespace

// gmap [S, 128, 3, 3], fmap1 [F, H1, W1, 128], fmap2 [F, H2, W2, 128] in
// bf16 (feat_bf16 != 0) or fp32; coords [E, 3, 3, 2] fp32; kk, jj [E] int32
// already reduced into [0, S) and [0, F); valid [E] bool; out [E, 882] fp32.
// Returns the cudaError_t of the launch.
extern "C" int wv3d_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* coords,
                                 const void* kk, const void* jj,
                                 const void* valid, void* out, int E, int H1,
                                 int W1, int H2, int W2, int feat_bf16,
                                 void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  const int* k = static_cast<const int*>(kk);
  const int* j = static_cast<const int*>(jj);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* o = static_cast<float*>(out);
  if (feat_bf16) {
    corr_pyramid_kernel<__nv_bfloat16><<<E, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gmap),
        static_cast<const __nv_bfloat16*>(fmap1),
        static_cast<const __nv_bfloat16*>(fmap2), c, k, j, v, o, H1, W1, H2,
        W2);
  } else {
    corr_pyramid_kernel<float><<<E, kThreads, 0, st>>>(
        static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), c, k, j, v, o, H1, W1, H2, W2);
  }
  return static_cast<int>(cudaGetLastError());
}
