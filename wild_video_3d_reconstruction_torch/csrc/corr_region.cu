// The split x16 region correlation pair over a two-level feature pyramid
// (Hopper, sm_90a).
//
// Replaces the JAX package's split x16 path: the surfaces of
// `_corr_kernel4` (ops/pallas_corr.py:123, launched by `_surfaces4`) and
// the standalone window extraction `_extract_kernel4` (:230,
// `_extract_windows4`), which `patch_corr_pyramid_pallas(extract=
// "pallas")` runs. The function is `ops/corr.py`'s `patch_corr_pyramid`:
// for every edge, patch pixel and level, the 128-d products of gmap[kk]
// with the 8x8 window of fmap[jj] at floor(coords / scale) - 3 (zero off
// the map), blended bilinearly to 7x7, written as the [E, 882] feature
// (dx, dy, pi, pj, level). The plain version and the geometry are in
// `ops/corr_region.py`. (The fused routes and the unfused one run the
// correlation body of `csrc/corr_box.cu`.)
//
// Region geometry (per edge and level): the nine window starts (ys, xs);
// the region origin oy = min ys, ox = min xs (the x16 geometry, the only
// one these kernels serve); a pixel fits when its window lies inside the
// 16 x RW region. The TPU kernels zero the pixels that do
// not fit; here a pixel that does not fit but overlaps the map takes the
// spill path, its window computed straight from the map, so the result is
// exact for any spread. The region never needs a padded map: positions off
// the map read as zero.
//
// Design. The surfaces kernel: one block per edge, one thread per region
// position (16 x 16). The 9x128 patch features sit in shared memory as
// fp32. The region is staged in shared memory one 32-channel chunk at a
// time (16-byte loads, fp32, a padded stride of 36 floats so that the
// 16-byte reads of neighbouring positions hit distinct banks); each thread
// accumulates its position's nine surface values in registers (fp32 SIMT
// FMAs, the patch features read as broadcasts) and writes the full 16x16
// surfaces of both levels to device memory. The extract kernel (576
// threads, one per pixel and window position) selects from them, computes
// the spill windows and blends.
//
// Bound. The pair moves the fp32 surfaces (18 KB per edge) through device
// memory twice by design; beyond that, the fmaps and gmap read once and
// 3.5 KB of output per edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                    // feature channels
constexpr int kNP = 9;                     // patch pixels (3x3)
constexpr int kR = 3;                      // correlation radius
constexpr int kD = 2 * kR + 2;             // raw window side (8)
constexpr int kDO = 2 * kR + 1;            // blended side (7)
constexpr int kOut = kDO * kDO * kNP * 2;  // 882
constexpr int kRH = 16;                    // region rows
constexpr int kCH = 32;                    // channels staged per pass
constexpr int kCS = kCH + 4;               // staged floats per position
constexpr int kWinThreads = kNP * kD * kD; // 576
constexpr float kCoordLim = 1e6f;

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

// NaN -> +lim, then clamp to [-lim, lim] (as torch.nan_to_num + clamp)
__device__ __forceinline__ float clamp_coord(float v) {
  return v != v ? kCoordLim : fminf(fmaxf(v, -kCoordLim), kCoordLim);
}

// The geometry of one edge at one level, written by one thread.
struct Geo {
  int ys[kNP], xs[kNP];      // window starts
  float fx[kNP], fy[kNP];    // blend weights
  int fit[kNP], spill[kNP];
  int oy, ox;                // region origin
  int any_spill;
};

template <int RW>
__device__ void edge_geometry(const float* cp, float s, int H, int W,
                              Geo& g) {
  int oy = INT_MAX, ox = INT_MAX;
  for (int p = 0; p < kNP; ++p) {
    const float x = cp[2 * p] / s;
    const float y = cp[2 * p + 1] / s;
    g.fx[p] = x - floorf(x);
    g.fy[p] = y - floorf(y);
    g.ys[p] = static_cast<int>(floorf(clamp_coord(y))) - kR;
    g.xs[p] = static_cast<int>(floorf(clamp_coord(x))) - kR;
    oy = min(oy, g.ys[p]);
    ox = min(ox, g.xs[p]);
  }
  int any = 0;
  for (int p = 0; p < kNP; ++p) {
    const int fit = g.ys[p] - oy <= kRH - kD && g.xs[p] - ox <= RW - kD;
    const int over = g.ys[p] > -kD && g.ys[p] < H && g.xs[p] > -kD &&
                     g.xs[p] < W;
    g.fit[p] = fit;
    g.spill[p] = over && !fit;
    any |= g.spill[p];
  }
  g.oy = oy;
  g.ox = ox;
  g.any_spill = any;
}

// <g, fmap[j, y, x]> straight from the map (the spill path); 0 off the map
template <typename T>
__device__ float window_dot(const T* fmap, int j, int H, int W, int y, int x,
                            const float* g) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  const T* row = fmap + ((static_cast<size_t>(j) * H + y) * W + x) * kC;
  float acc = 0.0f;
#pragma unroll 4
  for (int c = 0; c < kC; c += 8) {
    float f[8];
    load8(row + c, f);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = fmaf(f[q], g[c + q], acc);
  }
  return acc;
}

// 441 blended outputs of one level from the raw windows w_s [9][8][8]
__device__ void blend(const float* w_s, const Geo& geo, int l, float* o_s,
                      int t, int nthreads) {
  for (int i = t; i < kDO * kDO * kNP; i += nthreads) {
    // output index i = (dx * 7 + dy) * 9 + pixel
    const int dx = i / (kDO * kNP);
    const int dy = (i / kNP) % kDO;
    const int p = i % kNP;
    const float fx = geo.fx[p], fy = geo.fy[p];
    const float* c = w_s + p * kD * kD + dy * kD + dx;
    o_s[2 * i + l] = (1.0f - fx) * (1.0f - fy) * c[0] +
                     fx * (1.0f - fy) * c[1] + (1.0f - fx) * fy * c[kD] +
                     fx * fy * c[kD + 1];
  }
}

template <typename T>
__device__ void load_patch(const T* gmap, size_t k, float* g_s, int t,
                           int nthreads) {
  // gmap[k] is [C, 3, 3]: element i = c * 9 + p
  for (int i = t; i < kNP * kC; i += nthreads)
    g_s[(i % kNP) * kC + i / kNP] = to_float(gmap[k * kNP * kC + i]);
}

// The surfaces kernel: out is [E, 2, 9, 16, RW] surfaces over the full
// region, zero for invalid edges.
template <int RW, typename T>
__global__ void __launch_bounds__(kRH * RW)
region_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
              const T* __restrict__ fmap2, const float* __restrict__ coords,
              const int* __restrict__ kk, const int* __restrict__ jj,
              const unsigned char* __restrict__ valid,
              float* __restrict__ out, int H1, int W1, int H2, int W2) {
  constexpr int kThreads = kRH * RW;
  constexpr int kPos = kRH * RW;
  extern __shared__ float4 dyn_smem[];
  float* g_s = reinterpret_cast<float*>(dyn_smem);  // [9][128]
  float* reg_s = g_s + kNP * kC;                     // [kPos][kCS]
  __shared__ Geo geo;

  const int e = blockIdx.x;
  const int t = threadIdx.x;
  if (!valid[e]) {
    for (int i = t; i < 2 * kNP * kPos; i += kThreads)
      out[static_cast<size_t>(e) * 2 * kNP * kPos + i] = 0.0f;
    return;
  }
  const int j = jj[e];
  load_patch(gmap, static_cast<size_t>(kk[e]), g_s, t, kThreads);
  const float* cp = coords + static_cast<size_t>(e) * kNP * 2;

  for (int l = 0; l < 2; ++l) {
    const T* fmap = l ? fmap2 : fmap1;
    const int H = l ? H2 : H1;
    const int W = l ? W2 : W1;
    __syncthreads();  // g_s written; the previous level's smem consumed
    if (t == 0) edge_geometry<RW>(cp, l ? 4.0f : 1.0f, H, W, geo);
    __syncthreads();
    const int oy = geo.oy, ox = geo.ox;

    float acc[kNP];
#pragma unroll
    for (int p = 0; p < kNP; ++p) acc[p] = 0.0f;
    for (int c0 = 0; c0 < kC; c0 += kCH) {
      for (int i = t; i < kPos * (kCH / 8); i += kThreads) {
        const int pos = i / (kCH / 8);
        const int q = i % (kCH / 8);
        const int y = oy + pos / RW;
        const int x = ox + pos % RW;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (y >= 0 && y < H && x >= 0 && x < W)
          load8(fmap + ((static_cast<size_t>(j) * H + y) * W + x) * kC +
                    c0 + 8 * q, f);
        float4* dst = reinterpret_cast<float4*>(reg_s + pos * kCS + 8 * q);
        dst[0] = make_float4(f[0], f[1], f[2], f[3]);
        dst[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
      __syncthreads();
      const float4* r4 = reinterpret_cast<const float4*>(reg_s + t * kCS);
#pragma unroll
      for (int c = 0; c < kCH / 4; ++c) {
        const float4 r = r4[c];
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const float4 g =
              reinterpret_cast<const float4*>(g_s + p * kC + c0)[c];
          acc[p] = fmaf(r.x, g.x, acc[p]);
          acc[p] = fmaf(r.y, g.y, acc[p]);
          acc[p] = fmaf(r.z, g.z, acc[p]);
          acc[p] = fmaf(r.w, g.w, acc[p]);
        }
      }
      __syncthreads();
    }
    // position t = y * RW + x of the full region
    float* so = out + (static_cast<size_t>(e) * 2 + l) * kNP * kPos;
#pragma unroll
    for (int p = 0; p < kNP; ++p) so[p * kPos + t] = acc[p];
  }
}

// The split pair's second kernel: windows from x16 surfaces
// [E, 2, 9, 16, 16], spill windows from the map, the blend.
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
extract_kernel(const float* __restrict__ surf, const T* __restrict__ gmap,
               const T* __restrict__ fmap1, const T* __restrict__ fmap2,
               const float* __restrict__ coords, const int* __restrict__ kk,
               const int* __restrict__ jj,
               const unsigned char* __restrict__ valid,
               float* __restrict__ out, unsigned char* __restrict__ spill_out,
               int H1, int W1, int H2, int W2) {
  constexpr int RW = 16;
  constexpr int kPos = kRH * RW;
  __shared__ float g_s[kNP * kC];
  __shared__ Geo geo;
  __shared__ float w_s[kNP * kD * kD];
  __shared__ float o_s[kOut];

  const int e = blockIdx.x;
  const int t = threadIdx.x;
  if (!valid[e]) {
    for (int i = t; i < kOut; i += kWinThreads)
      out[static_cast<size_t>(e) * kOut + i] = 0.0f;
    if (t == 0) spill_out[e] = 0;
    return;
  }
  const int j = jj[e];
  load_patch(gmap, static_cast<size_t>(kk[e]), g_s, t, kWinThreads);
  const float* cp = coords + static_cast<size_t>(e) * kNP * 2;
  const int p = t / (kD * kD);
  const int a = (t / kD) % kD;
  const int b = t % kD;
  int spilled = 0;

  for (int l = 0; l < 2; ++l) {
    const T* fmap = l ? fmap2 : fmap1;
    const int H = l ? H2 : H1;
    const int W = l ? W2 : W1;
    __syncthreads();
    if (t == 0) edge_geometry<RW>(cp, l ? 4.0f : 1.0f, H, W, geo);
    __syncthreads();
    float w = 0.0f;
    if (geo.fit[p])
      w = surf[((static_cast<size_t>(e) * 2 + l) * kNP + p) * kPos +
               (geo.ys[p] + a - geo.oy) * RW + geo.xs[p] + b - geo.ox];
    else if (geo.spill[p])
      w = window_dot(fmap, j, H, W, geo.ys[p] + a, geo.xs[p] + b,
                     g_s + p * kC);
    w_s[t] = w;
    __syncthreads();
    blend(w_s, geo, l, o_s, t, kWinThreads);
    spilled |= geo.any_spill;
  }
  __syncthreads();
  float* orow = out + static_cast<size_t>(e) * kOut;
  for (int i = t; i < kOut; i += kWinThreads) orow[i] = o_s[i];
  if (t == 0) spill_out[e] = static_cast<unsigned char>(spilled);
}

template <int RW, typename T>
int launch_region(const void* gmap, const void* fmap1, const void* fmap2,
                  const void* coords, const void* kk, const void* jj,
                  const void* valid, void* out, int E, int H1, int W1, int H2,
                  int W2, cudaStream_t st) {
  constexpr int kPos = kRH * RW;
  const size_t smem = (kNP * kC + kPos * kCS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      region_kernel<RW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  region_kernel<RW, T><<<E, kRH * RW, smem, st>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), H1,
      W1, H2, W2);
  return static_cast<int>(cudaGetLastError());
}

template <int RW>
int dispatch_region(const void* gmap, const void* fmap1, const void* fmap2,
                    const void* coords, const void* kk, const void* jj,
                    const void* valid, void* out, int E, int H1, int W1,
                    int H2, int W2, int feat_bf16, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16)
    return launch_region<RW, __nv_bfloat16>(gmap, fmap1, fmap2, coords, kk,
                                            jj, valid, out, E, H1, W1, H2, W2,
                                            st);
  return launch_region<RW, float>(gmap, fmap1, fmap2, coords, kk, jj, valid,
                                  out, E, H1, W1, H2, W2, st);
}

}  // namespace

// Arguments as `wv3d_corr_pyramid` (csrc/corr_box.cu): gmap [S, 128, 3, 3],
// fmap1 [F, H1, W1, 128], fmap2 [F, H2, W2, 128] in bf16 (feat_bf16 != 0)
// or fp32; coords [E, 3, 3, 2] fp32; kk, jj [E] int32 in [0, S) and
// [0, F); valid [E] bool. Each returns the cudaError_t of its launch.
// surf [E, 2, 9, 16, 16] fp32: the x16 surfaces of both levels.
extern "C" int wv3d_corr_region_surfaces_x16(
    const void* gmap, const void* fmap1, const void* fmap2,
    const void* coords, const void* kk, const void* jj, const void* valid,
    void* surf, int E, int H1, int W1, int H2, int W2, int feat_bf16,
    void* stream) {
  return dispatch_region<16>(gmap, fmap1, fmap2, coords, kk, jj, valid, surf,
                             E, H1, W1, H2, W2, feat_bf16, stream);
}

// surf as written by wv3d_corr_region_surfaces_x16; out [E, 882] fp32 and
// spill [E] uint8 (1 where a valid edge took the spill path at either
// level).
extern "C" int wv3d_corr_region_extract_x16(
    const void* surf, const void* gmap, const void* fmap1, const void* fmap2,
    const void* coords, const void* kk, const void* jj, const void* valid,
    void* out, void* spill, int E, int H1, int W1, int H2, int W2,
    int feat_bf16, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(surf);
  const float* c = static_cast<const float*>(coords);
  const int* k = static_cast<const int*>(kk);
  const int* j = static_cast<const int*>(jj);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* o = static_cast<float*>(out);
  unsigned char* sp = static_cast<unsigned char*>(spill);
  if (feat_bf16) {
    extract_kernel<__nv_bfloat16><<<E, kWinThreads, 0, st>>>(
        s, static_cast<const __nv_bfloat16*>(gmap),
        static_cast<const __nv_bfloat16*>(fmap1),
        static_cast<const __nv_bfloat16*>(fmap2), c, k, j, v, o, sp, H1, W1,
        H2, W2);
  } else {
    extract_kernel<float><<<E, kWinThreads, 0, st>>>(
        s, static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), c, k, j, v, o, sp, H1, W1, H2, W2);
  }
  return static_cast<int>(cudaGetLastError());
}
