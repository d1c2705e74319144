// The split x16 region correlation pair's second kernel, the window
// extraction (Hopper, sm_90a).
//
// Replaces the JAX package's standalone window extraction
// `_extract_kernel4` (ops/pallas_corr.py:230, `_extract_windows4`), which
// `patch_corr_pyramid_pallas(extract="pallas")` runs after the x16
// surfaces of `_corr_kernel4` (:123, `_surfaces4`). The pair computes
// `ops/corr.py`'s `patch_corr_pyramid`: for every edge, patch pixel and
// level, the 128-d products of gmap[kk] with the 8x8 window of fmap[jj] at
// floor(coords / scale) - 3 (zero off the map), blended bilinearly to 7x7,
// written as the [E, 882] feature (dx, dy, pi, pj, level). The plain
// version and the geometry are in `ops/corr_region.py`. The surfaces
// [E, 2, 9, 16, 16] that this kernel reads come from `surfaces_kernel` of
// `csrc/corr_box.cu` (`wv3d_corr_region_surfaces_x16`), beside the
// correlation body that the fused and unfused routes run.
//
// Region geometry (per edge and level): the nine window starts (ys, xs);
// the region origin oy = min ys, ox = min xs (the x16 geometry, the only
// one these kernels serve); a pixel fits when its window lies inside the
// 16 x 16 region. The TPU kernels zero the pixels that do not fit; here a
// pixel that does not fit but overlaps the map takes the spill path, its
// window computed straight from the map, so the result is exact for any
// spread. Positions off the map read as zero.
//
// The extract kernel (`extract_kernel`). Bound: device-memory bytes, the
// 8x8 surface window of each fitting pixel, the map and the patch features
// only for spilled pixels, and the 3.5 KB of output per edge (0.132 ms at
// E = 55 296 on compact patches); its blend is a few FLOPs per byte. The
// surfaces are read in 32-byte sectors, so a window row that straddles
// the middle of its 64-byte region row moves 64 bytes for its 32. A
// spilled pixel reads its 8x8 map window, 16 KB in bf16, mostly from L2.
// Design:
//  * one warp per edge and per block, no block barrier, no serial step:
//    the valid flag and the coordinates load together;
//  * the geometry in parallel: lane l * 9 + p computes pixel p at level l,
//    the region origins are warp min-reductions, the fit and spill flags
//    ballots, shared by shuffles;
//  * a fitting window's 8 region rows are 512 contiguous bytes of the
//    surfaces: one 16-byte load per lane and window. No load sits behind
//    a branch, so all 18 issue before the first is used (9 KB in flight
//    per warp): a lane whose 16 bytes hold no window column reads a
//    neighbour's (same sectors), a window that does not fit reads one
//    fixed address and is zeroed by a select; the select of the window is
//    an offset into shared memory;
//  * spilled pixels only: each lane owns 4 of the 128 channels, so each of
//    the window's 64 map positions is one coalesced row read; positions
//    off the map read a clamped position and are zeroed by a select, so
//    the 32 row loads of a half window all issue before the first product;
//    a transpose-sum over the warp (31 shuffles per 32 positions) gives the
//    products; the pixel's patch features are read only then;
//  * the blend from shared memory into registers, both levels of an
//    output pair at once, unrolled, written as coalesced 8-byte stores
//    (the [E, 882] rows are 8-byte aligned; a warp writes 256 contiguous
//    bytes per store).

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
constexpr float kCoordLim = 1e6f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// NaN -> +lim, then clamp to [-lim, lim] (as torch.nan_to_num + clamp)
__device__ __forceinline__ float clamp_coord(float v) {
  return v != v ? kCoordLim : fminf(fmaxf(v, -kCoordLim), kCoordLim);
}

// 4 bf16 or fp32 features -> fp32 (one 8- or 16-byte load)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// One stage of the transpose-sum: lanes that differ in bit OFF swap the
// halves of v[0, 2 OFF) they do not keep; v[0, OFF) then holds sums over
// pairs of lanes.
template <int OFF>
__device__ __forceinline__ void transpose_stage(float* v, int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// v[i] holds this lane's part of the sum of item i (i < 32); afterwards
// v[0] holds the warp's total of item `lane` (31 shuffles for 32 sums).
__device__ __forceinline__ void warp_transpose_sum(float* v, int lane) {
  transpose_stage<16>(v, lane);
  transpose_stage<8>(v, lane);
  transpose_stage<4>(v, lane);
  transpose_stage<2>(v, lane);
  transpose_stage<1>(v, lane);
}

constexpr int kLP = 2 * kNP;            // (level, pixel) pairs: 18
constexpr int kSlab = kD * kRH + 4;     // floats per window slab (+4: banks)
constexpr unsigned kAll = 0xffffffffu;

// One edge's geometry, one (level, pixel) per lane (lane l * 9 + p, lanes
// 0-17); the masks are the warp's. An invalid edge has no window and a
// zero blend weight, so its blend is exactly zero.
struct EdgeGeo {
  int ys, xs;            // window start
  int ry, rx;            // window start in the region
  float fx, fy;          // blend weights (0 for an invalid edge)
  unsigned fit_mask;     // bit l * 9 + p: the window fits the region
  unsigned spill_mask;   // bit l * 9 + p: it does not but overlaps the map
};

// (x, y) of this lane's pixel
__device__ __forceinline__ float2 lane_coords(const float* coords, int e,
                                             int p, bool geo) {
  return geo ? __ldg(reinterpret_cast<const float2*>(coords) +
                     static_cast<size_t>(e) * kNP + p)
             : make_float2(0.f, 0.f);
}

__device__ __forceinline__ EdgeGeo edge_geo(float2 c, bool ok, bool geo,
                                            int l, int H, int W) {
  EdgeGeo g;
  const float s = l ? 4.0f : 1.0f;
  const float x = c.x / s;
  const float y = c.y / s;
  g.fx = ok ? x - floorf(x) : 0.f;
  g.fy = ok ? y - floorf(y) : 0.f;
  g.ys = geo ? static_cast<int>(floorf(clamp_coord(y))) - kR : INT_MAX;
  g.xs = geo ? static_cast<int>(floorf(clamp_coord(x))) - kR : INT_MAX;
  const int oy0 = __reduce_min_sync(kAll, geo && !l ? g.ys : INT_MAX);
  const int ox0 = __reduce_min_sync(kAll, geo && !l ? g.xs : INT_MAX);
  const int oy1 = __reduce_min_sync(kAll, geo && l ? g.ys : INT_MAX);
  const int ox1 = __reduce_min_sync(kAll, geo && l ? g.xs : INT_MAX);
  g.ry = geo ? g.ys - (l ? oy1 : oy0) : 0;
  g.rx = geo ? g.xs - (l ? ox1 : ox0) : 0;
  const bool fit = ok && geo && g.ry <= kRH - kD && g.rx <= kRH - kD;
  const bool over = ok && geo && g.ys > -kD && g.ys < H && g.xs > -kD &&
                    g.xs < W;
  g.fit_mask = __ballot_sync(kAll, fit);
  g.spill_mask = __ballot_sync(kAll, over && !fit);
  return g;
}

// A fitting window's 8 region rows are 512 contiguous bytes of the
// surfaces: one 16-byte load per lane (row lane / 4, columns
// 4 * (lane % 4) + 0..3). No load is behind a branch: where those columns
// hold no window column the lane reads the nearest chunk that does (the
// same sectors, and its slot is never read), and a window that does not
// fit reads the slab's first chunk and is zeroed.
__device__ __forceinline__ void load_windows(const float4* surf4, int e,
                                             const EdgeGeo& g, int lane,
                                             float4 (&buf)[kLP]) {
  constexpr int kPos4 = kRH * kRH / 4;   // float4s per (level, pixel)
  const float4* se = surf4 + static_cast<size_t>(e) * kLP * kPos4;
  const int row4 = lane & ~3;            // the lane's window row, in float4s
  const int c = lane & 3;
#pragma unroll
  for (int sl = 0; sl < kLP; ++sl) {
    const int sry = __shfl_sync(kAll, g.ry, sl);
    const int srx = __shfl_sync(kAll, g.rx, sl);
    const bool fit = g.fit_mask >> sl & 1u;
    const int cq = min(max(c, srx >> 2), (srx + kD - 1) >> 2);
    const float4 v =
        __ldg(se + sl * kPos4 + (fit ? sry * (kRH / 4) + row4 + cq : 0));
    buf[sl] = fit ? v : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The spilled pixels' windows, straight from the map into their slabs
// (columns 0-7): lane owns channels 4 * lane + 0..3, so each of the 64 map
// positions is one coalesced row read, and a transpose-sum per 32
// positions forms the products; the pixel's patch features are read only
// here. A position off the map reads the clamped position and its product
// is zeroed, so no load waits behind a branch.
template <typename T>
__device__ __forceinline__ void spill_windows(
    unsigned spill_mask, int ys, int xs, const T* gk, const T* fmap1,
    const T* fmap2, int j, int H1, int W1, int H2, int W2, int lane,
    float* win) {
  unsigned m = spill_mask;
  while (m) {
    const int sl = __ffs(m) - 1;
    m &= m - 1;
    const int sp = sl % kNP;
    const bool l2 = sl >= kNP;
    const T* fmap = l2 ? fmap2 : fmap1;
    const int H = l2 ? H2 : H1;
    const int W = l2 ? W2 : W1;
    const int y0 = __shfl_sync(kAll, ys, sl);
    const int x0 = __shfl_sync(kAll, xs, sl);
    float gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) gv[i] = to_float(gk[(4 * lane + i) * kNP + sp]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int y = y0 + (32 * half + i) / kD;
        const int x = x0 + i % kD;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
        float f[4];
        load4(fmap + ((static_cast<size_t>(j) * H + min(max(y, 0), H - 1)) *
                          W + min(max(x, 0), W - 1)) * kC + 4 * lane, f);
        v[i] = in ? gv[0] * f[0] + gv[1] * f[1] + gv[2] * f[2] + gv[3] * f[3]
                  : 0.f;
      }
      warp_transpose_sum(v, lane);
      const int pos = 32 * half + lane;
      win[sl * kSlab + (pos / kD) * kRH + pos % kD] = v[0];
    }
  }
}

// The split pair's second kernel: windows from x16 surfaces
// [E, 2, 9, 16, 16], spill windows from the map, the blend; one warp per
// edge.
template <typename T>
__global__ void __launch_bounds__(32)
extract_kernel(const float* __restrict__ surf, const T* __restrict__ gmap,
               const T* __restrict__ fmap1, const T* __restrict__ fmap2,
               const float* __restrict__ coords, const int* __restrict__ kk,
               const int* __restrict__ jj,
               const unsigned char* __restrict__ valid,
               float* __restrict__ out, unsigned char* __restrict__ spill_out,
               int H1, int W1, int H2, int W2) {
  // window slab of (level, pixel) s: 8 rows of 16 floats (the region rows
  // of a fitting window, or the spill window in columns 0-7)
  __shared__ float4 s_win[kLP * kSlab / 4];
  // (fx, fy, column of the window in its slab, -)
  __shared__ float4 s_par[kLP];

  const int lane = threadIdx.x;
  const int e = blockIdx.x;
  const bool geo = lane < kLP;
  const int l = lane >= kNP;
  const int p = lane - l * kNP;
  float* win = reinterpret_cast<float*>(s_win);

  // the valid flag and the coordinates load together
  const EdgeGeo g = edge_geo(lane_coords(coords, e, p, geo), valid[e], geo,
                             l, l ? H2 : H1, l ? W2 : W1);
  float4 buf[kLP];
  load_windows(reinterpret_cast<const float4*>(surf), e, g, lane, buf);
#pragma unroll
  for (int sl = 0; sl < kLP; ++sl) s_win[sl * kSlab / 4 + lane] = buf[sl];
  if (geo)
    s_par[lane] = make_float4(
        g.fx, g.fy, __int_as_float(g.fit_mask >> lane & 1u ? g.rx : 0), 0.f);
  if (g.spill_mask) {
    __syncwarp();  // the zeroed slabs are written before the spill windows
    spill_windows(g.spill_mask, g.ys, g.xs,
                  gmap + static_cast<size_t>(kk[e]) * kNP * kC, fmap1, fmap2,
                  jj[e], H1, W1, H2, W2, lane, win);
  }
  __syncwarp();

  // the blend, both levels of one output pair per lane and step:
  // q = (dx * 7 + dy) * 9 + p, out[2 q + level] (coalesced 8-byte stores)
  float2* orow = reinterpret_cast<float2*>(out + static_cast<size_t>(e) * kOut);
#pragma unroll
  for (int k = 0; k < (kOut / 2 + 31) / 32; ++k) {
    const int q = 32 * k + lane;
    if (q >= kOut / 2) break;
    const int qp = q % kNP;
    const int dy = (q / kNP) % kDO;
    const int dx = q / (kNP * kDO);
    float o[2];
#pragma unroll
    for (int ql = 0; ql < 2; ++ql) {
      const float4 par = s_par[ql * kNP + qp];
      const float* c = win + (ql * kNP + qp) * kSlab + dy * kRH +
                       __float_as_int(par.z) + dx;
      o[ql] = (1.0f - par.x) * (1.0f - par.y) * c[0] +
              par.x * (1.0f - par.y) * c[1] + (1.0f - par.x) * par.y * c[kRH] +
              par.x * par.y * c[kRH + 1];
    }
    orow[q] = make_float2(o[0], o[1]);
  }
  if (lane == 0) spill_out[e] = g.spill_mask != 0;
}

}  // namespace

// Arguments as `wv3d_corr_pyramid` (csrc/corr_box.cu): gmap [S, 128, 3, 3],
// fmap1 [F, H1, W1, 128], fmap2 [F, H2, W2, 128] in bf16 (feat_bf16 != 0)
// or fp32; coords [E, 3, 3, 2] fp32; kk, jj [E] int32 in [0, S) and
// [0, F); valid [E] bool; surf as `wv3d_corr_region_surfaces_x16` writes
// it; out [E, 882] fp32 and spill [E] bytes, 1 where a valid edge took the
// spill path at either level, else 0 (the storage of a bool tensor).
// Returns the cudaError_t of the launch.
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
    extract_kernel<__nv_bfloat16><<<E, 32, 0, st>>>(
        s, static_cast<const __nv_bfloat16*>(gmap),
        static_cast<const __nv_bfloat16*>(fmap1),
        static_cast<const __nv_bfloat16*>(fmap2), c, k, j, v, o, sp, H1, W1,
        H2, W2);
  } else {
    extract_kernel<float><<<E, 32, 0, st>>>(
        s, static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), c, k, j, v, o, sp, H1, W1, H2, W2);
  }
  return static_cast<int>(cudaGetLastError());
}
