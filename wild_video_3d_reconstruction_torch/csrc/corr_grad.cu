// The adjoint of the patch correlation over a two-level feature pyramid
// (Hopper, sm_90a), for fp32 features: the backward of the correlation
// body of csrc/corr_box.cu on the training path.
//
// Replaces no TPU kernel. The JAX package trains through the plain
// `ops/corr.py:patch_corr_pyramid`, which XLA differentiates; the port's
// correlation on the card is the hand-written body of TPU kernel #1
// (ops/pallas_corr.py:83), so its gradient has to be written by hand too
// (the reference's counterpart is the `altcorr` backward,
// dpvo/altcorr/correlation_kernel.cu). It computes the exact adjoint of
// `ops/corr.py:patch_corr_pyramid`: for every valid edge e, patch pixel p
// and level l (scale 1 or 1/4), with g = gmap[kk[e]][:, p] and F =
// fmap_l[jj[e]],
//   1. dc[a, b] over the 8x8 window: the transpose of the bilinear blend
//      of the 7x7 outputs (grad_out[e] in the (dx, dy, pi, pj, level)
//      order), with the forward's fp32 weights wx = x - floor(x), wy = y -
//      floor(y) at x = coords / scale; positions off the map take none;
//   2. grad_gmap[kk[e]][:, p] += sum_ab dc[a, b] F[ys + a, xs + b, :];
//   3. grad_fmap_l[jj[e]][ys + a, xs + b, :] += dc[a, b] g,
// with the window start (ys, xs) = floor(clamp(coords / scale)) - 3, the
// coordinates clamped to +-1e6 (NaN to +1e6) before the floor as in the
// forward. Rows of invalid edges contribute nothing. The outputs are
// zero-initialised by the wrapper (`ops/corr.py:corr_pyramid_backward`).
//
// Bound. Device-memory bytes: grad_out (3.5 KB a valid edge), the edges'
// patch features, the in-map window positions of both levels (each once),
// the coordinates, and the three gradients written once (grad_fmap1 is as
// large as fmap1). The arithmetic is 4 flops per channel and in-map
// window position (the product into grad_gmap, the product into
// grad_fmap), fp32 SIMT: far under the rate that would bound it. What the
// kernel spends beyond the bytes is its fp32 atomics: each in-map window
// position of each (edge, pixel, level) adds its 128 channels into
// grad_fmap at L2, and the nine windows of a compact patch overlap about
// 6x, as do the windows of the patches that look into one frame.
//
// Design. The simple one: a warp per (edge, pixel), eight warps a block,
// no block barrier. The lane holds four channels of g (the patch pixel's
// 128 features) and of its grad_gmap sum. Per level, the lanes compute
// the 64 values of dc (two each) from the 49 entries of grad_out into the
// warp's 256 bytes of shared memory; then for each in-map window position
// the warp reads the 512-byte feature row of F once (a float4 a lane,
// coalesced), adds dc * F into its grad_gmap sum and dc * g into
// grad_fmap with fp32 atomicAdd (the hardware's red.global.add). After
// both levels the lane adds its four grad_gmap sums (atomics: the T edges
// of a patch share kk). Atomics add in the order the warps arrive, so two
// calls can differ in the last bits (chip_smoke.py states the tolerance).
// A faster design stages a patch's nine overlapping windows (the
// forward's 12x12 box) in shared memory and flushes the box once, about
// 6x fewer atomics (ROADMAP, Hopper follow-ups).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;               // feature channels
constexpr int kNP = 9;                // patch pixels (3x3)
constexpr int kR = 3;                 // correlation radius
constexpr int kD = 2 * kR + 2;        // raw window side (8)
constexpr int kDO = 2 * kR + 1;       // blended side (7)
constexpr int kWarps = 8;             // (edge, pixel) items per block
constexpr float kCoordLim = 1e6f;

// NaN -> +lim, then clamp to [-lim, lim] (as the forward)
__device__ __forceinline__ float clamp_coord(float v) {
  return v != v ? kCoordLim : fminf(fmaxf(v, -kCoordLim), kCoordLim);
}

// grad_out entry of blended output (oy, ox) of pixel p at level l, or 0
// outside the 7x7 output
__device__ __forceinline__ float grad_at(const float* __restrict__ go,
                                         int oy, int ox, int p, int l) {
  if (oy < 0 || oy >= kDO || ox < 0 || ox >= kDO) return 0.0f;
  return __ldg(go + ((ox * kDO + oy) * kNP + p) * 2 + l);
}

__global__ void __launch_bounds__(kWarps * 32)
corr_backward_kernel(const float* __restrict__ grad_out,
                     const float* __restrict__ gmap,
                     const float* __restrict__ fmap1,
                     const float* __restrict__ fmap2,
                     const float* __restrict__ coords,
                     const int* __restrict__ kk, const int* __restrict__ jj,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ grad_gmap,
                     float* __restrict__ grad_fmap1,
                     float* __restrict__ grad_fmap2, int E, int H1, int W1,
                     int H2, int W2) {
  __shared__ float dc_s[kWarps][kD * kD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= static_cast<long long>(E) * kNP) return;
  const int e = static_cast<int>(item / kNP);
  const int p = static_cast<int>(item % kNP);
  if (!valid[e]) return;
  const long long k = kk[e];
  const long long f = jj[e];
  const int c0 = 4 * lane;

  float g[4], gg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[i] = __ldg(gmap + (k * kC + c0 + i) * kNP + p);
    gg[i] = 0.0f;
  }
  const float* go = grad_out + static_cast<long long>(e) * (2 * kDO * kDO *
                                                           kNP);
  const float cx = __ldg(coords + (static_cast<long long>(e) * kNP + p) * 2);
  const float cy = __ldg(coords + (static_cast<long long>(e) * kNP + p) * 2 +
                         1);
  float* dc = dc_s[warp];

  for (int l = 0; l < 2; ++l) {
    const float inv_s = l ? 0.25f : 1.0f;
    const int H = l ? H2 : H1;
    const int W = l ? W2 : W1;
    const float* F = l ? fmap2 : fmap1;
    float* gF = l ? grad_fmap2 : grad_fmap1;
    const float x = cx * inv_s;
    const float y = cy * inv_s;
    const int ys = static_cast<int>(floorf(clamp_coord(y))) - kR;
    const int xs = static_cast<int>(floorf(clamp_coord(x))) - kR;
    if (ys <= -kD || ys >= H || xs <= -kD || xs >= W) continue;  // off map
    const float wx = x - floorf(x);
    const float wy = y - floorf(y);
    const float w00 = (1.0f - wx) * (1.0f - wy);
    const float w01 = wx * (1.0f - wy);
    const float w10 = (1.0f - wx) * wy;
    const float w11 = wx * wy;
    __syncwarp();  // the previous level's reads of dc are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = lane + 32 * h;
      const int a = pos / kD;
      const int b = pos % kD;
      // out[oy][ox] = w00 c[oy][ox] + w01 c[oy][ox+1] + w10 c[oy+1][ox]
      //             + w11 c[oy+1][ox+1]
      dc[pos] = w00 * grad_at(go, a, b, p, l) +
                w01 * grad_at(go, a, b - 1, p, l) +
                w10 * grad_at(go, a - 1, b, p, l) +
                w11 * grad_at(go, a - 1, b - 1, p, l);
    }
    __syncwarp();
    for (int a = 0; a < kD; ++a) {
      const int yy = ys + a;
      if (yy < 0 || yy >= H) continue;
      for (int b = 0; b < kD; ++b) {
        const int xx = xs + b;
        if (xx < 0 || xx >= W) continue;
        const float d = dc[a * kD + b];
        const long long row = ((f * H + yy) * W + xx) * kC + c0;
        const float4 fv = __ldg(reinterpret_cast<const float4*>(F + row));
        gg[0] = fmaf(d, fv.x, gg[0]);
        gg[1] = fmaf(d, fv.y, gg[1]);
        gg[2] = fmaf(d, fv.z, gg[2]);
        gg[3] = fmaf(d, fv.w, gg[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) atomicAdd(gF + row + i, d * g[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    atomicAdd(grad_gmap + (k * kC + c0 + i) * kNP + p, gg[i]);
}

}  // namespace

// grad_out [E, 882] fp32; gmap [S, 128, 3, 3], fmap1 [F, H1, W1, 128],
// fmap2 [F, H2, W2, 128] fp32, 16-byte aligned; coords [E, 3, 3, 2] fp32;
// kk, jj [E] int32 already reduced into [0, S) and [0, F); valid [E]
// bool; grad_gmap, grad_fmap1, grad_fmap2 shaped as gmap, fmap1, fmap2,
// zero-initialised by the caller (the kernel adds into them). Returns the
// cudaError_t of the launch.
extern "C" int wv3d_corr_pyramid_backward(
    const void* grad_out, const void* gmap, const void* fmap1,
    const void* fmap2, const void* coords, const void* kk, const void* jj,
    const void* valid, void* grad_gmap, void* grad_fmap1, void* grad_fmap2,
    int E, int H1, int W1, int H2, int W2, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const long long items = static_cast<long long>(E) * kNP;
  const int grid = static_cast<int>((items + kWarps - 1) / kWarps);
  corr_backward_kernel<<<grid, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_out), static_cast<const float*>(gmap),
      static_cast<const float*>(fmap1), static_cast<const float*>(fmap2),
      static_cast<const float*>(coords), static_cast<const int*>(kk),
      static_cast<const int*>(jj), static_cast<const unsigned char*>(valid),
      static_cast<float*>(grad_gmap), static_cast<float*>(grad_fmap1),
      static_cast<float*>(grad_fmap2), E, H1, W1, H2, W2);
  return static_cast<int>(cudaGetLastError());
}
