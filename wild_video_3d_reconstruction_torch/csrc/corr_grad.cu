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
// large as fmap1): 97.8 MB at the training shape (E = 2048, 1792 live,
// fp32 maps [8, 96, 128, 128] and [8, 24, 32, 128]), 0.029 ms at 3.35
// TB/s. The arithmetic is 4 flops per channel and in-map window position
// (the product into grad_gmap, the product into grad_fmap), 0.59 GFLOP
// there, 0.009 ms of the fp32 SIMT rate: fp32 SIMT, no TF32 (which would
// round the features to 10 bits and break the 1e-5 agreement with the
// plain version), since the math is far under the rate that would bound
// it. What a kernel spends beyond the bytes is its reductions into
// grad_fmap at L2: the nine 8x8 windows of a compact patch overlap about
// 6x at /4 (their union is about 10x10 positions against 9 x 64) and
// more at /16 (9x9), and the patches that look into one frame overlap
// again. A warp per (edge, pixel) with scalar atomics (the first design)
// issued 9 x 2 x 64 x 128 fp32 atomics per live edge.
//
// Design. The forward's box rule (csrc/corr_box.cu, `ops/corr.py:box_plan`
// is the plain mirror), so the two kernels agree on which pixel goes
// where. A block of 256 threads (8 warps) takes kEdgesPerBlock edges, each
// at both levels, as items, one after the other. Per item:
//   1. Geometry (warp 0). The window starts of the pixels whose window
//      overlaps the map give the box origin (min ys, min xs); a pixel
//      whose window lies within kBox x kBox positions from there is in the
//      box; one that overlaps the map but does not fit takes the per-pixel
//      path; a pixel off the map contributes nothing.
//   2. dc once per item. The edge's 882-float grad_out row is read into
//      shared memory in one coalesced pass, once for both levels. From it,
//      with the forward's fp32 weights and clamp, each thread computes the
//      transposed blend at one box position for the nine pixels, dc_box[pos,
//      p] (0 where pixel p's window misses pos or p is not in the box),
//      together with the map row of pos where some in-box window covers it
//      and it lies on the map (else -1); and the 8x8 dc of each per-pixel
//      pixel.
//   3. The feature box of fmap_l[jj[e]] (at most 144 positions x 128 fp32,
//      72 KB) is staged in shared memory with 16-byte cp.async, issued
//      before step 2 so that the copies fly while dc is computed and the
//      per-pixel pixels are done. Positions off the map are zero-filled by
//      the copy itself. One box buffer: two blocks share an SM (95 696
//      bytes of dynamic shared memory each), and the other block covers
//      this one's wait; a second buffer for the next item would leave one.
//   4. grad_gmap from the box. A thread owns 4 channels (its lane) and a
//      position of the box in every 8 (its warp), keeps the patch features
//      g_p of its channels for the nine pixels in registers, and sums
//      dc_box[pos, p] * F_box[pos, c] for the nine pixels in registers,
//      over every item of a run of edges that share kk (the kk-major
//      training order: `train/forward.py:all_pairs_edges` places the T
//      edges of a patch next to each other). When kk changes, or the
//      block ends, the eight warps' sums meet in shared memory and the
//      block adds them to grad_gmap[kk] (1152 contiguous floats) with 288
//      vector reductions. An edge whose kk differs from its neighbours
//      adds on its own, and a run that crosses a block boundary adds once
//      per block, so any kk order is right.
//   5. Box gradient, one flush. The same thread computes G_box[pos, c] =
//      sum_p dc_box[pos, p] g_p[c] over the in-box pixels in registers and
//      adds it to grad_fmap_l with one 16-byte vector reduction per
//      (covered in-map box position, 4 channels): inline PTX
//      `red.global.add.v4.f32` (sm_90; no returned value), a warp's 32
//      lanes on one 512-byte feature row. For a compact patch that is
//      about (100 + 81) x 32 reductions per edge, against 147 456 scalar
//      atomics in the first design, and 6x fewer bytes into L2.
//      The per-pixel path (first, while the box copies fly) is the first
//      design's scheme restricted to those pixels, with vector reductions:
//      a warp per window column, each in-map position's feature row read
//      once from the map (a float4 a lane) into the pixel's grad_gmap sum,
//      and dc * g_p added to grad_fmap.
// Reductions add in the order the warps arrive, so two calls can differ in
// the last bits (chip_smoke.py states the tolerance). Positions divide by
// the box width with a multiply and a shift (exact for up to 256 positions
// and widths up to 16). The dynamic shared memory is set with
// cudaFuncSetAttribute once per process; every launch is checked with
// cudaGetLastError.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                   // feature channels
constexpr int kC4 = kC / 4;               // float4 pieces of a row (a lane)
constexpr int kNP = 9;                    // patch pixels (3x3)
constexpr int kR = 3;                     // correlation radius
constexpr int kD = 2 * kR + 2;            // raw window side (8)
constexpr int kDO = 2 * kR + 1;           // blended side (7)
constexpr int kRow = 2 * kDO * kDO * kNP; // grad_out floats per edge (882)
constexpr int kBox = 12;                  // staging capacity per side
constexpr int kCap = kBox * kBox;         // staged positions at most
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerBlock = 8;
constexpr int kDcb = 12;                  // floats per box position: dc of
                                          // the 9 pixels, the map row, pad
constexpr int kPatch = kC * kNP;          // floats of one gmap row (1152)
constexpr float kCoordLim = 1e6f;

// dynamic shared memory, in floats: the box, the grad_out row (padded to
// 16 bytes), dc_box, the per-pixel dc, the block's grad_gmap sum, the
// patch features as loaded
constexpr int kBoxF = kCap * kC;
constexpr int kRowF = (kRow + 3) / 4 * 4;
constexpr int kDcbF = kCap * kDcb;
constexpr int kDcpF = kNP * kD * kD;
constexpr int kSmemF = kBoxF + kRowF + kDcbF + kDcpF + 2 * kPatch;
constexpr int kSmem = kSmemF * 4;         // 95 696 bytes

// The geometry of one item (an edge at one level), written by warp 0.
struct ItemGeo {
  int ys[kNP], xs[kNP];   // window starts
  int cls[kNP];           // 0 off the map, 1 in the box, 2 per-pixel
  float fx[kNP], fy[kNP]; // blend weights
  int y0, x0, h, w;       // the staged box
  int magic;              // (4096 + w - 1) / w: pos / w == pos * magic >> 12
  int any;                // some pixel's window overlaps the map
};

// NaN -> +lim, then clamp to [-lim, lim] (as the forward)
__device__ __forceinline__ float clamp_coord(float v) {
  return v != v ? kCoordLim : fminf(fmaxf(v, -kCoordLim), kCoordLim);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Warp 0: the geometry of one item from the edge's coordinates cp [9][2],
// by the forward's rule (csrc/corr_box.cu:item_geometry).
__device__ void item_geometry(const float* cp, int l, int H, int W, int lane,
                              ItemGeo& g) {
  const float inv_s = l ? 0.25f : 1.0f;
  const bool px = lane < kNP;
  const float x = px ? cp[2 * lane] * inv_s : 0.0f;
  const float y = px ? cp[2 * lane + 1] * inv_s : 0.0f;
  const int ys = static_cast<int>(floorf(clamp_coord(y))) - kR;
  const int xs = static_cast<int>(floorf(clamp_coord(x))) - kR;
  const bool on = px && ys > -kD && ys < H && xs > -kD && xs < W;
  const int y0 = warp_min(on ? ys : INT_MAX);
  const int x0 = warp_min(on ? xs : INT_MAX);
  const bool inb = on && ys - y0 <= kBox - kD && xs - x0 <= kBox - kD;
  const int y1 = warp_max(inb ? ys + kD : y0);
  const int x1 = warp_max(inb ? xs + kD : x0);
  if (px) {
    g.ys[lane] = ys;
    g.xs[lane] = xs;
    g.cls[lane] = inb ? 1 : on ? 2 : 0;
    g.fx[lane] = x - floorf(x);
    g.fy[lane] = y - floorf(y);
  }
  if (lane == 0) {
    const bool any = y0 != INT_MAX;
    g.y0 = any ? y0 : 0;
    g.x0 = any ? x0 : 0;
    g.h = any ? y1 - y0 : 0;
    g.w = any ? x1 - x0 : 0;
    g.magic = g.w ? (4096 + g.w - 1) / g.w : 0;
    g.any = any;
  }
}

// dc[a, b] of pixel p at level l: the transposed blend of the row's 7x7
// outputs, out[oy][ox] = w00 c[oy][ox] + w01 c[oy][ox+1] + w10 c[oy+1][ox]
// + w11 c[oy+1][ox+1], output (oy, ox) at ((ox * 7 + oy) * 9 + p) * 2 + l
__device__ __forceinline__ float dc_at(const float* row, int p, int l, int a,
                                       int b, float fx, float fy) {
  auto go = [&](int oy, int ox) {
    return oy >= 0 && oy < kDO && ox >= 0 && ox < kDO
               ? row[((ox * kDO + oy) * kNP + p) * 2 + l]
               : 0.0f;
  };
  return (1.0f - fx) * (1.0f - fy) * go(a, b) +
         fx * (1.0f - fy) * go(a, b - 1) + (1.0f - fx) * fy * go(a - 1, b) +
         fx * fy * go(a - 1, b - 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// p[0..3] += v in one 16-byte reduction at L2 (p 16-byte aligned)
__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                   __cvta_generic_to_global(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float d,
                                     const float (&v)[4]) {
  acc.x = fmaf(d, v[0], acc.x);
  acc.y = fmaf(d, v[1], acc.y);
  acc.z = fmaf(d, v[2], acc.z);
  acc.w = fmaf(d, v[3], acc.w);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float d,
                                     const float4& v) {
  acc[0] = fmaf(d, v.x, acc[0]);
  acc[1] = fmaf(d, v.y, acc[1]);
  acc[2] = fmaf(d, v.z, acc[2]);
  acc[3] = fmaf(d, v.w, acc[3]);
}

// The eight warps' grad_gmap sums gg meet in the block's sum gsum_s
// (shared memory, [128][9]); the block adds it to grad_gmap[k] (contiguous)
// with 16-byte reductions and clears it. Called by the whole block.
__device__ __forceinline__ void flush_gmap(float (&gg)[kNP][4], float* gsum_s,
                                           float* grad_gmap, int k, int t,
                                           int lane) {
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      atomicAdd(gsum_s + (4 * lane + i) * kNP + p, gg[p][i]);
      gg[p][i] = 0.0f;
    }
  __syncthreads();
  float4* s4 = reinterpret_cast<float4*>(gsum_s);
  for (int i = t; i < kPatch / 4; i += kThreads) {
    red_add_v4(grad_gmap + static_cast<size_t>(k) * kPatch + 4 * i, s4[i]);
    s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
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
  extern __shared__ float4 dyn_smem4[];
  float* box_s = reinterpret_cast<float*>(dyn_smem4);  // [kCap][kC]
  float* row_s = box_s + kBoxF;                        // [882]
  float* dcb_s = row_s + kRowF;                        // [kCap][kDcb]
  float* dcp_s = dcb_s + kDcbF;                        // [9][64]
  float* gsum_s = dcp_s + kDcpF;                       // [kC][9]
  float* gin_s = gsum_s + kPatch;                      // [kC][9]
  __shared__ ItemGeo geo;
  __shared__ float c_s[kEdgesPerBlock][kNP * 2];
  __shared__ int k_s[kEdgesPerBlock], j_s[kEdgesPerBlock];
  __shared__ int v_s[kEdgesPerBlock];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int e0 = blockIdx.x * kEdgesPerBlock;
  const int ne = min(kEdgesPerBlock, E - e0);
  for (int i = t; i < ne * kNP * 2; i += kThreads)
    c_s[i / (kNP * 2)][i % (kNP * 2)] =
        coords[static_cast<size_t>(e0) * kNP * 2 + i];
  if (t < ne) {
    k_s[t] = kk[e0 + t];
    j_s[t] = jj[e0 + t];
    v_s[t] = valid[e0 + t];
  }
  for (int i = t; i < kPatch; i += kThreads) gsum_s[i] = 0.0f;
  __syncthreads();

  // this thread's 4 channels of the nine patch features, and of its
  // grad_gmap sums over the current run of edges that share kk
  float g[kNP][4], gg[kNP][4];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[p][i] = gg[p][i] = 0.0f;

  int cur_k = -1;
  for (int q = 0; q < ne; ++q) {
    if (!v_s[q]) continue;                 // block-uniform
    const int e = e0 + q;
    const int k = k_s[q];
    const int j = j_s[q];
    if (k != cur_k) {
      if (cur_k >= 0) flush_gmap(gg, gsum_s, grad_gmap, cur_k, t, lane);
      const float4* src = reinterpret_cast<const float4*>(gmap) +
                          static_cast<size_t>(k) * (kPatch / 4);
      for (int i = t; i < kPatch / 4; i += kThreads)
        reinterpret_cast<float4*>(gin_s)[i] = __ldg(src + i);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kNP; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) g[p][i] = gin_s[(4 * lane + i) * kNP + p];
      cur_k = k;
    }
    // the edge's grad_out row, once for both levels
    for (int i = t; i < kRow; i += kThreads)
      row_s[i] = __ldg(grad_out + static_cast<size_t>(e) * kRow + i);

    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1;
      const int W = l ? W2 : W1;
      if (warp == 0) item_geometry(c_s[q], l, H, W, lane, geo);
      __syncthreads();                     // geo and row_s
      if (geo.any) {                       // block-uniform
        const float* F = l ? fmap2 : fmap1;
        float* gF = l ? grad_fmap2 : grad_fmap1;
        const int y0 = geo.y0, x0 = geo.x0, bw = geo.w, magic = geo.magic;
        const int npos = geo.h * bw;
        const size_t fbase = static_cast<size_t>(j) * H;

        // 3. stage the box; lanes take consecutive 16-byte pieces of a
        // position (whole 128-byte lines); off the map the copy fills zeros
        for (int i = t; i < npos * kC4; i += kThreads) {
          const int pos = i / kC4;
          const int ch = i % kC4;
          const int ry = (pos * magic) >> 12;
          const int y = y0 + ry;
          const int x = x0 + pos - ry * bw;
          const bool in = y >= 0 && y < H && x >= 0 && x < W;
          const float* src =
              in ? F + ((fbase + y) * W + x) * kC + 4 * ch : F;
          cp_async16(box_s + pos * kC + 4 * ch, src, in ? 16 : 0);
        }
        cp_async_commit();

        // 2. dc_box by box position (a thread each) and its map row; dc of
        // the per-pixel pixels by window position
        if (t < npos) {
          const int ry = (t * magic) >> 12;
          const int y = y0 + ry;
          const int x = x0 + t - ry * bw;
          float d[kNP];
          bool covered = false;
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            const int a = y - geo.ys[p];
            const int b = x - geo.xs[p];
            const bool hit = geo.cls[p] == 1 &&
                             static_cast<unsigned>(a) < kD &&
                             static_cast<unsigned>(b) < kD;
            d[p] = hit ? dc_at(row_s, p, l, a, b, geo.fx[p], geo.fy[p])
                       : 0.0f;
            covered |= hit;
          }
          const int mrow = covered && y >= 0 && y < H && x >= 0 && x < W
                               ? static_cast<int>((fbase + y) * W + x)
                               : -1;
          float4* o = reinterpret_cast<float4*>(dcb_s + t * kDcb);
          o[0] = make_float4(d[0], d[1], d[2], d[3]);
          o[1] = make_float4(d[4], d[5], d[6], d[7]);
          o[2] = make_float4(d[8], __int_as_float(mrow), 0.0f, 0.0f);
        }
        for (int i = t; i < kDcpF; i += kThreads) {
          const int p = i / (kD * kD);
          if (geo.cls[p] == 2)
            dcp_s[i] = dc_at(row_s, p, l, (i / kD) % kD, i % kD, geo.fx[p],
                             geo.fy[p]);
        }
        __syncthreads();

        // the per-pixel path, while the box copies fly: warp w takes window
        // column w, lane the channels 4 lane .. 4 lane + 3
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          if (geo.cls[p] != 2) continue;   // block-uniform
          const int x = geo.xs[p] + warp;
          if (x < 0 || x >= W) continue;   // warp-uniform
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int a = 0; a < kD; ++a) {
            const int y = geo.ys[p] + a;
            if (y < 0 || y >= H) continue;
            const float d = dcp_s[p * kD * kD + a * kD + warp];
            const size_t off = ((fbase + y) * W + x) * kC + 4 * lane;
            fma4(acc, d, __ldg(reinterpret_cast<const float4*>(F + off)));
            float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            fma4(s, d, g[p]);
            red_add_v4(gF + off, s);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) gg[p][i] += acc[i];
        }

        // 4, 5. the box: grad_gmap sums and one flush per covered in-map
        // position
        cp_async_wait_all();
        __syncthreads();
        const float4* box4 = reinterpret_cast<const float4*>(box_s);
        const float4* dcb4 = reinterpret_cast<const float4*>(dcb_s);
        for (int pos = warp; pos < npos; pos += kWarps) {
          const float4 f = box4[pos * kC4 + lane];
          const float4 da = dcb4[pos * 3];
          const float4 db = dcb4[pos * 3 + 1];
          const float4 dz = dcb4[pos * 3 + 2];
          const float d[kNP] = {da.x, da.y, da.z, da.w, db.x,
                                db.y, db.z, db.w, dz.x};
          float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            fma4(s, d[p], g[p]);
            fma4(gg[p], d[p], f);
          }
          const int mrow = __float_as_int(dz.y);
          if (mrow >= 0)
            red_add_v4(gF + static_cast<size_t>(mrow) * kC + 4 * lane, s);
        }
      }
      __syncthreads();                     // geo, box, dc free again
    }
  }
  if (cur_k >= 0) flush_gmap(gg, gsum_s, grad_gmap, cur_k, t, lane);
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
  // once per process (a launch inside a CUDA graph capture then makes no
  // other runtime call)
  static const cudaError_t attr = [] {
    cudaError_t err = cudaFuncSetAttribute(
        corr_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err == cudaSuccess)  // two blocks per SM need most of its smem
      err = cudaFuncSetAttribute(
          corr_backward_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (E + kEdgesPerBlock - 1) / kEdgesPerBlock;
  corr_backward_kernel<<<grid, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_out), static_cast<const float*>(gmap),
      static_cast<const float*>(fmap1), static_cast<const float*>(fmap2),
      static_cast<const float*>(coords), static_cast<const int*>(kk),
      static_cast<const int*>(jj), static_cast<const unsigned char*>(valid),
      static_cast<float*>(grad_gmap), static_cast<float*>(grad_fmap1),
      static_cast<float*>(grad_fmap2), E, H1, W1, H2, W2);
  return static_cast<int>(cudaGetLastError());
}
