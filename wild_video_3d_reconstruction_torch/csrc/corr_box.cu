// Exact patch correlation over a two-level feature pyramid: one body for
// both correlation routes (Hopper, sm_90a).
//
// Replaces the JAX package's TPU kernels `_corr_kernel`
// (ops/pallas_corr.py:83, x32 surfaces), `_corr_kernel4` (:123, x16
// surfaces), `_corr_fused_kernel` (:340, x32 fused) and
// `_corr_fused_kernel4` (:157, x16 fused). All of them serve one function,
// `ops/corr.py:patch_corr_pyramid`: for every edge, patch pixel and level,
// the 128-d products of gmap[kk] with the 8x8 window of fmap[jj] starting
// at floor(coords / scale) - 3 (zero off the map), blended bilinearly to
// 7x7 and written as one [882] fp32 row per edge in the layout the update
// operator reads, (dx, dy, pi, pj, level). Rows of invalid edges are zero.
// The TPU kernels zero the windows that leave their region; this body is
// exact for any spread. It serves the unfused route (`wv3d_corr_pyramid`)
// and the fused one (`wv3d_corr_region_fused_x32/_x16`), which also
// returns the spill flags: per edge, whether a pixel at either level
// overlaps the map but does not fit the x32 or x16 region
// (`ops/corr_region.py:geometry`), the counterpart of the JAX clip count.
// The flags come from the region geometry alone; they do not change how
// the values are computed. The split route's surfaces, the raw x16
// surfaces of `_corr_kernel4` that the extract of `csrc/corr_region.cu`
// reads, come from a second kernel below the body (`surfaces_kernel`,
// `wv3d_corr_region_surfaces_x16`), with its own note; it shares the
// body's geometry and tensor-core helpers.
//
// Bound. Device-memory bytes: the features of the edges' patches, the
// in-map positions of their windows (each once), the coordinates and the
// 3.5 KB output row per edge; the products are ~14 GFLOP, far under the
// tensor cores' rate. What a per-window kernel spends beyond that is
// traffic through L1/L2 (the nine 8x8 windows of a compact patch overlap
// about 6x) and instruction issue for fp32 SIMT products.
//
// Design. A block of 128 threads (4 warps) takes kEdgesPerBlock edges, so
// kEdgesPerBlock * 2 items (an edge at one level), one after the other;
// five bf16 blocks fit an SM. Warp 0 computes each item's geometry (the
// next item's while this item's copies are in flight) from the block's
// coordinates, which sit in shared memory. Per item:
//   * Box. The window starts (ys, xs) of the pixels whose window overlaps
//     the map give the box origin (min ys, min xs). A pixel whose window
//     lies inside the kBox x kBox positions from there is in the box; the
//     staged box is the union of those windows (about 10x10 positions for
//     compact patches at /4, 9x9 at /16; `ops/corr.py:box_plan` is the
//     plain mirror). The capacity, 12x12, holds a patch whose window
//     starts spread up to 4 positions, and lets five blocks share an SM
//     (16x16 lets three; scripts/torch_corr_box_capacity.py times both).
//     The box is staged in shared memory in the stored feature type with
//     16-byte cp.async copies, positions off the map zero-filled by the
//     copy itself (no padded map), in two commit groups of 64 channels:
//     the products of the first group run while the second is in flight,
//     and the other four blocks of the SM cover the wait for the first.
//   * Products, bf16 features: mma.sync m16n8k16 bf16 -> fp32 on the
//     tensor cores. A = the 9 patch rows (padded to 16) x 128 channels,
//     loaded once per edge with ldmatrix into registers and used at both
//     levels; B = 8 box positions per n-tile, read with ldmatrix from rows
//     padded to 272 bytes (conflict-free). Every product of two bf16
//     values is exact in fp32; only the order of the fp32 sums differs
//     from the plain version. fp32 features (no mixed precision) take a
//     SIMT instantiation over the same staged box: no TF32 rounding.
//   * Select. Each surface value S[p, pos] of an in-box pixel is written
//     straight to its place in that pixel's 8x8 window in shared memory.
//     A pixel that overlaps the map but is not in the box takes the
//     per-pixel path: its 8x8 window straight from the map. Windows of
//     pixels off the map are zero.
//   * Blend with fp32 weights, written to the edge's row (level-minor
//     columns, so the two items of an edge fill its row together).
// Positions divide by the box width with a multiply and a shift (exact
// for up to 256 positions and widths up to 16). Dynamic shared memory:
// 43 956 bytes (bf16; 83 124 for fp32), set with cudaFuncSetAttribute once
// per process; every launch is checked with cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 128;                     // feature channels
constexpr int kNP = 9;                      // patch pixels (3x3)
constexpr int kR = 3;                       // correlation radius
constexpr int kD = 2 * kR + 2;              // raw window side (8)
constexpr int kDO = 2 * kR + 1;             // blended side (7)
constexpr int kBlend = kDO * kDO * kNP;     // 441 outputs per level
constexpr int kOut = 2 * kBlend;            // 882
constexpr int kBox = 12;                    // staging capacity per side
constexpr int kCap = kBox * kBox;           // staged positions at most
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerBlock = 4;
constexpr int kGroups = 2;                  // cp.async groups (64 channels)
constexpr int kKPairsPerGroup = kC / 32 / kGroups;       // k-step pairs
constexpr int kTilesPerWarp = (kCap / 8 + kWarps - 1) / kWarps;  // 5
constexpr int kWS = kD * kD + 1;            // floats per pixel window (padded)
constexpr int kPad = 8;                     // JAX map padding (x32 phase)
constexpr float kCoordLim = 1e6f;

template <typename T>
struct Stage {
  static constexpr int kRowBytes = kC * sizeof(T) + 16;  // 272 / 528
  static constexpr int kChunks = kC * sizeof(T) / 16;   // 16-byte copies
  static constexpr int kChunksPerGroup = kChunks / kGroups;
  static constexpr int kSmem = (kCap + kNP) * kRowBytes +
                               kNP * kWS * sizeof(float);
};

// The geometry of one item (an edge at one level), written by warp 0.
struct ItemGeo {
  int ys[kNP], xs[kNP];   // window starts
  int cls[kNP];           // 0 off the map, 1 in the box, 2 per-pixel
  float fx[kNP], fy[kNP]; // blend weights
  int y0, x0, h, w;       // the staged box
  int magic;              // (4096 + w - 1) / w: pos / w == pos * magic >> 12
  int skip;               // the edge is not valid: its row is zero
};

// NaN -> +lim, then clamp to [-lim, lim] (as torch.nan_to_num + clamp)
__device__ __forceinline__ float clamp_coord(float v) {
  return v != v ? kCoordLim : fminf(fmaxf(v, -kCoordLim), kCoordLim);
}

// window start at one level; inv_s = 1 or 1/4 (exact, as division by s)
__device__ __forceinline__ int window_start(float v, float inv_s) {
  return static_cast<int>(floorf(clamp_coord(v * inv_s))) - kR;
}

__device__ __forceinline__ bool overlaps(int ys, int xs, int H, int W) {
  return ys > -kD && ys < H && xs > -kD && xs < W;
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

__device__ __forceinline__ int floor_div16(int a) {
  int q = a / 16;
  if (a % 16 < 0) --q;
  return q;
}

// Warp 0: the geometry of one item from the edge's coordinates cp [9][2].
// The box origin is the least window start of the pixels that overlap the
// map; a pixel is in the box when its window lies within kBox x kBox
// positions from there (`ops/corr.py:box_plan` is the plain mirror).
__device__ void item_geometry(const float* cp, int valid, int l, int H,
                              int W, int lane, ItemGeo& g) {
  const float inv_s = l ? 0.25f : 1.0f;
  const bool px = lane < kNP;
  const float x = px ? cp[2 * lane] * inv_s : 0.0f;
  const float y = px ? cp[2 * lane + 1] * inv_s : 0.0f;
  const int ys = window_start(y, 1.0f);
  const int xs = window_start(x, 1.0f);
  const bool on = px && overlaps(ys, xs, H, W);
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
    g.skip = !valid;
  }
}

// Warp 0: the fused routes' spill flag of one edge, a pixel at either
// level that overlaps the map but does not fit the 16 x rw region
// (`ops/corr_region.py:geometry`).
__device__ int region_spill(const float* cp, int rw, int H1, int W1, int H2,
                            int W2, int lane) {
  int any = 0;
  for (int l = 0; l < 2; ++l) {
    const float inv_s = l ? 0.25f : 1.0f;
    const int H = l ? H2 : H1;
    const int W = l ? W2 : W1;
    const bool px = lane < kNP;
    const int ys = px ? window_start(cp[2 * lane + 1], inv_s) : INT_MAX;
    const int xs = px ? window_start(cp[2 * lane], inv_s) : INT_MAX;
    const int oy = warp_min(ys);
    const int mx = warp_min(xs);
    const int ox = rw == 32 ? floor_div16(mx + kPad) * 16 - kPad : mx;
    any |= __any_sync(~0u, px && overlaps(ys, xs, H, W) &&
                               !(ys - oy <= 16 - kD && xs - ox <= rw - kD));
  }
  return any;
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

// wait until at most n (0 or 1) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(const uint4& u, const __nv_bfloat16*,
                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, const float*,
                                        float* f) {
  const float* v = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = v[k];
}

// <g_p, fmap[j, y, x]> straight from the map (the per-pixel path), with
// g_p a row of the staged patch features; 0 off the map
template <typename T>
__device__ float window_dot(const T* fmap, int j, int H, int W, int y, int x,
                            const T* g) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  constexpr int kPer = 16 / sizeof(T);
  const uint4* row = reinterpret_cast<const uint4*>(
      fmap + ((static_cast<size_t>(j) * H + y) * W + x) * kC);
  const uint4* gr = reinterpret_cast<const uint4*>(g);
  float acc = 0.0f;
#pragma unroll 4
  for (int c = 0; c < kC / kPer; ++c) {
    float f[8], q[8];
    unpack8(__ldg(row + c), static_cast<const T*>(nullptr), f);
    unpack8(gr[c], static_cast<const T*>(nullptr), q);
#pragma unroll
    for (int u = 0; u < kPer; ++u) acc = fmaf(f[u], q[u], acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<T, __nv_bfloat16>::value ? 5
                                                                        : 2)
corr_box_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                const T* __restrict__ fmap2, const float* __restrict__ coords,
                const int* __restrict__ kk, const int* __restrict__ jj,
                const unsigned char* __restrict__ valid,
                float* __restrict__ out, unsigned char* __restrict__ spill_out,
                int spill_rw, int E, int H1, int W1, int H2, int W2) {
  using St = Stage<T>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRB = St::kRowBytes;
  constexpr int kPer = 16 / sizeof(T);      // values per 16-byte copy
  extern __shared__ uint4 dyn_smem[];
  unsigned char* box_s = reinterpret_cast<unsigned char*>(dyn_smem);
  unsigned char* g_s = box_s + kCap * kRB;   // [9] rows of kRB bytes
  float* w_s = reinterpret_cast<float*>(g_s + kNP * kRB);  // [9][kWS]
  __shared__ ItemGeo geo[2];                 // this item's and the next's
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
  __syncthreads();
  // warp 0 writes the geometry of item n (edge n / 2, level n % 2) into
  // geo[n % 2], and the edge's spill flag with its first level
  auto geometry = [&](int n) {
    const int q = n >> 1, l = n & 1;
    item_geometry(c_s[q], v_s[q], l, l ? H2 : H1, l ? W2 : W1, lane,
                  geo[n & 1]);
    if (spill_out != nullptr && l == 0) {
      const int sp = v_s[q] && region_spill(c_s[q], spill_rw, H1, W1, H2, W2,
                                            lane);
      if (lane == 0) spill_out[e0 + q] = static_cast<unsigned char>(sp);
    }
  };
  if (warp == 0) geometry(0);
  __syncthreads();

  uint32_t afrag[kMma ? 8 : 1][4];  // A fragments of the 8 k-steps
  for (int n = 0; n < 2 * ne; ++n) {
    const int q = n >> 1, l = n & 1;
    const ItemGeo& G = geo[n & 1];
    float* orow = out + static_cast<size_t>(e0 + q) * kOut;
    if (G.skip) {
      if (l == 0)
        for (int i = t; i < kBlend; i += kThreads)
          reinterpret_cast<float2*>(orow)[i] = make_float2(0.0f, 0.0f);
      if (warp == 0 && n + 1 < 2 * ne) geometry(n + 1);
    } else {
      const T* fmap = l ? fmap2 : fmap1;
      const int H = l ? H2 : H1;
      const int W = l ? W2 : W1;
      const int j = j_s[q];
      const int y0 = G.y0, x0 = G.x0, bw = G.w, magic = G.magic;
      const int npos = G.h * bw;

      // 1. stage the box, one group of channels per commit group; lanes
      // take consecutive 16-byte pieces of a position, so each copy of a
      // warp covers whole 128-byte lines; off the map the copy fills zeros
      for (int gq = 0; gq < kGroups; ++gq) {
        constexpr int kCPG = St::kChunksPerGroup;
        for (int i = t; i < npos * kCPG; i += kThreads) {
          const int pos = i / kCPG;
          const int ch = gq * kCPG + i % kCPG;
          const int ry = (pos * magic) >> 12;
          const int y = y0 + ry;
          const int x = x0 + pos - ry * bw;
          const bool in = y >= 0 && y < H && x >= 0 && x < W;
          const T* src =
              in ? fmap + ((static_cast<size_t>(j) * H + y) * W + x) * kC +
                       ch * kPer
                 : fmap;
          cp_async16(box_s + pos * kRB + ch * 16, src, in ? 16 : 0);
        }
        cp_async_commit();
      }
      // 2. the patch features as [pixel][channel], once per edge
      if (l == 0) {
        const uint4* g4 = reinterpret_cast<const uint4*>(
            gmap + static_cast<size_t>(k_s[q]) * kNP * kC);
        for (int i = t; i < kNP * kC / kPer; i += kThreads) {
          const uint4 u = __ldg(g4 + i);
          const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int c = (i * kPer + k) / kNP;  // gmap[kk] is [C, 3, 3]
            const int p = (i * kPer + k) % kNP;
            reinterpret_cast<T*>(g_s + p * kRB)[c] = v[k];
          }
        }
      }

      // the next item's geometry, while the copies are in flight
      if (warp == 0 && n + 1 < 2 * ne) geometry(n + 1);

      // 3. the surfaces S[p, pos] of the box, group by group
      const int ntiles = (npos + 7) / 8;
      float acc[kMma ? kTilesPerWarp : 2][kMma ? 4 : kNP];
#pragma unroll
      for (int i = 0; i < (kMma ? kTilesPerWarp : 2); ++i)
#pragma unroll
        for (int k = 0; k < (kMma ? 4 : kNP); ++k) acc[i][k] = 0.0f;
#pragma unroll
      for (int gq = 0; gq < kGroups; ++gq) {
        cp_async_wait_pending(kGroups - 1 - gq);
        __syncthreads();
        if constexpr (kMma) {
          if (l == 0 && gq == 0) {
            // A: matrix i = lane / 8 holds rows 8 * (i & 1) + (0..7) and
            // channels 8 * (i >> 1) + (0..7) of the k-step; rows past the
            // ninth repeat row 8 (their products are never read)
            const int row = min((lane & 7) + ((lane >> 3) & 1) * 8, kNP - 1);
#pragma unroll
            for (int ks = 0; ks < 8; ++ks)
              ldmatrix_x4(afrag[ks],
                          g_s + row * kRB + (ks * 16 + (lane >> 4) * 8) * 2);
          }
#pragma unroll
          for (int i = 0; i < kTilesPerWarp; ++i) {
            const int nt = warp + kWarps * i;
            if (nt < ntiles) {
#pragma unroll
              for (int kp = 0; kp < kKPairsPerGroup; ++kp) {
                // B of k-steps 2 kk2 and 2 kk2 + 1: matrix lane / 8 holds
                // positions 8 nt + (0..7), channels 32 kk2 + 8 (lane / 8)
                const int kk2 = gq * kKPairsPerGroup + kp;
                uint32_t bf[4];
                ldmatrix_x4(bf, box_s + (nt * 8 + (lane & 7)) * kRB +
                                    (kk2 * 32 + (lane >> 3) * 8) * 2);
                mma_bf16(acc[i], afrag[2 * kk2], bf[0], bf[1]);
                mma_bf16(acc[i], afrag[2 * kk2 + 1], bf[2], bf[3]);
              }
            }
          }
        } else {
          constexpr int kCG = kC / kGroups;    // channels per group
          const float* gf = reinterpret_cast<const float*>(g_s);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int pos = t + r * kThreads;
            if (pos < npos) {
              const float4* r4 = reinterpret_cast<const float4*>(
                  box_s + pos * kRB + gq * kCG * sizeof(float));
#pragma unroll 4
              for (int c = 0; c < kCG / 4; ++c) {
                const float4 v = r4[c];
#pragma unroll
                for (int p = 0; p < kNP; ++p) {
                  const float4 g = reinterpret_cast<const float4*>(
                      gf + p * (kRB / 4) + gq * kCG)[c];
                  acc[r][p] = fmaf(v.x, g.x, acc[r][p]);
                  acc[r][p] = fmaf(v.y, g.y, acc[r][p]);
                  acc[r][p] = fmaf(v.z, g.z, acc[r][p]);
                  acc[r][p] = fmaf(v.w, g.w, acc[r][p]);
                }
              }
            }
          }
        }
      }

      // 4. select: each surface value of an in-box pixel to its place in
      // the pixel's window; per-pixel windows from the map; zeros off it
      if constexpr (kMma) {
        // accumulator k of tile i: pixel lane / 4 + 8 (k / 2), position
        // 8 nt + 2 (lane % 4) + k % 2
        const int p0 = lane >> 2;
        const bool in0 = G.cls[p0] == 1;
        const bool in1 = p0 == 0 && G.cls[kNP - 1] == 1;
        const int ry0 = G.ys[p0] - y0, rx0 = G.xs[p0] - x0;
        const int ry1 = G.ys[kNP - 1] - y0, rx1 = G.xs[kNP - 1] - x0;
#pragma unroll
        for (int i = 0; i < kTilesPerWarp; ++i) {
          const int nt = warp + kWarps * i;
          if (nt >= ntiles) continue;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int pos = nt * 8 + 2 * (lane & 3) + c;
            if (pos >= npos) continue;
            const int py = (pos * magic) >> 12;
            const int pxx = pos - py * bw;
            int a = py - ry0, b = pxx - rx0;
            if (in0 && static_cast<unsigned>(a) < kD &&
                static_cast<unsigned>(b) < kD)
              w_s[p0 * kWS + a * kD + b] = acc[i][c];
            a = py - ry1;
            b = pxx - rx1;
            if (in1 && static_cast<unsigned>(a) < kD &&
                static_cast<unsigned>(b) < kD)
              w_s[(kNP - 1) * kWS + a * kD + b] = acc[i][2 + c];
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pos = t + r * kThreads;
          if (pos >= npos) continue;
          const int py = (pos * magic) >> 12;
          const int pxx = pos - py * bw;
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            if (G.cls[p] != 1) continue;
            const int a = py - (G.ys[p] - y0);
            const int b = pxx - (G.xs[p] - x0);
            if (static_cast<unsigned>(a) < kD &&
                static_cast<unsigned>(b) < kD)
              w_s[p * kWS + a * kD + b] = acc[r][p];
          }
        }
      }
      for (int i = t; i < kNP * kD * kD; i += kThreads) {
        const int p = i / (kD * kD);
        const int cls = G.cls[p];
        if (cls == 1) continue;
        w_s[p * kWS + i % (kD * kD)] =
            cls == 0 ? 0.0f
                     : window_dot(fmap, j, H, W, G.ys[p] + (i / kD) % kD,
                                  G.xs[p] + i % kD,
                                  reinterpret_cast<const T*>(g_s + p * kRB));
      }
      __syncthreads();

      // 5. blend; output i = (dx * 7 + dy) * 9 + pixel of the level goes
      // to column 2 i + l of the edge's row
      for (int i = t; i < kBlend; i += kThreads) {
        const int dx = i / (kDO * kNP);
        const int dy = (i / kNP) % kDO;
        const int p = i % kNP;
        const float fx = G.fx[p], fy = G.fy[p];
        const float* c = w_s + p * kWS + dy * kD + dx;
        orow[2 * i + l] = (1.0f - fx) * (1.0f - fy) * c[0] +
                          fx * (1.0f - fy) * c[1] +
                          (1.0f - fx) * fy * c[kD] + fx * fy * c[kD + 1];
      }
    }
    __syncthreads();  // box, windows and geo[n % 2] free for the next item
  }
}

template <typename T>
int launch_box(const void* gmap, const void* fmap1, const void* fmap2,
               const void* coords, const void* kk, const void* jj,
               const void* valid, void* out, void* spill, int spill_rw, int E,
               int H1, int W1, int H2, int W2, cudaStream_t st) {
  constexpr int smem = Stage<T>::kSmem;
  // once per process and feature type (a launch inside a CUDA graph
  // capture then makes no other runtime call)
  static const cudaError_t attr = [] {
    cudaError_t err = cudaFuncSetAttribute(
        corr_box_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Stage<T>::kSmem);
    if (err == cudaSuccess)  // five bf16 blocks per SM need all of its smem
      err = cudaFuncSetAttribute(
          corr_box_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (E + kEdgesPerBlock - 1) / kEdgesPerBlock;
  corr_box_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out),
      static_cast<unsigned char*>(spill), spill_rw, E, H1, W1, H2, W2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_box(const void* gmap, const void* fmap1, const void* fmap2,
                 const void* coords, const void* kk, const void* jj,
                 const void* valid, void* out, void* spill, int spill_rw,
                 int E, int H1, int W1, int H2, int W2, int feat_bf16,
                 void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16)
    return launch_box<__nv_bfloat16>(gmap, fmap1, fmap2, coords, kk, jj,
                                     valid, out, spill, spill_rw, E, H1, W1,
                                     H2, W2, st);
  return launch_box<float>(gmap, fmap1, fmap2, coords, kk, jj, valid, out,
                           spill, spill_rw, E, H1, W1, H2, W2, st);
}

// ---------------------------------------------------------------------------
// The split route's x16 surfaces (`wv3d_corr_region_surfaces_x16`).
//
// Replaces the surfaces of `_corr_kernel4` (ops/pallas_corr.py:123) as
// `_surfaces4` (:503) launches it on the split route
// (`_pallas_corr_level4(extract="pallas")`): for every edge, level, patch
// pixel p and position (r, c) of the 16 x 16 region at the x16 origin
// (the least window start of the nine pixels, `ops/corr_region.py:
// geometry`), the 128-d product of gmap[kk][:, p] with
// fmap[jj][oy + r, ox + c], zero off the map, zero for invalid edges,
// written as surf [E, 2, 9, 16, 16] fp32 for the extract of
// `csrc/corr_region.cu`.
//
// Bound. Device-memory bytes: the 18 KB of fp32 surfaces each edge writes
// (1.02 GB at E = 55 296) and the in-map region positions read (each
// once). Beyond that the kernel moves each edge's regions, 64 KB of bf16
// per level, from L2 (7.2 GB at E = 55 296; regions of different edges
// overlap little), and reads the maps from device memory again wherever
// they have left L2 (the 36-frame /4 map alone is 113 MB).
//
// Design. One warp per edge, no block barrier inside an edge. A region is
// read once and has no reuse inside its edge, so it is not staged in
// shared memory: bf16 features load straight into the B fragments of
// mma.sync m16n8k16 (bf16 -> fp32). A product sums over channels in any
// order, so A and B share a channel permutation in which each lane's B
// fragments of a k-step pair are one 16-byte piece of its position: lane
// (g, q) (g = lane / 4, q = lane % 4) holds channels 32 kp + 8 q + (0..7)
// of position g of its n-tile for k-step pair kp, as (0,1 | 2,3) for the
// first k-step and (4,5 | 6,7) for the second. A (the nine patch rows,
// rows 9-15 zero) is loaded in the same order once per edge and kept in
// registers for both levels. Every product of two bf16 values is exact in
// fp32; only the order of the sums differs from the plain version.
// Positions off the map are predicated off their load and read as zero.
// A level's 256 positions go in chunks of 32 (two region rows, four
// n-tiles): the loads of kSurfTiles n-tiles issue together, then their
// products; the chunk's accumulators (rows 0-8) pass through the warp's
// 1.4 KB of shared memory so that each pixel's 128 bytes of the chunk
// leave as whole lines, in 16-byte streaming stores (st.global.cs: the
// surfaces are read once, by the extract). An invalid edge writes its
// 18 KB of zeros at once.
// Map traffic. The grid is one wave of blocks (kSurfWarps edges each, two
// per SM), and every block takes every G-th edge and works through them
// in the order of their target frames, so all blocks sweep the frames
// together and the frames in flight stay in L2, whatever the order of the
// edge list. The map loads keep their lines in L1, which the SM's other
// warps, on the same frames, then hit. (scripts/torch_chol_surfaces_ab.py
// times the kernel without either, and PERF.md has the readings.)
// fp32 features (no mixed precision) take a SIMT instantiation: a lane per
// position of the chunk, the patch features as broadcast loads, fp32 FMAs
// (no TF32). Static shared memory only (13.3 KB a block): no attribute to
// set.

constexpr int kSurfWarps = 8;               // edges (one per warp) per block
constexpr int kSurfTiles = 4;               // n-tiles whose loads go together
constexpr int kSurfMinBlocks = 2;           // blocks per SM (register cap)
constexpr int kRS = 16;                     // region side
constexpr int kRPos = kRS * kRS;            // positions per level
constexpr int kChunk = 32;                  // positions per chunk
constexpr int kChunkRow = kChunk + 8;       // staged floats per pixel (+8: banks)
constexpr int kSortRun = 256;               // edges a block sorts by frame

// 16 bytes of global memory where pred holds, else zeros (the load is
// predicated off, not branched around)
__device__ __forceinline__ uint4 ldg16_if(const void* p, bool pred) {
  uint4 v;
  asm("{\n"
      " .reg .pred p;\n"
      " setp.ne.b32 p, %4, 0;\n"
      " mov.b32 %0, 0;\n"
      " mov.b32 %1, 0;\n"
      " mov.b32 %2, 0;\n"
      " mov.b32 %3, 0;\n"
      " @p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(static_cast<int>(pred)), "l"(p));
  return v;
}

// two bf16 values (raw bits) as one 32-bit fragment register, lo first
__device__ __forceinline__ uint32_t pack_bf16(const unsigned short* p,
                                              int lo, int hi) {
  return static_cast<uint32_t>(__ldg(p + lo)) |
         static_cast<uint32_t>(__ldg(p + hi)) << 16;
}

// One warp: the surfaces of edge e, with the warp's shared memory ws.
template <typename T>
__device__ void surfaces_edge(const T* __restrict__ gmap,
                              const T* __restrict__ fmap1,
                              const T* __restrict__ fmap2,
                              const float* __restrict__ coords,
                              const int* __restrict__ kk,
                              const int* __restrict__ jj,
                              const unsigned char* __restrict__ valid,
                              float* __restrict__ surf, int e, int H1, int W1,
                              int H2, int W2, int lane, float* ws) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  float4* se = reinterpret_cast<float4*>(surf) +
               static_cast<size_t>(e) * 2 * kNP * kRPos / 4;
  if (!valid[e]) {
    for (int i = lane; i < 2 * kNP * kRPos / 4; i += 32)
      __stcs(se + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    return;
  }
  // the x16 origins of both levels: warp minima over the nine pixels
  const bool px = lane < kNP;
  const float2 cxy =
      px ? __ldg(reinterpret_cast<const float2*>(coords) +
                 static_cast<size_t>(e) * kNP + lane)
         : make_float2(0.0f, 0.0f);
  int oy[2], ox[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const float inv_s = l ? 0.25f : 1.0f;
    oy[l] = __reduce_min_sync(~0u, px ? window_start(cxy.y, inv_s) : INT_MAX);
    ox[l] = __reduce_min_sync(~0u, px ? window_start(cxy.x, inv_s) : INT_MAX);
  }
  const int k = kk[e], j = jj[e];

  if constexpr (kMma) {
    const int g = lane >> 2, q = lane & 3;
    // A fragments a[kp][h] of k-step 2 kp + h in the shared permutation;
    // gmap[k] is [C, 3, 3], element c * 9 + p
    const unsigned short* gk = reinterpret_cast<const unsigned short*>(gmap) +
                               static_cast<size_t>(k) * kC * kNP;
    uint32_t a[4][2][4];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t r0[4], r8[4];  // pixel g; pixel 8 (lanes of g = 0) or zero
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 32 * kp + 8 * q + 2 * i;
        r0[i] = pack_bf16(gk, c * kNP + g, (c + 1) * kNP + g);
        r8[i] = g == 0 ? pack_bf16(gk, c * kNP + 8, (c + 1) * kNP + 8) : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[kp][h][0] = r0[2 * h];
        a[kp][h][1] = r8[2 * h];
        a[kp][h][2] = r0[2 * h + 1];
        a[kp][h][3] = r8[2 * h + 1];
      }
    }
    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1, W = l ? W2 : W1;
      const T* fj = (l ? fmap2 : fmap1) + static_cast<size_t>(j) * H * W * kC;
      float4* plane = se + static_cast<size_t>(l) * kNP * kRPos / 4;
      for (int ch = 0; ch < kRPos / kChunk; ++ch) {
        float acc[4][4] = {};
#pragma unroll
        for (int t0 = 0; t0 < 4; t0 += kSurfTiles) {
          uint4 b[kSurfTiles][4];
#pragma unroll
          for (int ti = 0; ti < kSurfTiles; ++ti) {
            // position ch * 32 + 8 i + g: region row 2 ch + i / 2,
            // column 8 (i % 2) + g
            const int i = t0 + ti;
            const int y = oy[l] + 2 * ch + (i >> 1);
            const int x = ox[l] + 8 * (i & 1) + g;
            const bool in = y >= 0 && y < H && x >= 0 && x < W;
            const uint4* src =
                reinterpret_cast<const uint4*>(
                    fj + (static_cast<size_t>(in ? y : 0) * W + (in ? x : 0)) *
                             kC) + q;
#pragma unroll
            for (int kp = 0; kp < 4; ++kp) b[ti][kp] = ldg16_if(src + 4 * kp, in);
          }
#pragma unroll
          for (int ti = 0; ti < kSurfTiles; ++ti)
#pragma unroll
            for (int kp = 0; kp < 4; ++kp) {
              mma_bf16(acc[t0 + ti], a[kp][0], b[ti][kp].x, b[ti][kp].y);
              mma_bf16(acc[t0 + ti], a[kp][1], b[ti][kp].z, b[ti][kp].w);
            }
        }
        // accumulator r of tile i: pixel g + 8 (r / 2), position
        // 8 i + 2 q + r % 2 of the chunk
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<float2*>(ws + g * kChunkRow + 8 * i + 2 * q) =
              make_float2(acc[i][0], acc[i][1]);
          if (g == 0)
            *reinterpret_cast<float2*>(ws + 8 * kChunkRow + 8 * i + 2 * q) =
                make_float2(acc[i][2], acc[i][3]);
        }
        __syncwarp();
        for (int i = lane; i < kNP * kChunk / 4; i += 32) {
          const int p = i >> 3, c4 = i & 7;
          __stcs(plane + p * (kRPos / 4) + ch * (kChunk / 4) + c4,
                 *reinterpret_cast<const float4*>(ws + p * kChunkRow + 4 * c4));
        }
        __syncwarp();  // the stage is free for the next chunk
      }
    }
  } else {
    // gmap[k] is [C, 3, 3]: the 36 values of 4 channels are 9 float4s,
    // read by all lanes at once (one broadcast each)
    const float4* gk = reinterpret_cast<const float4*>(gmap) +
                       static_cast<size_t>(k) * kC * kNP / 4;
    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1, W = l ? W2 : W1;
      const float* fj = reinterpret_cast<const float*>(l ? fmap2 : fmap1) +
                        static_cast<size_t>(j) * H * W * kC;
      float* plane = reinterpret_cast<float*>(se) +
                     static_cast<size_t>(l) * kNP * kRPos;
      for (int ch = 0; ch < kRPos / kChunk; ++ch) {
        const int pos = ch * kChunk + lane;
        const int y = oy[l] + (pos >> 4);
        const int x = ox[l] + (pos & (kRS - 1));
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
        const float4* src = reinterpret_cast<const float4*>(
            fj + (static_cast<size_t>(in ? y : 0) * W + (in ? x : 0)) * kC);
        float acc[kNP] = {};
#pragma unroll 2
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          float4 f = __ldg(src + c4);
          if (!in) f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float g[4 * kNP];   // g[i * 9 + p]: channel 4 c4 + i, pixel p
#pragma unroll
          for (int q = 0; q < kNP; ++q) {
            const float4 v = __ldg(gk + kNP * c4 + q);
            g[4 * q] = v.x;
            g[4 * q + 1] = v.y;
            g[4 * q + 2] = v.z;
            g[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            acc[p] = fmaf(f.x, g[p], acc[p]);
            acc[p] = fmaf(f.y, g[kNP + p], acc[p]);
            acc[p] = fmaf(f.z, g[2 * kNP + p], acc[p]);
            acc[p] = fmaf(f.w, g[3 * kNP + p], acc[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < kNP; ++p) __stcs(plane + p * kRPos + pos, acc[p]);
      }
    }
  }
}

// Every block takes every G-th edge and goes through them kSortRun at a
// time, each run in the order of its target frames (invalid edges last);
// the grid of G blocks is one wave, so all blocks sweep the frames
// together and the maps they read at a time stay in L2.
template <typename T>
__global__ void __launch_bounds__(kSurfWarps * 32, kSurfMinBlocks)
surfaces_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                const T* __restrict__ fmap2, const float* __restrict__ coords,
                const int* __restrict__ kk, const int* __restrict__ jj,
                const unsigned char* __restrict__ valid,
                float* __restrict__ surf, int E, int H1, int W1, int H2,
                int W2) {
  constexpr int kWarpSmem = kNP * kChunkRow;  // the bf16 path's chunk stage
  __shared__ float4 smem4[kSurfWarps * kWarpSmem / 4];
  __shared__ int key_s[kSortRun], order_s[kSortRun];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  float* ws = reinterpret_cast<float*>(smem4) + warp * kWarpSmem;
  // block b's edges: b, b + G, b + 2 G, ... (a sample of every part of
  // the edge list, whatever its order)
  const int G = gridDim.x;
  const int n_block = (E - static_cast<int>(blockIdx.x) + G - 1) / G;
  for (int r0 = 0; r0 < n_block; r0 += kSortRun) {
    const int n = min(kSortRun, n_block - r0);
    for (int i = t; i < n; i += kSurfWarps * 32) {
      const int e = blockIdx.x + (r0 + i) * G;
      key_s[i] = valid[e] ? jj[e] : INT_MAX;
    }
    __syncthreads();
    // a stable rank sort by frame
    for (int i = t; i < n; i += kSurfWarps * 32) {
      const int key = key_s[i];
      int rank = 0;
      for (int m = 0; m < n; ++m) {
        const int km = key_s[m];
        rank += km < key || (km == key && m < i);
      }
      order_s[rank] = blockIdx.x + (r0 + i) * G;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kSurfWarps)
      surfaces_edge(gmap, fmap1, fmap2, coords, kk, jj, valid, surf,
                    order_s[i], H1, W1, H2, W2, lane, ws);
    __syncthreads();  // key_s and order_s are free for the next run
  }
}

// One wave of blocks: as many as the SMs hold at once (queried once per
// process and feature type).
template <typename T>
int surfaces_grid(int E, int& grid) {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, surfaces_kernel<T>, kSurfWarps * 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave = sms * per_sm;
  }
  grid = min(E, wave);
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int launch_surfaces(const void* gmap, const void* fmap1, const void* fmap2,
                    const void* coords, const void* kk, const void* jj,
                    const void* valid, void* surf, int E, int H1, int W1,
                    int H2, int W2, cudaStream_t st) {
  int grid = 0;
  const int err = surfaces_grid<T>(E, grid);
  if (err != 0) return err;
  surfaces_kernel<T><<<grid, kSurfWarps * 32, 0, st>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<const unsigned char*>(valid), static_cast<float*>(surf), E,
      H1, W1, H2, W2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gmap [S, 128, 3, 3], fmap1 [F, H1, W1, 128], fmap2 [F, H2, W2, 128] in
// bf16 (feat_bf16 != 0) or fp32, 16-byte aligned; coords [E, 3, 3, 2]
// fp32; kk, jj [E] int32 already reduced into [0, S) and [0, F); valid [E]
// bool; out [E, 882] fp32. Each entry point returns the cudaError_t of its
// launch.
extern "C" int wv3d_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* coords,
                                 const void* kk, const void* jj,
                                 const void* valid, void* out, int E, int H1,
                                 int W1, int H2, int W2, int feat_bf16,
                                 void* stream) {
  return dispatch_box(gmap, fmap1, fmap2, coords, kk, jj, valid, out, nullptr,
                      0, E, H1, W1, H2, W2, feat_bf16, stream);
}

// The fused route: as wv3d_corr_pyramid, plus spill [E] uint8 (1 where a
// valid edge has a pixel, at either level, that overlaps the map but does
// not fit the 16x32 (x32) or 16x16 (x16) region).
extern "C" int wv3d_corr_region_fused_x32(
    const void* gmap, const void* fmap1, const void* fmap2,
    const void* coords, const void* kk, const void* jj, const void* valid,
    void* out, void* spill, int E, int H1, int W1, int H2, int W2,
    int feat_bf16, void* stream) {
  return dispatch_box(gmap, fmap1, fmap2, coords, kk, jj, valid, out, spill,
                      32, E, H1, W1, H2, W2, feat_bf16, stream);
}

extern "C" int wv3d_corr_region_fused_x16(
    const void* gmap, const void* fmap1, const void* fmap2,
    const void* coords, const void* kk, const void* jj, const void* valid,
    void* out, void* spill, int E, int H1, int W1, int H2, int W2,
    int feat_bf16, void* stream) {
  return dispatch_box(gmap, fmap1, fmap2, coords, kk, jj, valid, out, spill,
                      16, E, H1, W1, H2, W2, feat_bf16, stream);
}

// The split route's first kernel: surf [E, 2, 9, 16, 16] fp32, the x16
// surfaces of both levels (zero for invalid edges), read by
// `wv3d_corr_region_extract_x16` (csrc/corr_region.cu).
extern "C" int wv3d_corr_region_surfaces_x16(
    const void* gmap, const void* fmap1, const void* fmap2,
    const void* coords, const void* kk, const void* jj, const void* valid,
    void* surf, int E, int H1, int W1, int H2, int W2, int feat_bf16,
    void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_bf16)
    return launch_surfaces<__nv_bfloat16>(gmap, fmap1, fmap2, coords, kk, jj,
                                          valid, surf, E, H1, W1, H2, W2, st);
  return launch_surfaces<float>(gmap, fmap1, fmap2, coords, kk, jj, valid,
                                surf, E, H1, W1, H2, W2, st);
}
