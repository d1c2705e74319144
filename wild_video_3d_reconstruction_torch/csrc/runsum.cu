// Segmented run-sum over rows sorted by segment id (Hopper, sm_90a).
//
// Replaces the TPU kernel `_runsum_kernel` (ops/pallas_segsum.py:38,
// launched by `run_segment_sum_sorted` at :73) of the JAX package. For rows
// whose equal segment ids are contiguous, every row gets the fp32 total of
// its run. The TPU kernel computes this as a banded one-hot matrix product
// that sees 128 rows on either side, so a run longer than that (the sentinel
// run of invalid rows) gets a windowed partial sum there; those rows are
// never read. This kernel sums runs of any length exactly, so it differs
// from the TPU kernel only on such rows. It also accumulates in fp32
// throughout, where the TPU kernel rounds its operands to bf16.
//
// Bound. Device-memory bytes: the [E, D] fp32 input read once, the output
// written once and the int32 keys read once (340 MB at E = 55 296, D = 768:
// 0.101 ms at 3.35 TB/s); the E * D adds are nothing beside that.
//
// Design. Rows are cut into tiles of kTile rows and each row into blocks of
// kVec float4 columns, one thread per float4 (a 768-wide row is 192 16-byte
// loads in three blocks). A block stages its tile's keys in shared memory,
// so no row load waits on a key compare, and finds the tile's first run
// (head) and last run (tail) from them. Each thread issues kUnroll
// independent 16-byte loads before it adds them.
//  * Pass 1 (`runsum_boundary`) reads only the head and tail runs of each
//    tile (once, when the tile is one run) and writes their partial sums.
//  * Pass 2 (`runsum_apply`) reads only the runs strictly inside each tile
//    and writes every row of the tile once, from registers: an inner run
//    its own total, a head or tail run the sum of the partials of the tiles
//    the run spans, always from the run's first tile in tile order, so every
//    row of a run holds the bitwise same total.
// So every input row is read once over the two passes. Pass 2 is a
// programmatic dependent launch: its blocks start while pass 1 runs,
// stream their inner runs, and wait for pass 1 (griddepcontrol.wait) only
// before they read the partials, so the two passes overlap as one stream.
// The tiles that a boundary run spans are found by a parallel probe of 32
// tile boundaries per step and direction, not a serial walk, and each tile
// writes only its own rows. A run spanning n tiles costs each of them a sum
// of n partials from L2 (n^2 reads in all): 128-row tiles keep that small
// for the 8 000-row sentinel run (63-65 tiles), where 64-row tiles are a
// few percent faster at chip_smoke.py's shapes and 256-row tiles leave too
// few blocks per SM (scripts/torch_runsum_tiles.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // rows per tile (wv3d_runsum_tile)
constexpr int kVec = 64;     // float4 columns (threads) per block
constexpr int kUnroll = 8;   // row loads in flight per thread
static_assert(kVec == 64, "the probe takes one warp per direction");

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Stage seg[r0, r0 + n) in s_seg; s_run[0] = one past the head run's last
// row and s_run[1] = the tail run's first row, tile-relative (n and 0 when
// the tile is one run).
__device__ void stage_tile(const int* __restrict__ seg, int r0, int n,
                           int* s_seg, int* s_run) {
  for (int i = threadIdx.x; i < n; i += kVec) s_seg[i] = seg[r0 + i];
  if (threadIdx.x == 0) {
    s_run[0] = n;
    s_run[1] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x + 1; i < n; i += kVec) {
    if (s_seg[i] != s_seg[i - 1]) {
      atomicMin(&s_run[0], i);
      atomicMax(&s_run[1], i);
    }
  }
  __syncthreads();
}

// Sum of rows [a, b) of one float4 column, in row order.
__device__ __forceinline__ float4 sum_rows(const float4* __restrict__ col,
                                           int D4, int a, int b) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = a; i < b; i += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = i + k < b ? __ldg(col + static_cast<size_t>(i + k) * D4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) add4(acc, v[k]);
  }
  return acc;
}

__global__ void __launch_bounds__(kVec)
runsum_boundary(const float4* __restrict__ fes, const int* __restrict__ seg,
                float4* __restrict__ head, float4* __restrict__ tail, int E,
                int D4) {
  __shared__ int s_seg[kTile];
  __shared__ int s_run[2];
  // pass 2 may start now: it reads head and tail only after its wait
  asm volatile("griddepcontrol.launch_dependents;");
  const int tile = blockIdx.x;
  const int r0 = tile * kTile;
  const int n = min(kTile, E - r0);
  stage_tile(seg, r0, n, s_seg, s_run);
  const int c = blockIdx.y * kVec + threadIdx.x;
  if (c >= D4) return;
  const float4* col = fes + static_cast<size_t>(r0) * D4 + c;
  const float4 h = sum_rows(col, D4, 0, s_run[0]);
  head[static_cast<size_t>(tile) * D4 + c] = h;
  tail[static_cast<size_t>(tile) * D4 + c] =
      s_run[0] == n ? h : sum_rows(col, D4, s_run[1], n);
}

// Total of the run that spans tiles [f, g]: the partial of a run inside
// one tile (its head or its tail partial), else tail[f] + head[f + 1] +
// ... + head[g], in that order on every tile of the run.
__device__ __forceinline__ float4 run_total(const float4* __restrict__ head,
                                            const float4* __restrict__ tail,
                                            int f, int g, bool is_head,
                                            int c, int D4) {
  if (f == g) return (is_head ? head : tail)[static_cast<size_t>(f) * D4 + c];
  float4 acc = tail[static_cast<size_t>(f) * D4 + c];
#pragma unroll 4
  for (int u = f + 1; u <= g; ++u)
    add4(acc, head[static_cast<size_t>(u) * D4 + c]);
  return acc;
}

__global__ void __launch_bounds__(kVec)
runsum_apply(const float4* __restrict__ fes, const int* __restrict__ seg,
             const float4* __restrict__ head, const float4* __restrict__ tail,
             float4* __restrict__ out, int E, int D4, int n_tiles) {
  __shared__ int s_seg[kTile];
  __shared__ int s_run[2];
  __shared__ int s_first, s_last;
  const int tile = blockIdx.x;
  const int r0 = tile * kTile;
  const int n = min(kTile, E - r0);
  stage_tile(seg, r0, n, s_seg, s_run);
  const int h_end = s_run[0];
  const int t_start = s_run[1];
  const int s_head = s_seg[0];
  const int s_tail = s_seg[n - 1];

  // The probe: warp 0 looks back for the tile holding the head run's first
  // row, the largest u <= tile with u == 0 or seg[u * kTile - 1] != s_head;
  // warp 1 looks ahead for the tile holding the tail run's last row, the
  // smallest u >= tile with u == n_tiles - 1 or seg[(u + 1) * kTile] !=
  // s_tail. 32 tiles per step and direction.
  if (threadIdx.x == 0) {
    s_first = -1;
    s_last = INT_MAX;
  }
  __syncthreads();
  // need_* are read between the two barriers, where no thread writes
  const int lane = threadIdx.x & 31;
  bool need_first = true, need_last = true;
  for (int step = 0;; step += 32) {
    if (threadIdx.x < 32) {
      const int u = tile - step - lane;
      if (need_first && u >= 0 && (u == 0 || seg[u * kTile - 1] != s_head))
        atomicMax(&s_first, u);
    } else {
      const int u = tile + step + lane;
      if (need_last && u < n_tiles &&
          (u == n_tiles - 1 || seg[(u + 1) * kTile] != s_tail))
        atomicMin(&s_last, u);
    }
    __syncthreads();
    need_first = s_first < 0;
    need_last = s_last == INT_MAX;
    __syncthreads();
    if (!need_first && !need_last) break;
  }
  const int c = blockIdx.y * kVec + threadIdx.x;
  if (c >= D4) return;
  const float4* col = fes + static_cast<size_t>(r0) * D4 + c;
  float4* ocol = out + static_cast<size_t>(r0) * D4 + c;

  // the runs strictly inside the tile: rows [h_end, t_start)
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int rs = h_end;
  for (int i = h_end; i < t_start; i += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = i + k < t_start ? __ldg(col + static_cast<size_t>(i + k) * D4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = i + k;
      if (r < t_start) {
        add4(acc, v[k]);
        if (s_seg[r + 1] != s_seg[r]) {  // r + 1 <= t_start < n
          for (int q = rs; q <= r; ++q)
            ocol[static_cast<size_t>(q) * D4] = acc;
          rs = r + 1;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }

  // the head run spans [s_first, its last tile], the tail run [its first
  // tile, s_last]; in a tile of one run they are the same run. Pass 1's
  // partials are complete and visible after the wait.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const bool one_run = h_end == n;
  const float4 th = run_total(head, tail, s_first, one_run ? s_last : tile,
                              true, c, D4);
  for (int q = 0; q < h_end; ++q) ocol[static_cast<size_t>(q) * D4] = th;
  if (one_run) return;
  const float4 tt = run_total(head, tail, tile, s_last, false, c, D4);
  for (int q = t_start; q < n; ++q) ocol[static_cast<size_t>(q) * D4] = tt;
}

}  // namespace

// Rows per tile: the scratch of wv3d_runsum holds one row per tile.
extern "C" int wv3d_runsum_tile() { return kTile; }

// fes [E, D] fp32 rows in segment order (D a multiple of 4, 16-byte
// aligned); seg [E] int32 with equal ids contiguous; out [E, D] fp32; head,
// tail [ceil(E / wv3d_runsum_tile()), D] fp32 scratch. Returns the
// cudaError_t of the launches.
extern "C" int wv3d_runsum(const void* fes, const void* seg, void* out,
                           void* head, void* tail, int E, int D,
                           void* stream) {
  if (E <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (D % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D4 = D / 4;
  const int n_tiles = (E + kTile - 1) / kTile;
  const dim3 grid(n_tiles, (D4 + kVec - 1) / kVec);
  const float4* f = static_cast<const float4*>(fes);
  const int* s = static_cast<const int*>(seg);
  float4* h = static_cast<float4*>(head);
  float4* t = static_cast<float4*>(tail);
  runsum_boundary<<<grid, kVec, 0, st>>>(f, s, h, t, E, D4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass 2 as a programmatic dependent launch: its blocks start while pass
  // 1 runs and stream their inner runs; griddepcontrol.wait holds each
  // block before it reads the partials
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kVec);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, runsum_apply, f, s, static_cast<const float4*>(h),
      static_cast<const float4*>(t), static_cast<float4*>(out), E, D4,
      n_tiles));
}
