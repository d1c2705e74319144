// Segmented run-sum over rows sorted by segment id (Hopper, sm_90a).
//
// Replaces the TPU kernel `_runsum_kernel` (ops/pallas_segsum.py:38,
// launched by `run_segment_sum_sorted`) of the JAX package. For rows whose
// equal segment ids are contiguous, every row gets the fp32 total of its
// run. The TPU kernel computes this as a banded one-hot matrix product that
// sees 128 rows on either side, so a run longer than that (the sentinel run
// of invalid rows) gets a windowed partial sum there; those rows are never
// read. This kernel sums runs of any length exactly, so it differs from the
// TPU kernel only on such rows. It also accumulates in fp32 throughout,
// where the TPU kernel rounds its operands to bf16.
//
// Design. Rows are cut into tiles of kTile rows and columns into blocks of
// kCols threads, one thread per column. Pass 1 writes, per tile and column,
// the forward sum of the tile's first run (head) and of its last run
// (tail). Pass 2 walks each tile's rows in order, summing each run; a run
// that crosses tile boundaries adds the neighbouring tiles' tail/head
// partials, always in tile order from the run's first tile, so every row of
// a run gets the bitwise same total. Reads and writes are coalesced along
// the columns.
//
// Bound. Device-memory bytes: the [E, D] fp32 input is read twice (once per
// pass, pass 1 only the head and tail runs) and the output written once,
// against the one read and one write of the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // rows per tile
constexpr int kCols = 128;  // columns (threads) per block

__global__ void __launch_bounds__(kCols)
runsum_partials(const float* __restrict__ fes, const int* __restrict__ seg,
                float* __restrict__ head, float* __restrict__ tail, int E,
                int D) {
  const int tile = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= D) return;
  const int r0 = tile * kTile;
  const int r1 = min(r0 + kTile, E);
  const int s0 = seg[r0];
  const int s1 = seg[r1 - 1];
  float h = 0.0f;
  int i = r0;
  for (; i < r1 && seg[i] == s0; ++i) h += fes[static_cast<size_t>(i) * D + c];
  float tl = h;
  if (s1 != s0) {
    int ts = r1 - 1;
    while (ts > r0 && seg[ts - 1] == s1) --ts;
    tl = 0.0f;
    for (i = ts; i < r1; ++i) tl += fes[static_cast<size_t>(i) * D + c];
  }
  head[static_cast<size_t>(tile) * D + c] = h;
  tail[static_cast<size_t>(tile) * D + c] = tl;
}

__global__ void __launch_bounds__(kCols)
runsum_apply(const float* __restrict__ fes, const int* __restrict__ seg,
             const float* __restrict__ head, const float* __restrict__ tail,
             float* __restrict__ out, int E, int D, int n_tiles) {
  __shared__ int s_s[kTile];
  const int tile = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int r0 = tile * kTile;
  const int r1 = min(r0 + kTile, E);
  for (int i = threadIdx.x; i < r1 - r0; i += kCols) s_s[i] = seg[r0 + i];
  __syncthreads();
  if (c >= D) return;

  int rs = r0;
  float acc = 0.0f;
  for (int i = r0; i < r1; ++i) {
    acc += fes[static_cast<size_t>(i) * D + c];
    const int s = s_s[i - r0];
    if (i + 1 < r1 && s_s[i + 1 - r0] == s) continue;
    // run [rs, i] ends inside this tile at i
    float total = acc;
    const bool from_before = rs == r0 && r0 > 0 && seg[r0 - 1] == s;
    const bool into_after = i + 1 == r1 && r1 < E && seg[r1] == s;
    if (from_before || into_after) {
      int f = tile;  // tile holding the run's first row
      if (from_before) {
        f = tile - 1;
        while (f > 0 && seg[f * kTile] == s && seg[f * kTile - 1] == s) --f;
      }
      int g = tile;  // tile holding the run's last row
      if (into_after) {
        g = tile + 1;
        while (g < n_tiles - 1 && seg[min((g + 1) * kTile, E) - 1] == s &&
               seg[(g + 1) * kTile] == s)
          ++g;
      }
      for (int u = f; u <= g; ++u) {
        const float part =
            u == tile ? acc
                      : (u == f ? tail : head)[static_cast<size_t>(u) * D + c];
        total = u == f ? part : total + part;
      }
    }
    for (int q = rs; q <= i; ++q) out[static_cast<size_t>(q) * D + c] = total;
    rs = i + 1;
    acc = 0.0f;
  }
}

}  // namespace

// fes [E, D] fp32 rows in segment order; seg [E] int32 with equal ids
// contiguous; out [E, D] fp32; head, tail [ceil(E / 64), D] fp32 scratch.
// Returns the cudaError_t of the launches.
extern "C" int wv3d_runsum(const void* fes, const void* seg, void* out,
                           void* head, void* tail, int E, int D,
                           void* stream) {
  if (E <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (E + kTile - 1) / kTile;
  const dim3 grid(n_tiles, (D + kCols - 1) / kCols);
  const float* f = static_cast<const float*>(fes);
  const int* s = static_cast<const int*>(seg);
  float* h = static_cast<float*>(head);
  float* t = static_cast<float*>(tail);
  runsum_partials<<<grid, kCols, 0, st>>>(f, s, h, t, E, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  runsum_apply<<<grid, kCols, 0, st>>>(f, s, h, t, static_cast<float*>(out),
                                       E, D, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
