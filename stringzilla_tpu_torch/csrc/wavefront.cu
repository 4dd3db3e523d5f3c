// Anti-diagonal DP scores of long pairs, hand-written for Hopper (sm_90a):
// the flat tier (wavefront_tile) for every configuration, and below it the
// band tier (wavefront_band) for unit-cost Levenshtein.
//
// The flat tier replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/wavefront_pallas.py::_kernel: the exact int32 score of
// one pair's full DP matrix, for all 16 combinations of objective (min/max),
// locality (global/local), gaps (linear/affine Gotoh) and substitution costs
// (uniform match/mismatch, or a 32x32 class table). The recurrence is the
// JAX kernel's, cell by cell:
//   boundary(k) = 0 (local), gap * k (linear), open + extend * (k - 1) for
//                 k > 0 (affine); gap_boundary(k) = boundary(k) + open + extend
//   row 0 and column 0: D = boundary(k), I = J = gap_boundary(k)
//   linear cell: D = opt(D[i][j-1] + gap, D[i-1][j] + gap, D[i-1][j-1] + sub)
//   affine cell: I = opt(D[i][j-1] + open, I[i][j-1] + extend)
//                J = opt(D[i-1][j] + open, J[i-1][j] + extend)
//                D = opt(D[i-1][j-1] + sub, I, J)
//   local:       D = opt(D, 0); the score is opt(0, D over 1..m x 1..n)
//   global:      the score is D[m][n]
// sub is match/mismatch on the raw chars, or table[a class][b class] with
// both class ids clamped to [0, 31], as the JAX kernel clips them. Cells
// outside the matrix are never computed, so the JAX kernel's masking
// identity never reaches a result.
//
// What bounds it on this card. A cell is 5 (linear) to 10 (affine) dependent
// int32 adds and min/max, 2 more when local; the chars and the frontiers are
// O(m + n) bytes against O(m * n) cells. So it is bound by integer issue,
// 132 SMs x 64 int32 lanes a clock, and, for one pair, by how many cells are
// independent at a time: only one anti-diagonal is.
//
// What the design does about it. The TPU kernel swept one anti-diagonal per
// step over a (rows, 128) tile holding the whole diagonal in VMEM, streaming
// b through a shift register and building class costs from 8 bit-planes.
// Here the matrix is cut into tiles of kRows x kCols cells. Tiles on one
// anti-diagonal of tiles are independent: one launch runs tile diagonal t of
// every pair of the group, a warp (one CTA) per tile, so a 100,000-char
// pair keeps up to 1563 warps busy. Inside a tile, lane i owns row i and
// computes column s - i at step s: the cell above comes from lane i - 1 by
// a shuffle (its result of the previous step), the cell to the left is the
// lane's own last result, and the diagonal cell is the lane's previous
// "above". No shared-memory round trip and no block barrier inside the
// sweep. The tile's b chars and
// top frontier sit in shared memory; the class table is stored per lane,
// tab[b class][lane] = table[lane's a class][b class], so every read hits
// the lane's own bank. Tiles hand on their bottom row (D, and J when affine)
// through a per-pair row frontier with kCols + 1 entries per tile column,
// and their right column (D, and I when affine) through a column frontier
// with kRows + 1 entries per tile row; entry 0 of each is the tile's corner,
// so no other tile of the same launch overwrites a value still to be read.
// Local bests meet in out[pair] through one atomic min/max per tile.
//
// Later work: DPX fused add-min/max (__viaddmin_s32), several warps per CTA
// pipelining a taller tile, and a persistent kernel instead of a launch per
// tile diagonal.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;  // tile rows: one warp, a lane per row of a
constexpr int kCols = 64;  // tile columns of b
constexpr int kClasses = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRecord = 6;  // per pair: a_off, m, b_off, n, row and column frontier offsets

struct Costs {
  int gap;       // linear: open_or_extend; affine: open
  int extend;    // affine only
  int match;     // uniform only
  int mismatch;  // uniform only
};

template <bool kMax>
__device__ __forceinline__ int opt(int a, int b) {
  return kMax ? max(a, b) : min(a, b);
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int boundary(int k, const Costs& c) {
  if (kLocal) return 0;
  if (kAffine) return k > 0 ? c.gap + c.extend * (k - 1) : 0;
  return c.gap * k;
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int gap_boundary(int k, const Costs& c) {
  return boundary<kLocal, kAffine>(k, c) + c.gap + c.extend;
}

__device__ __forceinline__ int clamp_class(int c) {
  return min(max(c, 0), kClasses - 1);
}

// One warp per tile (r, c) on tile diagonal `diag`: blockIdx.y is the pair
// of the group, blockIdx.x the tile's place along the diagonal.
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__global__ void __launch_bounds__(kRows)
wavefront_tile(const int32_t* __restrict__ chars, const long long* __restrict__ pairs,
               int diag, const int32_t* __restrict__ table, Costs costs,
               int32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  __shared__ int32_t tab[kClass ? kClasses * kRows : 1];  // tab[b class * kRows + lane]
  __shared__ int32_t b_chars[kCols];
  __shared__ int32_t top_d[kCols + 1];  // D of the row above the tile, corner first
  __shared__ int32_t top_g[kAffine ? kCols + 1 : 1];  // J of that row

  const long long* rec = pairs + static_cast<long long>(blockIdx.y) * kRecord;
  const long long a_off = rec[0], b_off = rec[2];
  const int m = static_cast<int>(rec[1]), n = static_cast<int>(rec[3]);
  const int tile_rows = (m + kRows - 1) / kRows, tile_cols = (n + kCols - 1) / kCols;
  const int r = max(0, diag - tile_cols + 1) + static_cast<int>(blockIdx.x);
  const int c = diag - r;
  if (r >= tile_rows || c < 0) return;  // this pair has fewer tiles on the diagonal

  const int lane = threadIdx.x;
  const int row0 = r * kRows, col0 = c * kCols;
  const int rows = min(kRows, m - row0), cols = min(kCols, n - col0);
  const int words = kAffine ? 2 : 1;
  // Row frontier of tile column c: D of the row above, then J when affine.
  int32_t* h_d = scratch + rec[4] + static_cast<long long>(c) * (kCols + 1) * words;
  int32_t* h_g = h_d + (kCols + 1);
  // Column frontier of tile row r: D of the column to the left, then I.
  int32_t* v_d = scratch + rec[5] + static_cast<long long>(r) * (kRows + 1) * words;
  int32_t* v_g = v_d + (kRows + 1);

  // -- load: b chars, the top frontier, this lane's a char and left cells --
  for (int k = lane; k < kCols; k += kRows) {
    const int ch = k < cols ? chars[b_off + col0 + k] : 0;
    b_chars[k] = kClass ? clamp_class(ch) : ch;
  }
  for (int k = lane; k <= cols; k += kRows) {
    if (r == 0) {
      top_d[k] = boundary<kLocal, kAffine>(col0 + k, costs);
      if (kAffine) top_g[k] = gap_boundary<kLocal, kAffine>(col0 + k, costs);
    } else {
      top_d[k] = h_d[k];
      if (kAffine) top_g[k] = h_g[k];
    }
  }
  int a_char = lane < rows ? chars[a_off + row0 + lane] : 0;
  if (kClass) {
    a_char = clamp_class(a_char);
    for (int k = 0; k < kClasses; ++k) tab[k * kRows + lane] = table[a_char * kClasses + k];
  }
  int diag_d, left_d, left_i = 0;  // D[i-1][col0], D[i][col0], I[i][col0]
  if (c == 0) {
    diag_d = boundary<kLocal, kAffine>(row0 + lane, costs);
    left_d = boundary<kLocal, kAffine>(row0 + lane + 1, costs);
    if (kAffine) left_i = gap_boundary<kLocal, kAffine>(row0 + lane + 1, costs);
  } else {
    diag_d = v_d[lane];
    left_d = v_d[lane + 1];
    if (kAffine) left_i = v_g[lane + 1];
  }
  __syncwarp();  // every frontier read is done before any write below

  // The corners the next tiles read: D[row0 + rows][col0] starts the bottom
  // row, D[row0][col0 + cols] the right column.
  if (lane == rows - 1) h_d[0] = left_d;
  if (lane == 0) v_d[0] = top_d[cols];

  // -- sweep: lane i computes cell (row0 + 1 + i, col0 + 1 + s - i) at step s --
  int cur_d = 0, cur_g = 0;  // this lane's newest D and J, read by lane + 1
  int best = 0;
  const int steps = rows + cols - 1;
  for (int s = 0; s < steps; ++s) {
    int up_d = __shfl_up_sync(kFull, cur_d, 1);
    int up_g = kAffine ? __shfl_up_sync(kFull, cur_g, 1) : 0;
    const int j = s - lane;
    if (lane == 0 && j < cols) {
      up_d = top_d[j + 1];
      if (kAffine) up_g = top_g[j + 1];
    }
    if (lane < rows && j >= 0 && j < cols) {
      const int b_char = b_chars[j];
      const int sub = kClass ? tab[b_char * kRows + lane]
                             : (a_char == b_char ? costs.match : costs.mismatch);
      int d;
      if (kAffine) {
        left_i = opt<kMax>(left_d + costs.gap, left_i + costs.extend);
        cur_g = opt<kMax>(up_d + costs.gap, up_g + costs.extend);
        d = opt<kMax>(diag_d + sub, opt<kMax>(left_i, cur_g));
      } else {
        d = opt<kMax>(opt<kMax>(left_d + costs.gap, up_d + costs.gap), diag_d + sub);
      }
      if (kLocal) {
        d = opt<kMax>(d, 0);
        best = opt<kMax>(best, d);
      }
      cur_d = left_d = d;
      diag_d = up_d;
      if (lane == rows - 1) {
        h_d[j + 1] = d;
        if (kAffine) h_g[j + 1] = cur_g;
      }
    }
  }

  // -- hand-off: the right column, and the pair's score --
  if (lane < rows) {
    v_d[lane + 1] = left_d;
    if (kAffine) v_g[lane + 1] = left_i;
  }
  const int pair = blockIdx.y;
  if (kLocal) {
#pragma unroll
    for (int off = kRows / 2; off > 0; off /= 2)
      best = opt<kMax>(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) {
      if (kMax) atomicMax(out + pair, best);
      else atomicMin(out + pair, best);
    }
  } else if (r == tile_rows - 1 && c == tile_cols - 1 && lane == rows - 1) {
    out[pair] = left_d;  // D[m][n]
  }
}


// ---------------------------------------------------------------------------
// Band tier: the exact unit-cost Levenshtein distance of one long pair by
// Ukkonen band doubling (replaces wavefront_pallas.py::_band_kernel).
//
// Any path that leaves the band |i - j| <= k pays more than k gaps, so when
// the DP restricted to the band ends at D[m][n] <= k that value is the
// distance. The ladder starts at the host's first k (>= |m - n|, so the band
// holds (m, n)) and widens it until a rung certifies, all inside one launch.
// A rung stops at the first row whose band cells all exceed k (every later
// cell is at least that row's minimum, so D[m][n] > k), and that row prices
// the next rung: k * m / row plus a quarter, rounded up to a doubling of k.
// A rung that reaches (m, n) with D[m][n] > k has D[m][n] as its estimate.
// Past kmax the pair gets status 2 and the host scores it on the flat tier.
//
// Layout. One CTA per pair. The matrix is cut into strips of 32 rows; warp
// w walks strips w, w + B, ... (B below) with lane l on row 32 s + 1 + l, and
// at step t lane l computes column jlo(s) + t - l, so the cell above is lane
// l - 1's result of the previous step (a shuffle), the cell to the left the
// lane's own, and the diagonal one the lane's previous "above", as in a flat
// tile. A strip hands its last row to the next strip through a row buffer in
// shared memory and publishes how many steps it has written, tagged with its
// strip number; the next strip waits for the columns of each chunk of 16
// steps before it reads them. So strips run pipelined, ~50 steps apart, with
// no block barrier inside a rung. B, as many buffers as fit in 220 KiB (all
// 32 up to k = 863, 27 at k = 1024, 13 at k = 2047), sets how many warps walk
// strips: a warp's step is a chain of dependent latencies, so more strips
// in flight go faster. A strip reuses the buffer of the strip that many
// before it only after the chain of waits has put that buffer's reader far
// ahead of it. A strip stops early only when a row of an earlier strip
// already stopped the rung, and a wait gives up when its producer will
// never come; a wait that spins too long marks the pair status 3 rather
// than hang.

constexpr int kBandWarps = 32;
constexpr int kBandThreads = kBandWarps * 32;
constexpr int kBandMax = 2047;  // the widest half-width
constexpr int kBandChunk = 16;  // steps between a strip's waits and between its publications
constexpr int kBandRecord = 5;  // per pair: a_off, m, b_off, n, first k
constexpr int kBig = 1 << 28;   // the JAX kernel's identity
constexpr long long kTag = 1LL << 32;  // progress = strip * kTag + steps written
constexpr long long kSpinLimit = 1LL << 24;
constexpr int kBandRowWords = 55 << 10;  // row buffers: 220 KiB of shared memory

// A row buffer holds columns jlo - 1 .. jlo + 2k + 32 of a strip's last row;
// as many buffers (and strips in flight) as fit, at most one per warp.
__host__ __device__ constexpr int band_row_slots(int k) { return 2 * k + 34; }
__device__ __forceinline__ int band_buffers(int k) {
  return min(kBandWarps, kBandRowWords / band_row_slots(k));
}

struct BandShared {
  long long progress[kBandWarps];  // of the row buffer with the same index
  int stop_row, stop_strip, result, failed;
  int rows[kBandRowWords];
};

struct Rung {
  int res;       // D[m][n] within the band, when the rung reached it
  int stop_row;  // the first row with no band cell <= k, or 0
  bool failed;   // a wait spun past kSpinLimit
};

// Band cells of rows 1..r: sum of min(n, i + k) - max(0, i - k) + 1.
__device__ long long band_row_cells(long long r, long long n, long long k) {
  const long long c = min(r, max(0LL, n - k));  // rows with i + k <= n
  const long long d = max(0LL, r - k);          // rows with i > k
  return c * (c + 1) / 2 + c * k + (r - c) * n - d * (d + 1) / 2 + r;
}

__device__ Rung band_rung(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int m,
                          int n, int k, BandShared& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  volatile long long* progress = sh.progress;
  volatile int* stop_strip = &sh.stop_strip;
  volatile int* failed = &sh.failed;
  __syncthreads();  // the previous rung's readers are done
  if (threadIdx.x < kBandWarps) sh.progress[threadIdx.x] = -kTag;
  if (threadIdx.x == 0) {
    sh.stop_row = sh.stop_strip = INT_MAX;
    sh.result = kBig;
    sh.failed = 0;
  }
  __syncthreads();

  const int strips = (m + 31) / 32;
  const int buffers = band_buffers(k), slots = band_row_slots(k);
  for (int s = warp; s < strips && warp < buffers; s += buffers) {
    if (*stop_strip < s || *failed) break;
    const int r0 = 32 * s + 1, i = r0 + lane;
    const bool row_ok = i <= m;
    const int jlo = max(0, r0 - k), steps = min(n, r0 + 31 + k) - jlo + 32;
    const int blo = max(0, i - k), bhi = min(n, i + k);
    const int above_hi = min(n, r0 - 1 + k);            // last band column of row r0 - 1
    const int jlo_prev = max(0, r0 - 32 - k);           // the strip above's jlo
    const int jlo_next = max(0, r0 + 32 - k);           // the strip below's jlo
    const int a_char = row_ok ? __ldg(a + i - 1) : -2;
    const volatile int* above = sh.rows + (s % buffers) * slots;  // row r0 - 1, from strip s - 1
    volatile int* below = sh.rows + ((s + 1) % buffers) * slots;  // row r0 + 31, for strip s + 1
    volatile long long* mine = progress + (s + 1) % buffers;
    if (lane == 31) *mine = s * kTag;  // the buffer is strip s's from now on

    int cur = kBig, diag = kBig, row_min = kBig;
    int j0 = jlo - lane;
    int b_char = (j0 >= 1 && j0 <= n) ? __ldg(b + j0 - 1) : -1;
    bool gone = false;
    for (int t0 = 0; t0 < steps && !gone; t0 += kBandChunk) {
      // Lane 0 reads row r0 - 1 at columns jlo + t0 .. jlo + t0 + 7 (and
      // jlo - 1 first), once strip s - 1 has written them.
      int c[kBandChunk];
      if (lane == 0) {
        if (s > 0) {
          const int last = min(jlo + t0 + kBandChunk - 1, above_hi);
          const long long want = (s - 1) * kTag + (last - jlo_prev + 32);
          long long spins = 0;
          while (progress[s % buffers] < want) {
            if (*stop_strip < s || *failed) { gone = true; break; }
            if (++spins > kSpinLimit) { *failed = 1; gone = true; break; }
            __nanosleep(64);
          }
          __threadfence_block();
        }
        if (t0 == 0) {
          const int col = jlo - 1;
          diag = (col < 0 || col > above_hi) ? kBig : (s == 0 ? col : above[0]);
        }
#pragma unroll
        for (int q = 0; q < kBandChunk; ++q) {
          const int col = jlo + t0 + q;
          c[q] = col > above_hi ? kBig : (s == 0 ? col : above[col - jlo + 1]);
        }
      }
      gone = __shfl_sync(kFull, gone, 0);
      if (gone) break;
#pragma unroll
      for (int q = 0; q < kBandChunk; ++q) {
        const int t = t0 + q;
        if (t >= steps) break;
        // Branch-free: every lane runs the same instructions each step.
        const int j = jlo + t - lane;
        const int next_b = (j >= 0 && j < n) ? __ldg(b + j) : -1;  // b[j] for step t + 1
        const int left_up = __shfl_up_sync(kFull, cur, 1);
        const int up = lane == 0 ? c[q] : left_up;
        const bool active = row_ok & (j >= blo) & (j <= bhi);
        const int cell = j == 0 ? i : min(min(cur, up) + 1, diag + (a_char != b_char));
        const int v = active ? cell : kBig;
        row_min = min(row_min, v);
        if (active & (i == m) & (j == n)) sh.result = v;
        diag = up;
        cur = v;
        b_char = next_b;
        const int idx = j - jlo_next + 1;
        if ((lane == 31) & (idx >= 0) & (idx < slots)) below[idx] = v;
      }
      if (lane == 31) {  // publish the steps written
        __threadfence_block();
        *mine = s * kTag + min(t0 + kBandChunk, steps);
      }
    }
    if (gone) break;
    const unsigned over = __ballot_sync(kFull, row_ok && row_min > k);
    if (over != 0 && lane == 0) {
      atomicMin(&sh.stop_row, r0 + __ffs(over) - 1);
      atomicMin(&sh.stop_strip, s);
    }
  }
  __syncthreads();
  Rung rung{sh.result, sh.stop_row == INT_MAX ? 0 : sh.stop_row, sh.failed != 0};
  return rung;
}

// One CTA per pair. out[pair] = {distance (0 unless certified), status
// (1 certified, 2 distance > kmax, 3 a wait stalled), the last rung's k,
// band cells walked (the rows of each rung up to its stopping strip)}.
__global__ void __launch_bounds__(kBandThreads)
wavefront_band(const int32_t* __restrict__ chars, const long long* __restrict__ pairs, int kmax,
               long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  BandShared& sh = *reinterpret_cast<BandShared*>(band_smem);
  const long long* rec = pairs + static_cast<long long>(blockIdx.x) * kBandRecord;
  const int32_t* a = chars + rec[0];
  const int32_t* b = chars + rec[2];
  const int m = static_cast<int>(rec[1]), n = static_cast<int>(rec[3]);
  int k = static_cast<int>(rec[4]);
  long long cells = 0;
  int res = 0, status = 0;
  while (true) {
    const Rung rung = band_rung(a, b, m, n, k, sh);
    if (rung.failed) {
      status = 3;
      break;
    }
    const int rows = rung.stop_row ? min(m, (rung.stop_row + 31) / 32 * 32) : m;
    cells += band_row_cells(rows, n, k);
    if (!rung.stop_row && rung.res <= k) {
      res = rung.res;
      status = 1;
      break;
    }
    if (k >= kmax) {
      status = 2;
      break;
    }
    long long est = rung.res;
    if (rung.stop_row) {
      est = static_cast<long long>(k) * m / rung.stop_row;
      est += est / 4;
    }
    long long next = 2LL * k;
    while (next < min(est, static_cast<long long>(kmax))) next *= 2;
    k = static_cast<int>(min(next, static_cast<long long>(kmax)));
  }
  if (threadIdx.x == 0) {
    long long* o = out + 4LL * blockIdx.x;
    o[0] = res;
    o[1] = status;
    o[2] = k;
    o[3] = cells;
  }
}

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
void launch(dim3 grid, cudaStream_t stream, const int32_t* chars, const long long* pairs,
            int diag, const int32_t* table, Costs costs, int32_t* scratch, int32_t* out) {
  wavefront_tile<kMax, kLocal, kAffine, kClass><<<grid, kRows, 0, stream>>>(
      chars, pairs, diag, table, costs, scratch, out);
}

using Launcher = void (*)(dim3, cudaStream_t, const int32_t*, const long long*, int,
                          const int32_t*, Costs, int32_t*, int32_t*);

// Indexed by max * 8 + local * 4 + affine * 2 + classes.
constexpr Launcher kLaunchers[16] = {
    launch<false, false, false, false>, launch<false, false, false, true>,
    launch<false, false, true, false>,  launch<false, false, true, true>,
    launch<false, true, false, false>,  launch<false, true, false, true>,
    launch<false, true, true, false>,   launch<false, true, true, true>,
    launch<true, false, false, false>,  launch<true, false, false, true>,
    launch<true, false, true, false>,   launch<true, false, true, true>,
    launch<true, true, false, false>,   launch<true, true, false, true>,
    launch<true, true, true, false>,    launch<true, true, true, true>,
};

constexpr int kMaxGroup = 65535;  // pairs of one group: the grid's y extent

long long tiles_of(long long len, int tile) { return (len + tile - 1) / tile; }

// Words of a pair's row frontier (kCols + 1 per tile column) and column
// frontier (kRows + 1 per tile row), twice each when affine.
long long row_words(bool affine, long long n) {
  return tiles_of(n, kCols) * (kCols + 1) * (affine ? 2 : 1);
}
long long col_words(bool affine, long long m) {
  return tiles_of(m, kRows) * (kRows + 1) * (affine ? 2 : 1);
}

}  // namespace

// int32 scratch words that sz_wavefront needs for pairs[n_pairs][4] (a_off,
// m, b_off, n, on the host): returns the sum, and the most one pair needs in
// *largest. A scratch of at least *largest words lets every call run.
extern "C" long long sz_wavefront_scratch_words(int affine, const long long* pairs, int n_pairs,
                                                long long* largest) {
  long long total = 0;
  *largest = 0;
  for (int p = 0; p < n_pairs; ++p) {
    const long long w = row_words(affine, pairs[4 * p + 3]) + col_words(affine, pairs[4 * p + 1]);
    total += w;
    *largest = std::max(*largest, w);
  }
  return total;
}

// Flat-tier scores of n_pairs pairs into out[n_pairs] (int32).
//   chars    int32 chars (class ids when classes != 0) of every pair;
//   pairs    [n_pairs][4] int64 on the host: a_off, m, b_off, n (m, n >= 1);
//   records  [n_pairs][6] int64 on the device, filled here;
//   table    [32][32] int32 class costs (read only when classes != 0);
//   scratch  scratch_words int32 frontier words, no initialisation needed;
//   out      must hold 0 for local scores; global ones are written.
// Consecutive pairs whose frontiers fit the scratch form a group; each group
// runs one launch per tile diagonal, max over its pairs of (tile rows + tile
// columns - 1), all added to *launches. Launches on `stream` without
// synchronising; returns the first failing status.
extern "C" cudaError_t sz_wavefront(int objective_max, int local, int affine, int classes,
                                    int gap, int extend, int match, int mismatch,
                                    const int32_t* chars, const long long* pairs, int n_pairs,
                                    long long* records, const int32_t* table, int32_t* scratch,
                                    long long scratch_words, int32_t* out, long long* launches,
                                    cudaStream_t stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (classes && table == nullptr) return cudaErrorInvalidValue;
  const Costs costs{gap, extend, match, mismatch};
  const Launcher run = kLaunchers[(objective_max ? 8 : 0) + (local ? 4 : 0) +
                                  (affine ? 2 : 0) + (classes ? 1 : 0)];
  // Each record: a_off, m, b_off, n, then where the pair's row and column
  // frontiers start in the scratch. The host copy outlives every group's
  // upload (a pageable copy is staged before cudaMemcpyAsync returns).
  std::vector<long long> rec(static_cast<size_t>(n_pairs) * kRecord);
  int begin = 0;
  while (begin < n_pairs) {
    int end = begin, diags = 0;
    long long words = 0;
    while (end < n_pairs && end - begin < kMaxGroup) {
      const long long* p = pairs + 4LL * end;
      if (p[1] < 1 || p[3] < 1) return cudaErrorInvalidValue;
      const long long h = row_words(affine, p[3]), w = h + col_words(affine, p[1]);
      if (w > scratch_words) return cudaErrorInvalidValue;
      if (end > begin && words + w > scratch_words) break;
      long long* r = rec.data() + static_cast<size_t>(end) * kRecord;
      r[0] = p[0], r[1] = p[1], r[2] = p[2], r[3] = p[3], r[4] = words, r[5] = words + h;
      words += w;
      diags = std::max(diags, static_cast<int>(tiles_of(p[1], kRows) + tiles_of(p[3], kCols) - 1));
      ++end;
    }
    cudaError_t err = cudaMemcpyAsync(records + static_cast<size_t>(begin) * kRecord,
                                      rec.data() + static_cast<size_t>(begin) * kRecord,
                                      sizeof(long long) * kRecord * (end - begin),
                                      cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return err;
    for (int t = 0; t < diags; ++t) {
      long long width = 1;  // the most tiles any pair of the group has on diagonal t
      for (int q = begin; q < end; ++q) {
        const long long tr = tiles_of(pairs[4LL * q + 1], kRows);
        const long long tc = tiles_of(pairs[4LL * q + 3], kCols);
        width = std::max(width, std::min<long long>(t, tr - 1) - std::max<long long>(0, t - tc + 1) + 1);
      }
      run(dim3(static_cast<unsigned>(width), static_cast<unsigned>(end - begin)), stream, chars,
          records + static_cast<size_t>(begin) * kRecord, t, table, costs, scratch, out + begin);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      ++*launches;
    }
    begin = end;
  }
  return cudaSuccess;
}

// Band-tier distances of n_pairs unit-cost pairs, one CTA each, in one
// launch added to *launches.
//   chars   int32 chars of every pair;
//   pairs   [n_pairs][5] int64 on the device: a_off, m, b_off, n (m, n >= 1)
//           and the first rung's half-width k, |m - n| <= k <= kmax;
//   kmax    the widest rung, at most 2047;
//   out     [n_pairs][4] int64: distance, status, last k, band cells walked.
// Status 3 (a stalled wait) is a fault of the kernel; the host raises on it.
extern "C" cudaError_t sz_wavefront_band(const int32_t* chars, const long long* pairs,
                                         int n_pairs, int kmax, long long* out,
                                         long long* launches, cudaStream_t stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (kmax < 2 || kmax > kBandMax) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(BandShared));
  cudaError_t err = cudaFuncSetAttribute(wavefront_band,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wavefront_band<<<n_pairs, kBandThreads, smem, stream>>>(chars, pairs, kmax, out);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}
