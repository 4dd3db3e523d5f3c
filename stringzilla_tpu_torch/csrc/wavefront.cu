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
#include <type_traits>
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
// Band tier: the exact unit-cost Levenshtein distance of long pairs by
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
// What bounds it on this card. A rung walks about 2k + 1 cells a row, 5-9
// int32 operations each, but only the cells of one anti-diagonal are
// independent: about k of them, and the m + n anti-diagonals follow one
// another. So a rung is a chain of ~2m dependent steps, and its time is the
// chain times the time of a step; the operations bound (all band cells over
// 132 SMs of int32 issue) is far below it.
//
// The design: the pair's band rows in strips of 32 * R rows, a warp each, on
// a circle of W warps spread over C CTAs of 4 warps (one a scheduler of an
// SM), so that a step is as short as one warp alone on a scheduler makes it.
// Lane l holds the R consecutive rows r0 + l * R + q of strip s (r0 = 32 R s
// + 1) and at step t computes the cell of each at column jlo + t - l R - q:
// R independent cells of one anti-diagonal, kept in registers. The cell
// above is the row above's value of the previous step (lane l - 1's through
// one __shfl_up_sync for the first row), the cell to the left the row's own,
// the diagonal one the row above's of two steps before; the unit cost is
// min(min(left, up) + 1, diag + (a != b)) through the DPX add-min
// __viaddmin_s32, and a cell outside the band or the matrix is masked to
// BIG (one compare of the step with the row's window), but in chunks where
// every row of the strip is inside its band. b's chars pass down the lanes
// as a shift register: lane 0 takes them from a chunk of C steps read a
// chunk ahead, one char a lane. The rows' minima for the stop rule are one
// min a cell. Strip s runs on warp s mod W and hands its bottom row to strip
// s + 1 on the next warp of the circle through a ring of 64 tagged slots
// (value and sequence number in one 64-bit store, relaxed at device scope,
// under a predicate, so no fence and no branch): in shared memory inside a
// CTA, in device memory from a CTA's last warp to the next CTA's first (the
// last CTA's to the first). A stream's slots start at a sequence number
// aligned so that a chunk's C slots lie side by side and each step stores
// at a constant offset. The strip below reads C slots at once, one chunk
// ahead of their use, checks their tags with one vote and reports how many
// it consumed; the strip above looks at that count before it overwrites a
// slot. Strip s + 1 trails strip s by 64 R - 1 steps and the chunk where
// the band has left column 0 (32 R - 1 and the chunk before): the time of a
// strip's first steps is the chain's time a strip, so they run unchecked
// like the rest. W (from the host's plan, ops/wavefront.py band_plan) is
// large enough that strip s is done, its warp free, before strip s + W's
// first slot arrives, and that the rings never hold a cycle of waits, at
// the widest band the ladder can reach. There is no row buffer: the strips
// in flight depend on neither k nor shared memory. A wait reads the group's
// flags in device memory only after ~16 us, so a slow read never delays
// noticing a slot.
//
// Rungs run without the host. At the end of a rung the pair's C CTAs meet at
// an arrive count in device memory; the last to arrive applies the ladder
// rule, writes the pair's result when it is done, and releases the others
// with the next k. The rings are zeroed between rungs: shared ones while the
// CTA is between rungs, device ones a rung ahead in the other of two sets.
// The rings and the barrier need every CTA of a group resident at once: the
// plan sizes the grid from the card's occupancy, and the launch is a
// cooperative one, for its guarantee that the whole grid is resident (there
// is no grid-wide sync). A grid of G groups takes pairs g, g + G, ... in
// turn. A strip stops early only once a row of an earlier strip stopped the
// rung (so the stop row is the first), and its waits give up then. Every
// wait is bounded: one that spins too long marks the group failed, every
// later wait of the group gives up, and the pair gets status 3, which the
// host raises on.

constexpr int kBandRows = 2;    // rows a lane R: a strip is a warp of 32 R rows
constexpr int kBandWarps = 4;   // warps a CTA, one a scheduler of an SM
constexpr int kBandChunk = 16;  // steps a strip reads from the strip above at once
constexpr int kBandRing = 64;   // slots of a hand-off ring, then its consumed count
constexpr int kBandMax = 2047;  // the widest half-width
constexpr int kBandRecord = 5;  // per pair: a_off, m, b_off, n, first k
constexpr int kBig = 1 << 28;   // the JAX kernel's identity
constexpr int kNoChar = -1;     // a char of b past its ends: only masked cells compare it
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s at 1.98 GHz
constexpr long long kQuietCycles = 1 << 15;  // ~16 us between a wait's looks at the flags
constexpr long long kRowCycles = 8192;  // a rung barrier waits longer: this much a row more
constexpr int kStalled = 3;
constexpr unsigned long long kAbort = 1ULL << 32;  // a rung barrier stalled
constexpr int kGroupBytes = 64;

// One CTA group's state, in device memory zeroed by the host.
struct BandGroup {
  unsigned arrive;             // CTAs arrived at the group's rung barriers
  int stop_key;                // INT_MAX - the rung's first row with no band cell <= k; 0: none
  int result;                  // D[m][n] within the band, once the rung reached it
  int failed;                  // a wait stalled: every later wait of the group gives up
  unsigned long long release;  // barriers passed << 32 | the next rung's k (0: pair done)
  long long cells;             // band cells the pair's rungs walked so far
};
static_assert(sizeof(BandGroup) <= kGroupBytes, "a group's state outgrew its bytes");

struct BandArgs {
  const int32_t* chars;
  const long long* pairs;  // [n_pairs][kBandRecord]
  long long* out;          // [n_pairs][4]
  BandGroup* groups;       // [n_groups]
  long long* rings;        // [2][grid][kBandRing + 1]: set, then the ring feeding CTA c's first warp
  int n_pairs, kmax, group_ctas, n_groups;
};

// A strip's ring to the strip above or below: slots and the consumed count,
// in shared or device memory.
struct BandLink {
  long long* slots;
  long long* consumed;
};

// Ring words are read and written relaxed at device scope through generic
// addresses (a volatile access would be ordered at system scope), and a
// step's slot is stored under a predicate rather than a branch.
__device__ __forceinline__ long long ring_load(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void ring_store(long long* p, long long v, bool on = true) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q st.relaxed.gpu.b64 [%0], %1;\n\t}"
      ::"l"(p), "l"(v), "r"(static_cast<int>(on)));
}

// Band cells of rows 1..r: sum of min(n, i + k) - max(0, i - k) + 1.
__device__ long long band_row_cells(long long r, long long n, long long k) {
  const long long c = min(r, max(0LL, n - k));  // rows with i + k <= n
  const long long d = max(0LL, r - k);          // rows with i > k
  return c * (c + 1) / 2 + c * k + (r - c) * n - d * (d + 1) / 2 + r;
}

__device__ __forceinline__ int b_char(const int32_t* b, int n, int j) {
  return j >= 0 && j < n ? __ldg(b + j) : kNoChar;
}

// Whether strip r0's waits should give up: a row above it stopped the rung,
// or a wait of the group stalled. Lane 0 decides for the warp.
__device__ __forceinline__ bool band_gone(BandGroup* grp, int r0) {
  int gone = 0;
  if ((threadIdx.x & 31) == 0) {
    const volatile BandGroup* g = grp;
    gone = g->failed != 0 || g->stop_key > INT_MAX - r0;
  }
  return __shfl_sync(kFull, gone, 0) != 0;
}

// One more round of a strip's bounded wait that began at `start` and last
// looked at the group's flags at `looked`: false once it should give up, or
// it spun past kWaitCycles (it marks the group failed). The flags lie in
// device memory, so a wait reads them once every kQuietCycles: a read that
// takes a microsecond in every round would delay noticing the data a strip
// waits for. The clock is the same in every lane.
__device__ __forceinline__ bool band_waiting(long long& start, long long& looked,
                                             BandGroup* grp, int r0) {
  const long long now = clock64();
  if (start < 0) start = looked = now;
  if (now - looked < kQuietCycles) return true;
  looked = now;
  if (now - start > kWaitCycles && (threadIdx.x & 31) == 0) atomicExch(&grp->failed, 1);
  return !band_gone(grp, r0);
}

// Strip s of a rung of half-width k: rows r0 .. r0 + 32 R - 1 (r0 = 32 R s +
// 1) of the pair's band, the last strip when `last`. `up` brings row r0 - 1
// (not read by strip 0, whose row above is row 0), `down` takes row r0 + 32
// R - 1 to strip s + 1 (not by the last strip); seq_in and seq_out count the
// slots through each so far this rung. False when the strip gave up.
__device__ bool band_strip(BandGroup* grp, const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b, int m, int n, int k, int s, bool last,
                           BandLink up, BandLink down, unsigned& seq_in, unsigned& seq_out) {
  constexpr int R = kBandRows, H = 32 * R, C = kBandChunk;
  const int lane = threadIdx.x & 31;
  const int r0 = s * H + 1;
  if (band_gone(grp, r0)) return false;
  const int jlo = max(0, r0 - k);  // the strip's first band column
  const int i_last = min(m, r0 + H - 1);
  const int steps = min(n, i_last + k) - jlo + (i_last - r0) + 1;
  // Element e from above is row r0 - 1 at column jlo - 1 + e, e <= e_last
  // (past it the row above is out of its band: BIG). Element e below is the
  // bottom row at column jlo_next - 1 + e, computed at step e + off.
  const int e_last = min(n, r0 - 1 + k) - jlo + 1;
  const int off = max(0, r0 + H - k) - jlo + H - 2;
  const int t_end = last ? n - jlo + (m - r0) : -1;  // the step of cell (m, n)
  const int base = lane * R;
  // A stream's first slot has the sequence number of the step that computes
  // its element 0, modulo the chunk: so a chunk's C slots lie side by side
  // in the ring and each step stores at a constant offset.
  const auto align = [](unsigned seq, int first_step) {
    return seq + ((first_step - static_cast<int>(seq)) & (C - 1));
  };
  if (s > 0) seq_in = align(seq_in, max(0, r0 - k) - max(0, r0 - H - k) + H - 2);
  if (!last) seq_out = align(seq_out, off);

  int ac[R], bc[R], D1[R], D2[R], tlo[R], wid[R], rmin[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = r0 + base + q;
    if (i <= m) {  // row i's band, max(0, i - k) .. min(n, i + k), is computed at steps tlo .. tlo + wid
      const int lo = max(0, i - k), hi = min(n, i + k);
      tlo[q] = lo - jlo + base + q;
      wid[q] = hi - lo;
      ac[q] = __ldg(a + i - 1);
    } else {  // past the matrix: masked at every step
      tlo[q] = -(1 << 30);
      wid[q] = 0;
      ac[q] = kNoChar;
    }
    bc[q] = b_char(b, n, jlo - base - q - 1);
    D1[q] = D2[q] = rmin[q] = kBig;
  }
  int x2 = kBig;  // the diagonal cell of the first row: lane l - 1's last row two steps before
  int res = -1;
  // The steps at which every row of the strip is inside its band (none when
  // the strip reaches past row m).
  int inside_from = INT_MAX, inside_to = INT_MIN;
  if (r0 + H - 1 <= m) {
    inside_from = tlo[0], inside_to = tlo[0] + wid[0];
#pragma unroll
    for (int q = 1; q < R; ++q) {
      inside_from = max(inside_from, tlo[q]);
      inside_to = min(inside_to, tlo[q] + wid[q]);
    }
    inside_from = __reduce_max_sync(kFull, inside_from);
    inside_to = __reduce_min_sync(kFull, inside_to);
  }

  // Lane c < C of the chunk at step tau holds element tau + c + 1 (the cell
  // above the strip at step tau + c) and the char of b entering the first
  // row after step tau + c; lane C of the first chunk holds element 0 (the
  // first step's diagonal).
  const bool from_ring = s > 0, to_ring = !last;
  const auto element = [&](int tau) { return tau == 0 && lane == C ? 0 : tau + lane + 1; };
  const auto needs = [&](int tau) {
    return from_ring && (lane < C || (tau == 0 && lane == C)) && element(tau) <= e_last;
  };
  long long word = 0;
  unsigned consumed = 0, seen = 0;
  int b_next = kNoChar;
  const auto prefetch = [&](int tau) {
    if (lane < C) b_next = b_char(b, n, jlo + tau + lane);
    if (needs(tau)) word = ring_load(up.slots + ((seq_in + element(tau)) & (kBandRing - 1)));
    if (to_ring && lane == 0) consumed = static_cast<unsigned>(ring_load(down.consumed));
  };
  prefetch(0);
  const bool sends = lane == 31 && to_ring;  // the bottom row's lane

  for (int tau = 0; tau < steps; tau += C) {
    int above;
    if (from_ring) {
      const bool need = needs(tau);
      const unsigned tag = seq_in + element(tau) + 1;
      long long start = -1, looked = 0;
      while (!__all_sync(kFull, !need || static_cast<unsigned>(word >> 32) == tag)) {
        if (!band_waiting(start, looked, grp, r0)) return false;
        if (need) word = ring_load(up.slots + ((tag - 1) & (kBandRing - 1)));
      }
      above = need ? static_cast<int>(static_cast<unsigned>(word)) : kBig;
      if (lane == 0) ring_store(up.consumed, seq_in + min(tau + C, e_last) + 1);  // elements read
    } else {  // row 0: D[0][j] = j in its band
      const int col = jlo - 1 + element(tau);
      above = col >= 0 && col <= min(n, k) ? col : kBig;
    }
    if (tau == 0) {
      const int e0 = __shfl_sync(kFull, above, C);
      if (lane == 0) x2 = e0;
    }
    const int b_in = b_next;
    const int last_out = min(tau + C, steps) - 1 - off;
    if (to_ring && last_out >= 0) {  // room in the ring for this chunk's slots
      seen = __shfl_sync(kFull, consumed, 0);
      long long start = -1, looked = 0;
      while (static_cast<int>(seen - (seq_out + last_out - (kBandRing - 1))) < 0) {
        if (!band_waiting(start, looked, grp, r0)) return false;
        unsigned now = 0;
        if (lane == 0) now = static_cast<unsigned>(ring_load(down.consumed));
        seen = __shfl_sync(kFull, now, 0);
      }
    }
    if (tau + C < steps) prefetch(tau + C);

    // kWhole: every step of the chunk runs and none is cell (m, n);
    // otherwise each step checks. kInside: every cell of the chunk lies in
    // its row's band, so none is masked. A step sends its bottom cell down
    // from step off on. The first off + C steps of a strip set when the
    // strip below can start, so they run whole too.
    const unsigned seq0 = seq_out + (tau - off);  // the slot of the chunk's first step
    long long* const slots = down.slots + (seq0 & (kBandRing - 1));  // C side by side
    const auto chunk = [&](auto whole, auto inside) {
      constexpr bool kWhole = decltype(whole)::value, kInside = decltype(inside)::value;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int t = tau + u;
        if (!kWhole && t >= steps) break;
        const int from_up = __shfl_sync(kFull, above, u);
        const int from_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
        const int x1 = lane == 0 ? from_up : from_lane;
#pragma unroll
        for (int q = R - 1; q >= 0; --q) {
          const int left = D1[q];
          const int upper = q > 0 ? D1[q - 1] : x1;
          const int diag = q > 0 ? D2[q - 1] : x2;
          // DPX: min(min(left, up) + 1, diag + sub) in one add-min
          int v = __viaddmin_s32(min(left, upper), 1, diag + (ac[q] != bc[q]));
          if (!kInside)
            v = static_cast<unsigned>(t - tlo[q]) <= static_cast<unsigned>(wid[q]) ? v : kBig;
          rmin[q] = min(rmin[q], v);
          if (!kWhole && t == t_end && base + q == m - r0) res = v;
          D2[q] = left;
          D1[q] = v;
        }
        x2 = x1;
        const int b_up = __shfl_sync(kFull, b_in, u);
        const int b_lane = __shfl_up_sync(kFull, bc[R - 1], 1);
#pragma unroll
        for (int q = R - 1; q > 0; --q) bc[q] = bc[q - 1];
        bc[0] = lane == 0 ? b_up : b_lane;
        ring_store(slots + u,
                   (static_cast<long long>(seq0 + u + 1) << 32) | static_cast<unsigned>(D1[R - 1]),
                   sends && t >= off);
      }
    };
    const bool whole = tau + C <= steps && !(tau <= t_end && t_end < tau + C);
    if (whole && tau >= inside_from && tau + C - 1 <= inside_to)
      chunk(std::true_type{}, std::true_type{});
    else if (whole)
      chunk(std::true_type{}, std::false_type{});
    else
      chunk(std::false_type{}, std::false_type{});
  }

  if (from_ring) seq_in += e_last + 1;
  if (to_ring) seq_out += steps - off;
  if (res >= 0) grp->result = res;
  // The strip's first row whose band cells all exceed k stops the rung.
  int first = INT_MAX;
#pragma unroll
  for (int q = R - 1; q >= 0; --q)
    if (r0 + base + q <= m && rmin[q] > k) first = r0 + base + q;
  first = __reduce_min_sync(kFull, first);
  if (first != INT_MAX && lane == 0) atomicMax(&grp->stop_key, INT_MAX - first);
  return true;
}

// The end of a rung for one CTA of the group (thread 0): arrive; the last
// CTA applies the ladder rule (writing the pair's row when it is done) and
// releases the others. Returns the next rung's k, 0 when the pair is done,
// or kAbort when the barrier stalled (the pair's row then says status 3).
__device__ unsigned long long band_barrier(const BandArgs& args, BandGroup* grp, int pair, int m,
                                           int n, int k, unsigned gen) {
  volatile BandGroup* v = grp;
  long long* o = args.out + 4LL * pair;
  const unsigned arrived = atomicAdd(&grp->arrive, 1u) + 1;
  if (arrived == (gen + 1) * static_cast<unsigned>(args.group_ctas)) {  // every strip is done
    __threadfence();
    const int key = v->stop_key;
    const int stop_row = key ? INT_MAX - key : 0;
    const int res = v->result;
    const int rows = stop_row ? min(m, (stop_row + 31) / 32 * 32) : m;
    const long long cells = v->cells + band_row_cells(rows, n, k);
    int status = 0, next = 0;
    if (v->failed) {
      status = kStalled;
    } else if (!stop_row && res <= k) {
      status = 1;
    } else if (k >= args.kmax) {
      status = 2;
    } else {
      long long est = res;
      if (stop_row) {
        est = static_cast<long long>(k) * m / stop_row;
        est += est / 4;
      }
      long long nxt = 2LL * k;
      while (nxt < min(est, static_cast<long long>(args.kmax))) nxt *= 2;
      next = static_cast<int>(min(nxt, static_cast<long long>(args.kmax)));
    }
    if (status) {
      o[0] = status == 1 ? res : 0;
      o[1] = status;
      o[2] = k;
      o[3] = cells;
    }
    v->stop_key = 0;
    v->cells = next ? cells : 0;
    __threadfence();
    v->release = (static_cast<unsigned long long>(gen + 1) << 32) | static_cast<unsigned>(next);
    return static_cast<unsigned>(next);
  }
  const long long start = clock64(), limit = kWaitCycles + kRowCycles * m;
  for (;;) {
    const unsigned long long r = v->release;
    if (static_cast<unsigned>(r >> 32) == gen + 1) {
      __threadfence();
      return r & 0xffffffffULL;
    }
    if (clock64() - start > limit) {
      atomicExch(&grp->failed, 1);
      o[1] = kStalled;
      return kAbort;
    }
    __nanosleep(64);
  }
}

// A grid of n_groups groups of group_ctas CTAs; group g takes pairs g,
// g + n_groups, ... in turn, each through its whole ladder.
__global__ void __launch_bounds__(kBandWarps * 32) wavefront_band(BandArgs args) {
  constexpr int H = 32 * kBandRows;
  constexpr int kRingWords = kBandRing + 1;
  __shared__ long long shared_rings[kBandWarps * kRingWords];  // ring w feeds warp w > 0
  __shared__ unsigned long long decision;
  const int C = args.group_ctas;
  const int group = static_cast<int>(blockIdx.x) / C;
  const int cta = static_cast<int>(blockIdx.x) - group * C;
  const int warp = threadIdx.x >> 5;
  const int W = C * kBandWarps, g = cta * kBandWarps + warp;  // this warp's place in the circle
  BandGroup* grp = args.groups + group;
  const size_t set_words = static_cast<size_t>(gridDim.x) * kRingWords;
  const size_t next_cta = static_cast<size_t>(group) * C + (cta + 1) % C;
  unsigned gen = 0;  // rung barriers passed
  for (int pair = group; pair < args.n_pairs; pair += args.n_groups) {
    const long long* rec = args.pairs + static_cast<long long>(pair) * kBandRecord;
    const int32_t* a = args.chars + rec[0];
    const int32_t* b = args.chars + rec[2];
    const int m = static_cast<int>(rec[1]), n = static_cast<int>(rec[3]);
    const int strips = (m + H - 1) / H;
    int k = static_cast<int>(rec[4]);
    for (;;) {
      // Zero this rung's shared rings and the device ring that feeds this
      // CTA in the next rung (the set of the rung before this one).
      long long* rings = args.rings + (gen & 1) * set_words;
      long long* spare = args.rings + ((gen + 1) & 1) * set_words + blockIdx.x * kRingWords;
      for (int x = threadIdx.x; x < kBandWarps * kRingWords; x += blockDim.x) shared_rings[x] = 0;
      for (int x = threadIdx.x; x < kRingWords; x += blockDim.x) spare[x] = 0;
      __syncthreads();
      const auto link = [](long long* p) { return BandLink{p, p + kBandRing}; };
      const BandLink up = warp > 0 ? link(shared_rings + warp * kRingWords)
                                   : link(rings + blockIdx.x * kRingWords);
      const BandLink down = warp + 1 < kBandWarps ? link(shared_rings + (warp + 1) * kRingWords)
                                                  : link(rings + next_cta * kRingWords);
      unsigned seq_in = 0, seq_out = 0;
      for (int s = g; s < strips; s += W)
        if (!band_strip(grp, a, b, m, n, k, s, s == strips - 1, up, down, seq_in, seq_out)) break;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) decision = band_barrier(args, grp, pair, m, n, k, gen);
      __syncthreads();
      const unsigned long long next = decision;
      ++gen;
      if (next == kAbort) return;
      if (next == 0) break;
      k = static_cast<int>(next);
    }
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

// CTAs (of 4 warps) of the band kernel that an SM holds at once.
extern "C" cudaError_t sz_wavefront_band_occupancy(int* ctas_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, wavefront_band,
                                                       kBandWarps * 32, 0);
}

// Band-tier distances of n_pairs unit-cost pairs in one launch, added to
// *launches.
//   chars    int32 chars of every pair;
//   pairs    [n_pairs][5] int64 on the device: a_off, m, b_off, n (m, n >= 1)
//            and the first rung's half-width k, |m - n| <= k <= kmax;
//   kmax     the widest rung, at most 2047;
//   plan     [7] int64 on the host, from ops/wavefront.py band_plan: rows a
//            lane R (2), steps a chunk (16), warps a CTA (4), CTAs a group,
//            groups (at most n_pairs), ring slots (64), and the bytes of
//            `handoff` it lays out: 64 a group (its state), then two sets of
//            one ring (65 int64) a CTA;
//   handoff  at least that many bytes of device memory, zeroed here;
//   out      [n_pairs][4] int64: distance, status, last k, band cells
//            walked, zeroed by the caller (a row a stalled group never
//            reached keeps status 0).
// Status 3 (a stalled wait) is a fault of the kernel; the host raises on any
// status but 1 and 2. Launches on `stream` without synchronising, as a
// cooperative launch so that every CTA is resident at once; refuses a plan
// whose CTAs the card cannot hold at once (cudaErrorCooperativeLaunchTooLarge).
extern "C" cudaError_t sz_wavefront_band(const int32_t* chars, const long long* pairs,
                                         int n_pairs, int kmax, const long long* plan,
                                         void* handoff, long long handoff_bytes, long long* out,
                                         long long* launches, cudaStream_t stream) {
  if (n_pairs <= 0) return cudaSuccess;
  const long long ctas = plan[3], groups = plan[4];
  const long long needed = groups * kGroupBytes + 2 * groups * ctas * (kBandRing + 1) * 8;
  if (plan[0] != kBandRows || plan[1] != kBandChunk || plan[2] != kBandWarps || ctas < 1 ||
      groups < 1 || groups > n_pairs || plan[5] != kBandRing || plan[6] != needed ||
      handoff_bytes < needed || kmax < 2 || kmax > kBandMax)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = sz_wavefront_band_occupancy(&per_sm);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (groups * ctas > static_cast<long long>(per_sm) * sms) return cudaErrorCooperativeLaunchTooLarge;

  err = cudaMemsetAsync(handoff, 0, static_cast<size_t>(needed), stream);
  if (err != cudaSuccess) return err;
  char* base = static_cast<char*>(handoff);
  BandArgs args{chars, pairs, out, reinterpret_cast<BandGroup*>(base),
                reinterpret_cast<long long*>(base + groups * kGroupBytes), n_pairs, kmax,
                static_cast<int>(ctas), static_cast<int>(groups)};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wavefront_band),
                                    dim3(static_cast<unsigned>(groups * ctas)),
                                    dim3(kBandWarps * 32), params, 0, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}
