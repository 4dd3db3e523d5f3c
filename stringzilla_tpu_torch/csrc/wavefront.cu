// Anti-diagonal DP scores of long pairs, hand-written for Hopper (sm_90a):
// the band tier (wavefront_band) for unit-cost Levenshtein, and the flat
// tier (wavefront_flat) for every configuration.
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
// What bounds the flat tier on this card. A cell is 3 (linear) to 6
// (affine) int32 issue slots with the DPX add-min/max fusing each add into
// its min or max, plus the substitution (one shared-memory byte load with
// classes, a compare and a select without) and, when local, the clamp and
// the running best; the chars are O(m + n) bytes against O(m * n) cells. So
// it is bound by integer issue, 132 SMs x 64 int32 lanes a clock, and, for
// one pair, by its m + n anti-diagonals, one after the other: only the cells
// of one anti-diagonal are independent.
//
// What the design does about it. The TPU kernel swept one anti-diagonal a
// step over a tile holding the whole diagonal in VMEM. The first Hopper
// design cut the matrix into 32 x 64 tiles, a warp each, one launch a tile
// diagonal: a launch's gap and tail, and a tile's frontier loads and stores,
// every 2,048 cells. Here a pair's rows are cut into strips of H = 32 R
// rows, R = 4 rows a lane (8 was slower on the long reads and the long
// pair), as the host's plan lays them out (ops/wavefront.py flat_plan), and
// one warp marches a strip across all n columns. The rows are the shorter
// string's (the matrix of (b, a) has the same score with the class table
// transposed), so a thin pair is one strip, not a chain of strips that each
// wait for the one above to leave its first columns. Lane l holds rows r0 +
// l R + q, q < R, and at step t computes the cell of row offset o = l R + q
// at column t - o + 1: R independent cells of one anti-diagonal, in
// registers. The cell above comes from the row above's value of the step
// before (lane l - 1's last row through one __shfl_up_sync, and J the same
// way when affine), the cell to the left is the row's own, the diagonal one
// the row above's of two steps before; b's chars pass down the lanes as a
// shift register, lane 0 taking them from a chunk of C steps read a chunk
// ahead. Class costs come from a per-lane profile in shared memory: lane l
// keeps table[class of its row q][c] for its R rows and the 32 classes c as
// bytes, all in bank l, so each cell's cost is one conflict-free signed byte
// load whose address the shift register carries (c * H + 4 l, plus the
// warp's base; the row's byte is an immediate). A strip hands its bottom row
// (D, and J when affine) to the strip below through device memory: one
// 64-bit slot a column, value and the writer's strip number + 1 in one
// relaxed store, no fence; the strip below reads C slots at once, a chunk
// ahead of their use, and checks their tags with one vote. Each pair has two
// such rows of slots, taken by strip parity: strip s + 2 overwrites column j
// only after it computed its own bottom cell there, which needed strip s +
// 1's, which had read strip s's, so no slot is overwritten before it is read
// and no writer waits. Only strip 0 computes the boundary row; the left
// boundary is the boundary function. Cells before column 1 and after column
// n (the first and last H - 1 steps of a strip) keep their value through a
// select, in chunks that hold any such cell; the other chunks run unmasked.
// One launch a group of pairs: a persistent grid whose warps claim strips
// in the host's order (strip-major across the group's pairs) from a counter
// in device memory. The host sizes the grid from the strips, at most 3 CTAs
// an SM (fewer than the occupancy API allows): warps that share a scheduler
// slow one another's step, and a pair's chain of strips sets its time, so a
// lone pair runs fastest with one warp a scheduler. A strip waits only on the
// strip above, which a running warp claimed earlier, so the waits form no
// cycle and need no residency guarantee. A wait backs off with __nanosleep
// and is bounded: one that spins past ~8 s marks the group's status 3,
// every other wait then gives up, and the host raises. Local bests meet in
// out[pair] through one atomic min/max a strip; a global score is the last
// strip's cell (m, n), which keeps its value past column n.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "dp_cells.cuh"

namespace {

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
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s at 1.98 GHz
constexpr long long kRowCycles = 8192;  // a rung barrier waits longer: this much a row more
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


// ---------------------------------------------------------------------------
// Flat tier: strips of 32 R rows a warp, claimed in order by a persistent
// grid (the design is in the note at the head of this file).

constexpr int kFlatRows = 4;     // rows a lane R: a strip is a warp of 32 R rows
constexpr int kFlatWarps = 4;    // warps a CTA
constexpr int kFlatChunk = 16;   // steps a strip reads from the strip above at once
constexpr int kFlatRecord = 6;   // per pair: a_off, m, b_off, n, its slots' offset, transposed
constexpr int kFlatGroup = 6;    // per group: first pair, pairs, first claim, claims, CTAs, slots

struct FlatArgs {
  const int32_t* chars;
  const long long* pairs;  // the group's [pairs][kFlatRecord]
  const int2* claims;      // the group's strips in claim order: (pair of the group, strip)
  const int32_t* table;    // [32][32] class costs (classes only)
  long long* slots;        // per pair with 2+ strips: 2 parities x (n + 1) D slots, then as many J
  int* header;             // [0] status (3: a wait stalled), [1] strips claimed
  int32_t* out;            // the group's scores
  Costs costs;
  int n_claims;
};

constexpr int kFlatProfileBytes = kClasses * 32 * kFlatRows;  // a warp's: 32 classes x 32 R rows

// Strip s of pair `pair`: rows r0 = 32 R s + 1 .. min(m, r0 + 32 R - 1)
// through every column. `prof` is the shared memory of the CTA, `warp_base`
// the byte offset of this warp's profile in it. False when a wait stalled.
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__device__ bool flat_strip(const FlatArgs& args, int pair, int s, unsigned char* prof,
                           int warp_base) {
  constexpr int R = kFlatRows, H = 32 * R, C = kFlatChunk;
  const Costs c = args.costs;
  const long long* rec = args.pairs + static_cast<long long>(pair) * kFlatRecord;
  const int32_t* a = args.chars + rec[0];
  const int32_t* b = args.chars + rec[2];
  const int m = static_cast<int>(rec[1]), n = static_cast<int>(rec[3]);
  const bool transposed = rec[5] != 0;  // a is the pair's second string: costs are table[b][a]
  const int lane = threadIdx.x & 31;
  const int r0 = s * H + 1;
  const int rows = min(H, m - r0 + 1);
  const bool last = r0 + H > m;
  const int base = lane * R;   // this lane's first row offset
  const int rq = rows - base;  // its rows q < rq lie in the matrix
  const long long stride = (n + 1LL) * (kAffine ? 2 : 1);
  long long* const up = args.slots + rec[4] + ((s + 1) & 1) * stride;  // strip s - 1's row
  long long* const down = args.slots + rec[4] + (s & 1) * stride;
  const unsigned tag_in = s, tag_out = s + 1;
  const signed char* const cost = reinterpret_cast<const signed char*>(prof);

  // The shift register's value of b[j] entering lane l: the char, or with
  // classes the byte offset of its class's costs in lane l's profile.
  const auto b_value = [&](int j, int l) {
    const int ch = j >= 0 && j < n ? __ldg(b + j) : kNoChar;
    return kClass ? warp_base + clamp_class(ch) * H + 4 * l : ch;
  };
  int bc[R], ac[kClass ? 1 : R], D1[R], D2[R], I[kAffine ? R : 1], J[kAffine ? R : 1];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = r0 + base + q;
    D1[q] = D2[q] = boundary<kLocal, kAffine>(i, c);
    if constexpr (kAffine) I[q] = J[q] = gap_boundary<kLocal, kAffine>(i, c);
    if constexpr (!kClass) ac[q] = q < rq ? __ldg(a + i - 1) : kNoChar;
    bc[q] = b_value(-(base + q), lane);
  }
  if constexpr (kClass)
    fill_profile<R>(prof, warp_base, a + r0 + base - 1, rq, args.table, transposed);
  int x2 = boundary<kLocal, kAffine>(r0 + base - 1, c);  // the first row's diagonal at column 1
  int best = 0;

  // Lane u < C of the chunk at step tau holds, for step tau + u, the cells
  // above row r0 at column tau + u + 1 (D, and J), and the char of b
  // entering row r0 after step tau + u.
  const bool reads = s > 0;
  long long wd = 0, wj = 0;
  int b_next = 0;
  const auto prefetch = [&](int tau) {
    if (lane < C) {
      const int col = tau + lane + 1;
      b_next = b_value(col, 0);
      if (reads && col <= n) {
        wd = ring_load(up + col);
        if constexpr (kAffine) wj = ring_load(up + n + 1 + col);
      }
    }
  };
  prefetch(0);
  const int steps = (n + rows - 1 + C - 1) / C * C;  // cell (r0 + rows - 1, n) is step n + rows - 2
  const bool sends = !last && lane == 31;            // the bottom row's lane

  for (int tau = 0; tau < steps; tau += C) {
    const int col = tau + lane + 1;
    int above_d, above_j = 0;
    if (reads) {
      const bool need = lane < C && col <= n;
      long long start = -1, looked = 0;
      unsigned nap = 0;
      const auto arrived = [&] {
        return static_cast<unsigned>(wd >> 32) == tag_in &&
               (!kAffine || static_cast<unsigned>(wj >> 32) == tag_in);
      };
      while (!__all_sync(kFull, !need || arrived())) {
        if (!flat_waiting(start, looked, nap, args.header)) return false;
        if (need) {
          wd = ring_load(up + col);
          if constexpr (kAffine) wj = ring_load(up + n + 1 + col);
        }
      }
      above_d = static_cast<int>(wd);
      above_j = static_cast<int>(wj);
    } else {  // row 0
      above_d = boundary<kLocal, kAffine>(col, c);
      if constexpr (kAffine) above_j = gap_boundary<kLocal, kAffine>(col, c);
    }
    const int b_in = b_next;
    if (tau + C < steps) prefetch(tau + C);
    long long* const out = down + (tau - H + 2);  // the bottom row's column at step tau

    // kInside: every cell of the chunk lies in the matrix (every row has
    // begun and none has passed column n), so none is masked.
    const auto chunk = [&](auto inside) {
      constexpr bool kInside = decltype(inside)::value;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int from_up = __shfl_sync(kFull, above_d, u);
        const int from_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
        const int x1 = lane == 0 ? from_up : from_lane;
        int y1 = 0;
        if constexpr (kAffine) {
          const int j_up = __shfl_sync(kFull, above_j, u);
          const int j_lane = __shfl_up_sync(kFull, J[R - 1], 1);
          y1 = lane == 0 ? j_up : j_lane;
        }
        const int tl = tau + u - base;  // step minus the lane's first row offset
#pragma unroll
        for (int q = R - 1; q >= 0; --q) {
          const int left = D1[q];
          const int upper = q > 0 ? D1[q - 1] : x1;
          const int diag = q > 0 ? D2[q - 1] : x2;
          int sub;
          if constexpr (kClass)
            sub = cost[bc[q] + (q / 4) * 128 + (q % 4)];
          else
            sub = ac[q] == bc[q] ? c.match : c.mismatch;
          int v, i_new = 0, j_new = 0;
          if constexpr (kAffine) {
            const int up_j = q > 0 ? J[q - 1] : y1;
            i_new = add_opt<kMax, false>(left, c.gap, I[q] + c.extend);
            j_new = add_opt<kMax, false>(upper, c.gap, up_j + c.extend);
            v = add_opt<kMax, kLocal>(diag, sub, opt<kMax>(i_new, j_new));
          } else {
            v = add_opt<kMax, kLocal>(opt<kMax>(left, upper), c.gap, diag + sub);
          }
          if (!kInside) {  // a row before column 1 or past column n keeps its value
            const bool live = q < rq && static_cast<unsigned>(tl - q) < static_cast<unsigned>(n);
            v = live ? v : left;
            if constexpr (kAffine) {
              i_new = live ? i_new : I[q];
              j_new = live ? j_new : J[q];
            }
          }
          if (kLocal) best = opt<kMax>(best, v);
          D2[q] = left;
          D1[q] = v;
          if constexpr (kAffine) {
            I[q] = i_new;
            J[q] = j_new;
          }
        }
        x2 = x1;
        const int b_up = __shfl_sync(kFull, b_in, u);
        const int b_lane = __shfl_up_sync(kFull, bc[R - 1], 1);
#pragma unroll
        for (int q = R - 1; q > 0; --q) bc[q] = bc[q - 1];
        bc[0] = lane == 0 ? b_up : b_lane + (kClass ? 4 : 0);
        // the bottom row's cell of this step, column tau + u - H + 2
        const bool on =
            sends && (kInside || static_cast<unsigned>(tl - (R - 1)) < static_cast<unsigned>(n));
        ring_store(out + u, flat_slot(tag_out, D1[R - 1]), on);
        if constexpr (kAffine) ring_store(out + n + 1 + u, flat_slot(tag_out, J[R - 1]), on);
      }
    };
    if (rows == H && tau >= H - 1 && tau + C <= n)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});
  }

  if (kLocal) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) best = opt<kMax>(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) {
      if (kMax) atomicMax(args.out + pair, best);
      else atomicMin(args.out + pair, best);
    }
  } else if (last && lane == (m - r0) / R) {  // cell (m, n), kept since column n
    const int row = (m - r0) % R;
    int d = D1[0];
#pragma unroll
    for (int q = 1; q < R; ++q) d = q == row ? D1[q] : d;
    args.out[pair] = d;
  }
  return true;
}

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__global__ void __launch_bounds__(kFlatWarps * 32) wavefront_flat(FlatArgs args) {
  extern __shared__ __align__(16) unsigned char flat_shared[];  // the warps' profiles (classes)
  const int warp_base = kClass ? (threadIdx.x >> 5) * kFlatProfileBytes : 0;
  for (;;) {
    int k = 0;
    if ((threadIdx.x & 31) == 0) k = atomicAdd(args.header + 1, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= args.n_claims) return;
    const int2 strip = args.claims[k];
    if (!flat_strip<kMax, kLocal, kAffine, kClass>(args, strip.x, strip.y, flat_shared,
                                                    warp_base))
      return;
  }
}

#define SZ_FLAT(k)           \
  reinterpret_cast<const void*>( \
      wavefront_flat<((k) & 8) != 0, ((k) & 4) != 0, ((k) & 2) != 0, ((k) & 1) != 0>)

// The flat kernel of `config` (max * 8 + local * 4 + affine * 2 + classes),
// or null.
const void* flat_kernel(int config) {
  static const void* const kernels[16] = {
      SZ_FLAT(0),  SZ_FLAT(1),  SZ_FLAT(2),  SZ_FLAT(3),  SZ_FLAT(4),  SZ_FLAT(5),
      SZ_FLAT(6),  SZ_FLAT(7),  SZ_FLAT(8),  SZ_FLAT(9),  SZ_FLAT(10), SZ_FLAT(11),
      SZ_FLAT(12), SZ_FLAT(13), SZ_FLAT(14), SZ_FLAT(15)};
  return config >= 0 && config < 16 ? kernels[config] : nullptr;
}
#undef SZ_FLAT

size_t flat_shared_bytes(int config) {
  return (config & 1) ? static_cast<size_t>(kFlatWarps) * kFlatProfileBytes : 0;
}

}  // namespace

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

// CTAs (of 4 warps) of the flat kernel of `config` (max * 8 + local * 4 +
// affine * 2 + classes) that an SM holds at once.
extern "C" cudaError_t sz_wavefront_flat_occupancy(int config, int* ctas_per_sm) {
  const void* fn = flat_kernel(config);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kFlatWarps * 32,
                                                       flat_shared_bytes(config));
}

// Flat-tier scores of the pairs of n_groups groups, one launch a group,
// each added to *launches.
//   config   max * 8 + local * 4 + affine * 2 + classes (a strip is a warp
//            of 32 kFlatRows rows);
//   chars    int32 chars (class ids when classes) of every pair;
//   pairs    [n_pairs][6] int64 on the device: a_off, m, b_off, n (m, n >= 1;
//            a's m chars are the rows), the offset in int64 words of the
//            pair's slots within its group's part of `handoff` (2 (n + 1)
//            words, twice when affine; only pairs of 2+ strips have slots),
//            and 1 when a is the pair's second string (its class costs are
//            then table[b class][a class]), else 0;
//   claims   [n_claims][2] int32 on the device: each group's strips in the
//            order its warps claim them, (pair within the group, strip),
//            strip s - 1 of a pair before strip s;
//   table    [32][32] int32 class costs (read only with classes);
//   groups   [n_groups][6] int64 on the host, from ops/wavefront.py
//            flat_plan: first pair, pairs, first claim, claims, CTAs, slot
//            words;
//   handoff  8 bytes a group (its status and claim counter), then the
//            largest group's slot words, zeroed here (the status after the
//            last launch says 3 where a wait stalled: the host raises);
//   out      [n_pairs] int32: must hold 0 for local scores; global ones are
//            written.
// Launches on `stream` without synchronising; returns the first failing
// status.
extern "C" cudaError_t sz_wavefront_flat(int config, int gap, int extend,
                                         int match, int mismatch, const int32_t* chars,
                                         const long long* pairs, const int32_t* claims,
                                         const int32_t* table, const long long* groups,
                                         int n_groups, void* handoff, long long handoff_bytes,
                                         int32_t* out, long long* launches, cudaStream_t stream) {
  const void* fn = flat_kernel(config);
  if (fn == nullptr || n_groups < 0 || ((config & 1) && table == nullptr))
    return cudaErrorInvalidValue;
  if (n_groups == 0) return cudaSuccess;
  const long long header = 8LL * n_groups;
  if (handoff_bytes < header) return cudaErrorInvalidValue;
  const size_t shared = flat_shared_bytes(config);
  char* base = static_cast<char*>(handoff);
  cudaError_t err = cudaMemsetAsync(base, 0, static_cast<size_t>(header), stream);
  if (err != cudaSuccess) return err;
  for (int g = 0; g < n_groups; ++g) {
    const long long* grp = groups + static_cast<long long>(kFlatGroup) * g;
    const long long first_pair = grp[0], first_claim = grp[2], n_claims = grp[3];
    const long long ctas = grp[4], slot_words = grp[5];
    if (first_pair < 0 || grp[1] < 1 || first_claim < 0 || n_claims < 1 || n_claims > INT_MAX ||
        ctas < 1 || ctas > INT_MAX || slot_words < 0 || header + 8 * slot_words > handoff_bytes)
      return cudaErrorInvalidValue;
    long long* slots = reinterpret_cast<long long*>(base + header);
    if (slot_words > 0) {
      err = cudaMemsetAsync(slots, 0, static_cast<size_t>(8 * slot_words), stream);
      if (err != cudaSuccess) return err;
    }
    FlatArgs args{chars,
                  pairs + first_pair * kFlatRecord,
                  reinterpret_cast<const int2*>(claims) + first_claim,
                  table,
                  slots,
                  reinterpret_cast<int*>(base) + 2 * g,
                  out + first_pair,
                  Costs{gap, extend, match, mismatch},
                  static_cast<int>(n_claims)};
    void* params[] = {&args};
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(ctas)), dim3(kFlatWarps * 32), params,
                           shared, stream);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}
