/*  tapecraft — stable C ABI of stringzilla_tpu_torch's native host runtime
 *  (a copy of the JAX package's stringzilla_tpu/native/tapecraft.h).
 *
 *  This is the framework's language-binding seam (the analog of the
 *  reference's libstringzilla C99 ABI, stringzillas.h:104-597): everything
 *  here is plain C — fixed-width integers, caller-owned buffers, no
 *  allocation across the boundary, no exceptions — so any FFI (ctypes,
 *  cffi, cgo, P/Invoke, JNA/FFM, N-API) can consume the shared library
 *  directly.  The Python package builds `libtapecraft-<hash>.so` from
 *  tapecraft.cpp on first use (see utils/native.py); foreign bindings can
 *  compile the same single file with any C++17 compiler:
 *
 *      g++ -O3 -march=native -shared -fPIC -std=c++17 tapecraft.cpp -o libtapecraft.so
 *
 *  Scope: the HOST side of the framework — ragged→dense tape packing,
 *  tokenization, sort-key export, UTF-8 decode/encode, Unicode case
 *  folding and case-insensitive search.  The batch/device side (edit
 *  distances, fingerprints, exact search, hashing on the GPU) is reached
 *  through the Python engine API, which is the stable surface for
 *  device work.
 *
 *  Conventions
 *  -----------
 *  - All sizes/offsets are int64_t byte counts unless noted.
 *  - "tape" inputs are (data, offsets[count+1]) — one contiguous blob plus
 *    exclusive prefix offsets, the Arrow-style layout of the reference's
 *    sz_sequence_u64tape_t (stringzillas.h:61-76).
 *  - Two-call sizing: functions returning a count can be called with a
 *    NULL output buffer (or capacity 0) first to learn the required size.
 *  - Unicode tables (fold1/mkeys/moffs/mvals) are the generated UCD arrays
 *    produced by stringzilla_tpu_torch.ops.ucd (fold1: u32[0x110000] 1:1 folds
 *    with 0xFFFFFFFF marking multi-rune expansions; mkeys/moffs/mvals the
 *    expansion table).  Bindings can dump them once with numpy .tofile().
 */

#ifndef TAPECRAFT_H
#define TAPECRAFT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ABI version of this header/library pair; bump on breaking change. */
int tc_version(void);

/* ---- tape packing (ragged → dense device-feed matrices) ---- */

/* Pack `count` strings (tape, optionally re-ordered by `indices`) into a
 * zero-filled (rows, row_len) u8 matrix, or its transpose when
 * `transpose` != 0.  Rows beyond `count` stay zero. */
void tc_pack_u8(const uint8_t* data, const int64_t* offsets,
                const int64_t* indices, int64_t count, uint8_t* out,
                int64_t rows, int64_t row_len, int transpose);

/* Same, into int32 cells with `fill` padding; writes per-row byte lengths
 * to `lengths[rows]`. */
void tc_pack_i32(const uint8_t* data, const int64_t* offsets,
                 const int64_t* indices, int64_t count, int32_t* out,
                 int64_t rows, int64_t row_len, int transpose, int32_t fill,
                 int32_t* lengths);

/* As tc_pack_i32 but the tape holds u32 runes (UTF-8 already decoded). */
void tc_pack_runes_i32(const int32_t* data, const int64_t* offsets,
                       const int64_t* indices, int64_t count, int32_t* out,
                       int64_t rows, int64_t row_len, int transpose,
                       int32_t fill, int32_t* lengths);

/* ---- tokenization ---- */

/* Whitespace tokens / line splits: writes up to `cap` (start, end) byte
 * pairs into `bounds` (2 int64 per token); returns the total token count
 * (call with bounds=NULL, cap=0 to size). */
int64_t tc_tokenize_ws(const uint8_t* data, int64_t n, int64_t* bounds,
                       int64_t cap);
int64_t tc_split_lines(const uint8_t* data, int64_t n, int64_t* bounds,
                       int64_t cap);

/* ---- sort keys ---- */

/* Big-endian u32 pgram sort keys + length tiebreak, shape
 * (count, words_per_str + 1) u32 — the argsort key export
 * (reference sort.h:9-16). `uncased`/`reverse` fold or invert bytes. */
void tc_pgram_keys(const uint8_t* data, const int64_t* starts,
                   const int64_t* ends, int64_t count, uint32_t* out,
                   int words_per_str, int uncased, int reverse);

/* Uncased sort keys with FULL Unicode case folding during export
 * (progressive fold-on-export, reference sort.h:18-22): key bytes come from
 * the folded string (3x expansion bound — size words_per_str accordingly);
 * malformed UTF-8 orders as U+FFFD (EF BF BD).  Fold tables as above. */
void tc_pgram_keys_unicode(const uint8_t* data, const int64_t* starts,
                           const int64_t* ends, int64_t count, uint32_t* out,
                           int64_t words_per_str, int reverse,
                           const uint32_t* fold1, const uint32_t* mkeys,
                           const int64_t* moffs, const uint32_t* mvals,
                           int64_t mcount);

/* Stable argsort of a dense (n, w) u32 key matrix, column 0 most
 * significant (the layout tc_pgram_keys emits): MSD counting pass on the
 * top 16 bits + per-bucket introsort over the full rows.  Writes the
 * permutation to order[n]. */
void tc_argsort_keys(const uint32_t* keys, int64_t n, int32_t w,
                     int64_t* order);

/* ---- UAX-29 word / grapheme segmentation ----
 *
 * Streaming automata over caller-supplied class tables (u8[0x110000] in
 * ucd.WB_VALUES / ucd.GCB_VALUES order; `ep` = Extended_Pictographic
 * membership).  Return the boundary count; when `out` is non-NULL, up to
 * `cap` byte offsets are written (boundaries exclude 0 and n). */

int64_t tc_wb_breaks(const uint8_t* data, int64_t n, const uint8_t* wb,
                     const uint8_t* ep, int64_t* out, int64_t cap);
int64_t tc_gb_breaks(const uint8_t* data, int64_t n, const uint8_t* gcb,
                     const uint8_t* ep, int64_t* out, int64_t cap);

/* 32-bit-offset export variants (n < 2^31): identical semantics, half the
 * output bandwidth — the dominant cost when materializing one boundary per
 * byte (plain-ASCII graphemes). */
int64_t tc_wb_breaks32(const uint8_t* data, int64_t n, const uint8_t* wb,
                       const uint8_t* ep, int32_t* out, int64_t cap);
int64_t tc_gb_breaks32(const uint8_t* data, int64_t n, const uint8_t* gcb,
                       const uint8_t* ep, int32_t* out, int64_t cap);

/* ---- checksums & hashing ---- */

uint64_t tc_bytesum(const uint8_t* data, int64_t n);

/* 64-bit seeded AES-mixing hash, bit-identical to the reference's sz_hash
 * contract (hash.h:139; golden-vector-tested).  AES-NI when compiled in,
 * scalar FIPS-197 rounds otherwise — same bits either way. */
uint64_t tc_hash(const uint8_t* data, int64_t n, uint64_t seed);

/* One hash per tape entry: out[count] u64. */
void tc_hash_batch(const uint8_t* data, const int64_t* offsets, int64_t count,
                   uint64_t seed, uint64_t* out);

/* One hash per (start, end) span of a shared buffer (spans may overlap). */
void tc_hash_bounds(const uint8_t* data, const int64_t* starts,
                    const int64_t* ends, int64_t count, uint64_t seed,
                    uint64_t* out);

/* AES-CTR pseudo-random fill, reproducible per nonce across backends
 * (sz_fill_random, hash/serial.h:953-968). */
void tc_fill_random(uint8_t* out, int64_t n, uint64_t nonce);

/* FIPS 180-4 SHA-256.  `state` for the streaming compressor is 8 u32 words
 * (init to the H0 of §5.3.3), updated in place over `nblocks` 64-byte
 * blocks; one-shot/batch do padding + length scheduling internally. */
void tc_sha256_compress(uint32_t* state, const uint8_t* block,
                        int64_t nblocks);
void tc_sha256(const uint8_t* data, int64_t n, uint8_t* out32);
void tc_sha256_batch(const uint8_t* data, const int64_t* offsets,
                     int64_t count, uint8_t* out);

/* ---- UTF-8 ---- */

/* Decode to u32 runes with U+FFFD per maximal subpart (Python
 * errors="replace" semantics); fills runes[n] and offsets[n+1] (byte
 * offset of each rune + end); returns the rune count. */
int64_t tc_utf8_decode(const uint8_t* data, int64_t n, uint32_t* runes,
                       int32_t* offsets);

/* Encode scalar runes to UTF-8; `out` needs 4*count bytes; returns the
 * byte length written. */
int64_t tc_utf8_encode(const uint32_t* runes, int64_t count, uint8_t* out);

/* Full case folding over a rune array (out needs 3*count+4 slots);
 * `src` (optional, same capacity) receives each folded rune's source
 * index; returns the folded count. */
int64_t tc_fold_runes(const uint32_t* runes, int64_t count,
                      const uint32_t* fold1, const uint32_t* mkeys,
                      const int64_t* moffs, const uint32_t* mvals,
                      int64_t mcount, uint32_t* out, int64_t* src);

/* Fused decode→fold→encode of a UTF-8 buffer (ASCII fast path); `out`
 * needs 3*n+16 bytes; returns the byte length written. */
int64_t tc_utf8_fold_bytes(const uint8_t* data, int64_t n,
                           const uint32_t* fold1, const uint32_t* mkeys,
                           const int64_t* moffs, const uint32_t* mvals,
                           int64_t mcount, uint8_t* out);

/* Case-insensitive substring search, folding on the fly (no folded
 * haystack materialization).  `nd`/`k`: the FOLDED needle runes;
 * `start_rune`: minimum folded-rune index a match may start at.  On hit
 * returns 1 and sets *out_off/*out_len (byte span in the original
 * buffer); else returns 0. */
int tc_utf8_uncased_find(const uint8_t* data, int64_t n, const uint32_t* nd,
                         int64_t k, int64_t start_rune, const uint32_t* fold1,
                         const uint32_t* mkeys, const int64_t* moffs,
                         const uint32_t* mvals, int64_t mcount,
                         int64_t* out_off, int64_t* out_len);

/* ---- Unicode segmentation ---- */

/* UAX-29 sentence breaks (SB1-SB11): writes up to `cap` byte offsets where
 * a new sentence starts (offset 0 excluded); returns the total count.  The
 * class table `sb` is u8[0x110000] of Sentence_Break ids in the order of
 * stringzilla_tpu_torch.ops.ucd.SB_VALUES (dump once with numpy .tofile()). */
int64_t tc_sb_breaks(const uint8_t* data, int64_t n, const uint8_t* sb,
                     int64_t* out, int64_t cap);
int64_t tc_sb_breaks32(const uint8_t* data, int64_t n, const uint8_t* sb,
                       int32_t* out, int64_t cap);

/* UAX-14 line-break opportunities (LB2-LB31 core cascade): writes up to
 * `cap` byte offsets and 0/1 mandatory flags; returns the total count.
 * `lb` is u8[0x110000] of Line_Break ids in ucd.LB_VALUES order. */
int64_t tc_lb_breaks(const uint8_t* data, int64_t n, const uint8_t* lb,
                     int64_t* out, uint8_t* mand, int64_t cap);
int64_t tc_lb_breaks32(const uint8_t* data, int64_t n, const uint8_t* lb,
                       int32_t* out, uint8_t* mand, int64_t cap);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* TAPECRAFT_H */
