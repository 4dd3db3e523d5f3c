#!/usr/bin/env python
"""Smoke run of stringzilla_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. Build: compiles ``stringzilla_tpu_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/stringzilla_tpu_torch/`` and prints the time and ptxas report.
3. Kernel vs plain version on the card: ``ops.myers.myers`` against
   ``myers_reference`` on the same device tensors, exact int32 equality, at
   both kernel tiers (1-4 words per thread; 5-64 words per warp), word
   boundary lengths, empty strings and out-of-range char values.
3b. The same for this slice's kernels: ``ops.similarity_dp.similarity``,
   each route forced (``similarity_dp``, a thread a pair;
   ``similarity_dp_warp``, a warp a pair), against ``similarity_reference``
   in all 16 configurations (min/max, global/local, linear/affine,
   uniform/class costs) at rows 8, 40, 136, 1032, 2056 and 4104, with
   query lengths 0 and rows - 1, 31-33 around the 32-row strip, 1023-1025
   and 2048/2049 around the warp route's 1,024-row passes, candidate
   lengths 0, 1 and 31-33, class ids >= 32, negative and wrong-sign costs,
   and under scratch caps that split a launch; ``ops.memory.lookup_transform`` against
   ``lut[x.long()]`` at lengths 0, 1, 15, 16, 17 and 2**24 + 3, and on a
   buffer that is not 16-byte aligned. Exact equality.
3c. The same for the long-pair kernels: ``ops.wavefront.wavefront_batch``
   against ``wavefront_reference`` in all 16 configurations, each with
   costs of both signs, on batches of pairs from 1 x 1 to 4097 x 90 (m = 1,
   n = 1, m != n both ways, lengths at 31-33 and 63-65 around the 32 x 64
   tile, class ids 0-39 of which >= 32 clamp), two configurations also with
   pairs of ~20,000 chars, and one batch under a frontier cap that splits
   it into groups (more launches than whole); ``band_batch`` against
   ``band_reference`` (distance, status, last rung, band cells walked) with
   first rungs of 2 and 64 on near-duplicates of 1-20,000 chars, unrelated
   pairs (one over the widest band, one with |m - n| over it, n >> m) and
   pairs of m at 32 R q - 1, 32 R q and 32 R q + 1 (the kernel's strips of
   32 R rows) and a pair equal but for a tail (a ladder of several rungs),
   on the card's plan and on plans cut to 1 and 2 SMs (groups
   taking pairs in turns); then ``levenshtein_batch`` on the same pairs
   against Wagner-Fischer. Exact equality.
4. Main path, unit costs: ``LevenshteinDistances()`` through the default
   scope on the ``bench.py`` workload (128 x 32768 lowercase lines, lengths
   N(100, 12.5) clipped to [8, 128], seed ``STRINGWARS_SEED`` = 42) and on
   long queries (16 x 2048, lengths uniform in 300-4096). Launch counts are
   reset just before these two calls and read just after. Each result must
   equal the plain version on the same packed device inputs and
   Wagner-Fischer on sampled pairs. Then times the engine (host pull
   included), the kernel alone and the plain version, in GCUPS (sum of
   len_q * len_c per second).
4b. Main path, column DP: ``NeedlemanWunschScores`` and
   ``SmithWatermanScores`` on proteins (the shape of
   ``benches/bench_all.py::bench_nw_proteins``: 16 x 512 sequences of
   20 residues mapped to classes 0-19, lengths N(1000, 100) clipped to
   [100, 1024], its symmetric random 32x32 table), with linear gaps -5/-5
   and affine gaps -10/-1, then ``LevenshteinDistances(match=0,
   mismatch=2, open=3, extend=1)`` on 64 x 4096 ``bench.py`` lines. Counts
   are reset before these five calls and read after; both column-DP routes
   (the proteins take the warp route, the lines the thread route) and the
   byte-LUT kernel must have launched. Each result must equal the plain
   version on the same packed device inputs and a numpy Gotoh DP on sampled
   pairs. Then the same timings, and the LUT kernel's at the protein
   candidates' blob size beside one ``lut[x.long()]`` call.

4c. Main path, long pairs: ``LevenshteinDistances()`` on
   ``benches/bench_all.py::bench_wavefront``'s pair (100,000 lowercase
   chars, b = a with 500 positions flipped by ``^= 1``, seed 42), which
   takes the band kernel, then ``NeedlemanWunschScores`` on long reads
   (8 x 8 DNA reads of 5,000-15,000 bases, seed 44, half the candidates
   copies of a query with ~1% substitutions and indels, plus two ~100-base
   reads a side; classes A, C, G, T with +2 on the diagonal and -3
   elsewhere, affine gaps -7/-2), which takes the flat kernel, and between
   them ``LevenshteinDistances()`` on the band batch (8 x 8 copies of one
   20,000-char string with 100 flips each, seed 51: 64 pairs in one band
   launch). Counts are reset before these three calls and read after; the
   band, flat, column-DP
   and byte-LUT kernels must all have launched. Each long pair must equal
   its kernel's plain version on the card; the long pair's distance must be
   500; the band batch's distances must equal the flat kernel's, and its
   first and last pairs the plain version's in all four columns; sampled
   reads must equal ``tests/oracles.py``'s Gotoh DP (the two
   smallest short x long pairs and the short x short ones) and the numpy
   Gotoh DP (a long x long pair). Times three rows: the kernel alone, the
   engine up to its device result and the engine with the host pull, beside
   the plain version; the band's bound counts the band cells the plain
   version walked on the long pair and, on the batch, those of the rung
   that certifies each pair's verified distance (``_certifying_rung_cells``).
   Every DP bound counts a cell's int32 issue slots with each add fused into
   its min or max by DPX (``_dp_ops_per_cell``), the unfused count printed
   beside it. For the band prints its plan and, on the long pair, the
   chain's steps over the rungs and the time a step; the flat kernel is
   timed on the same pairs beside it.

3d. The same for this slice's kernels: ``ops.fingerprints_kernel.
   fingerprint_all`` against ``fingerprint_reference`` with widths 1, 3
   and 31 (interleaved over 100 dimensions), the default widths, a width of
   2000 (above some documents and the kernel's widest halo), widths 64,
   1024 (the widest halo) and 1025 (past it), empty documents,
   documents of 1-5000 bytes and 64 KB ones, then every case of
   ``tests/golden/fingerprint_vectors.json`` and the numpy oracle on
   sampled documents; then the plan's cut: documents at the unit the
   card's plan takes (``UNIT_MIN``) - 1, at it and + 31, a 64 KB
   ``b"ab"`` document cut into 256 and 676 ranges under widths 1 and 2,
   width 2000 on a 64 KB document cut into 16 ranges and widths 64 and
   512 on it cut into 16 and 110 (a halo of 512 bytes), each through
   ``minhash_ranges`` against ``ranges_reference`` (whole documents' rows
   and every partial slot), ``minhash_merge`` against ``merge_reference``
   on the kernel's partials, the merged results of every unit equal, and
   against ``fingerprint_reference`` (the unit-edge documents) and the
   numpy oracle; the rune route of ``ops.myers.myers`` against
   ``myers_reference(..., alphabet=None)`` on query blocks of 1-4096 runes
   (queries of 1, 64, 256, 257 and 4096 runes, blocks of more than 256
   distinct runes, 4-byte runes, U+0000; a tier-A query of 256 distinct
   runes and a tier-B one of 4,096, the kernel's fullest hash tables;
   candidate runes -1, 0, INT32_MIN and INT32_MAX against queries with and
   without U+0000; queries whose runes all share one home slot of the
   table), tier B in both segment widths, and against Wagner-Fischer on
   sampled pairs. Exact equality.
4d. Main path, fingerprints and UTF-8: ``Fingerprints(ndim=256)``
   (default widths, seed 42) on ``benches/bench_all.py::
   bench_fingerprints``'s lines (32,768 docs of 60-179 printable ASCII
   bytes) and on 2,048 web-page-sized docs of 2-16 KB, then
   ``LevenshteinDistancesUTF8()`` on ``bench_levenshtein_utf8``'s mixed
   script (64 x 8,192 strings of N(100, 12) runes clipped to [8, 128],
   ASCII, Cyrillic and CJK) and on a CJK-wide set (64 x 2,048 strings of
   100-400 runes from 3,000 CJK code points, so every query block holds
   more than 256 distinct runes). Counts are reset before these four calls
   and read after; both MinHash kernels (the merge on the documents, which
   the plan cuts) and both rune tiers must have launched. Each result must
   equal the plain version on the card and the numpy oracle or
   Wagner-Fischer over runes on sampled docs or pairs; each MinHash kernel
   is also held against its plain version on the card's plan of each
   workload. Times each MinHash kernel alone (raw launches, parameters and
   plan made once; the merge with L2 flushed before each launch, as its
   bound from HBM assumes, and as on the main path, its partials in L2)
   beside ``fingerprint_all`` (the plan, its upload and both launches), the
   engines (fingerprints to ``device_out``, with the host
   pull, and ``device_out`` plus ``band_keys(bands=16)``) and the
   plain versions. Times each rune tier alone on its set's block (raw
   launches, rune tables built beforehand) beside the ``myers`` wrapper
   (which builds them), the engine's own rune launches one by one, summed
   per tier, and the engine to its device result and with the host pull;
   counts the rune table builds of one engine call (one a query block);
   then one malformed collection through the host decode.

3e. The same for the buffer tier's kernels: ``ops.find_kernel.
   search_positions`` against ``search_positions_reference`` in every mode
   (first, last, count) for needles of 1-16, 17, 130 and 5,000 bytes
   planted at every chunk edge +- k, across the edges and at 0 and n - k,
   with ``[lo, hi]`` windows at a chunk edge, ``lo > hi`` and ``lo < 0``,
   on haystacks that are not 16-byte aligned, all hits, empty and shorter
   than the needle, bytesets holding 0x00 and 0xFF and their inversions,
   and a 64 MiB haystack whose hits in six chunks race for the early exit
   (three runs); ``ops.utf8_device.validate_count_raw`` against
   ``validate_count_reference`` (both numbers) on
   ``tests/test_intersect_utf8.py``'s case list, 300 fuzzed buffers, 12
   MiB of text with violations at the kernel's CTA, group and grid-stride
   edges (from ``ops.utf8_device``'s geometry) and a lead cut off at the
   end, aligned and at offsets 1-15, and ASCII runs with a multi-byte lead
   or a violation in the last 1-3 bytes of every vector, row (a warp's
   span), group and CTA span, aligned and not. Exact equality; the
   kernel's own geometry and mask count (``sz_utf8_geometry``) must be
   the module's.
4e. Main path, the buffer tier: ``Str`` on
   ``benches/bench_all.py::bench_find``'s haystack (2**30 random lowercase
   bytes, seed 42, ``XqZwV`` at N - 4096, a 130-byte needle planted twice):
   find, rfind, ``count(b"ab", allowoverlap=True)``, ``find_first_of``,
   ``find_last_of``, the 130-byte needle both ways and with bounds; then
   ``translate`` with the swapcase table on ``bench_lookup``'s 2**30 random
   bytes; ``utf8_count`` and ``utf8_valid`` on
   ``bench_utf8_count_device``'s 2**28-byte blob and on a 2 MiB invalid
   buffer; ``File`` over a 256 MiB log file written under ``build/``
   (find, count, utf8_count, rfind). Counts are reset before each of the
   four paths and read after; ``find_search``, ``byte_lut`` and
   ``utf8_validate_count`` must have launched. Each result must equal
   Python's ``bytes`` methods or numpy on the same buffer. Then, on the
   same 1 GiB mirror, ``search_positions`` must equal
   ``search_positions_reference`` in every mode for both needles, the
   130-byte one with and without bounds, and three bytesets (one
   inverted); on the 256 MiB and the invalid 2 MiB mirrors,
   ``validate_count_raw`` must equal ``validate_count_reference``. Times the
   kernel alone, the ``Str`` call with the mirror cached, the first call
   with the mirror's copy to the card, and the plain versions; the UTF-8
   kernel by raw launch on the blob, a 256 MiB valid mixed-script buffer
   of an assumed rune mix (``utf8_mixed``, exact against the plain version
   too) and the log, each beside its bytes bound.

3f. The same for the hash kernels (``csrc/hash.cu``): ``ops.hash_kernel.
   hash_short`` against ``hash_short_reference`` on every length 0-64 at
   odd offsets in blobs 0 and 1 byte past a 16-byte boundary, with seeds
   0, 42, 2**63 + 9 and 2**64 - 1 (where seed + length carries into the
   high word), and on 2**19 + 777 tokens (grid-stride loops); ``hash_long``
   against ``hash_long_reference`` on every length 65-300, 64k - 1, 64k and
   64k + 1 for k up to 16 and ``benches/tpu_sweep.py``'s 8 and 16 KiB
   buckets, at the same seeds (strings under ``WIDE_BYTES`` go to
   ``hash_long``, a quad a string, the others to ``hash_long_wide``, a warp
   a string), on ``hash_long_wide``'s ring edges (mP - 1..mP + 1 full
   chunks, P = 32) and the quad's last lengths at odd offsets and in blobs
   that end at the string's last byte, and on one 3 MiB string against the
   host ``sz_hash``; ``ops.aes_kernel.fill_random_device`` against
   ``fill_random_reference`` and the host ``fill_random`` at lengths 1,
   15, 16, 17, 5000, 40000 and 2**24 with nonces 0, 123456789, 2**63 + 9
   and 2**64 - 3 (the counter wraps); then every vector of
   ``tests/golden/hash_vectors.json`` through ``hash_batch_device`` and
   ``fill_random_device``. Sampled strings of each case also against the
   host ``sz_hash``. Exact equality.
4f. Main path, hashing and set operations: ``intersect`` on
   ``benches/bench_all.py::bench_hash_tokens``'s shape (2**20 tokens of
   4-12 lowercase bytes a side, seed 42, half of the second drawn from the
   first and shuffled), ``Strs.hashes`` on phase 4e's 256 MiB log ``File``
   split into lines (every line but the last over 64 bytes) and on the
   words of its first 64 MiB, ``hash_batch_device`` on ``bench_crypto_e2e``'s
   1,000 x 100 KB random documents plus one 3 MiB string,
   ``fill_random_device(2**28, 42)``, ``sha256_batch`` on ``bench_sha256``'s
   2**16 tokens of 4-47 bytes and ``tpu_sweep``'s 61 messages, and
   ``Strs.sort`` and ``argsort_strings(..., prefer_device=True)`` on 2**20
   of the words, all with no ``device=``. Counts are reset before each of
   the five kernel paths and read after; ``hash_short``, ``hash_long``
   (the lines), ``hash_long_wide`` (the documents) and ``fill_random``
   must have launched. ``intersect`` must equal Python's
   sets (first occurrences), ``Strs.hashes`` the plain versions on the
   card over the whole collection and the host ``hash_batch`` on 10,000
   sampled strings (a second call must reuse the mirror), documents the
   host ``sz_hash`` on samples, ``fill_random`` its plain version on the
   card, ``sha256_batch`` ``hashlib`` and the sorts Python's ``sorted``.
   Times each kernel alone, the calls with their host parts (``intersect``
   split into ``_distinct``, hashing, device sort and match, and the exact
   check), the plain versions, ``sha256_batch`` and ``torch.sort``.

3g. The same for the meet-in-the-middle stage kernel
   (``csrc/wavefront_stage.cu``): ``ops.wavefront.stage_batch`` against
   ``stage_reference`` from the same state at every stage of 4-stage
   ladders, a call's two sweeps sharing each launch, on the CPU tests'
   shapes (4-1,100 chars, m < n, m > n, m = n, among them the three where
   the JAX ``wavefront_score_mim`` raises) under costs (0, 1, 1), (0, 3, 2)
   and (-1, 1, 1), on sweeps to d_end 2 and 3 (a first stage of zero steps)
   and on two pairs of 4,001 x 7,919 chars both ways; then whole ladders of
   1-8 stages against the plain sweep, and ``wavefront_score_mim`` on the
   card against the flat kernel. Then single stages from random diagonals
   over every row (d0 = m of an m x (m + 7) matrix) where m + 1 sits at an
   edge of the card's strip plan: a strip's, a CTA's, where the plan
   widens its strips (the rows one CTA an SM holds), and where it goes into
   a second wave (and the most rows two waves hold), each over 40 steps;
   stages that run in up to five waves on a plan cut to one or two SMs
   (one and two sweeps, one with m > n, 300 steps); each kernel (each R,
   with its chunk) on two sweeps of 12 and 1-2 strips, on the fewest SMs
   whose plan takes that R; a 100,000-row sweep's first stage, where every
   row past d1 is dead; the last diagonal of a matrix;
   and costs (0, 60,000, 10,200) on 220,000 rows from d0 = 210,000, whose
   edges leave no int32 room to be made by the recurrence. Exact equality.
4g. Main path, meet in the middle: ``wavefront_score_mim`` with no
   ``device=`` on DNA of 180,000 bases (seed 50) against a copy with 0.5%
   substitutions, insertions and deletions cut to 180,000 and to 150,000
   bases (m > n), each under unit costs and (0, 3, 2). Counts are reset
   before these four calls and read after; ``wavefront_stage`` must have
   launched. The 180,000 x 180,000 unit-cost score must equal
   ``levenshtein_long_pair`` (the band kernel, distance under 2,047), the
   other three ``wavefront_score`` (the flat kernel); the kernel's four
   frontiers of the first pair must equal the plain version's on the card.
   Times the call, the stage kernel's launches of one call, the flat
   kernel on the same pair and the plain version; times the ladder also
   as PR 8 timed it (``stage_batch``, the host waiting on each stage);
   prints the µs a step, each stage's plan (rows a lane, chunk) and its
   pipeline fill (the kernel's own record of how long after a sweep's
   first strip its last began its steps), the fill's share of the kernel
   time, and the 4 stages on plans cut to 66 and 33 SMs (wider strips).

4h. Main path, the host UTF-8 layer and uncased search: the native host
   runtime (``native/tapecraft.cpp``) must build with ``g++`` (its time
   printed) and the UCD tables' text group (case folding, normalization)
   must build, without ``regex`` (which groups are present is printed);
   then ``Str.utf8_uncased_find`` on "ASCII text 256 MiB" (``uncased_text``:
   phase 4e's log lines with ASCII paths and ``UNCASED_WORDS``, 48 words of
   one non-ASCII run each, spread evenly) for four needles: one absent (a
   scan through all 48 runs), one near the end, ``strasse`` (found only by
   a patch, in ``STRAßE``) and one of 24 bytes; then on phase 4e's 256 MiB
   log, whose runs are dense, so the device tier gives up after 64 rounds.
   Counts are reset before each call and read after: ``byte_lut`` must
   launch once for a ``Str`` (its folded mirror, then cached) and
   ``find_search`` once for the needle and once a round. Each result must
   equal the native whole-buffer scan; the device tier itself must return
   a result (not None) on the text and None on the log; the folded mirror
   must equal ``lookup_reference`` and the tier's searches
   ``search_positions_reference``. Then ``utf8_fold`` and
   ``utf8_norm("NFC")`` on the log's first 16 MiB must agree between the
   native and the numpy tiers (the library hidden), and ``utf8_words`` and
   ``utf8_graphemes`` between the native automata and the vectorized tier
   where the segment tables exist; where they do not (no ``regex``), their
   ``unicodedata`` tier on the first 1 MiB must agree with itself run line
   by line. Last, an Arrow capsule round trip of 100,000 of the log's lines.
   Times the first call (mirror, fold and search), the cached calls, the
   ``byte_lut`` and ``find_search`` launches alone and the native scan,
   each beside the card's name and power limit.

Phases 4-4g also profile one engine call of each workload with
``torch.profiler`` and print the device's idle share of it; a trace whose
device time is under half the kernel's time by events is reported as
lost, with the device events it holds, and profiled again in a fresh
session. Every phase prints its time.
Kernel times are the median of five batches of CUDA-event timings (three
in phase 4g), with the fastest and slowest batch beside it; kernels under
~0.1 ms (``byte_lut``, ``hash_short``, ``fill_random``) are timed through
their raw ctypes launch, arguments built beforehand, without their
wrappers' host work.

Prints the card's name and power limit and one JSON line of per-kernel
results (time and its spread over the batches, plain time, launches on the
main path, bound by the card's peak rates, PyTorch library time where one
call computes the same), then, last, the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import collections
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = int(os.environ.get("STRINGWARS_SEED", "42"))

# Workload sizes (queries, candidates) of the main-path phases.
HEADLINE = (128, 32768)
LONG = (16, 2048)
PROTEINS = (16, 512)
LINES = (64, 4096)
LONG_PAIR = 100_000  # bench_wavefront's pair
READS = (8, 8)  # long reads, lengths uniform in READ_LENGTHS
READ_LENGTHS = (5000, 15001)
# Phases 3 and 3d: a tier-B block of queries of 5, 8, 9, 16, 17, 32, 33 and
# 64 words (64 w chars, or 64 (w - 1) + 1)
MIXED_WORD_QUERIES = [320, 512, 513, 1024, 1025, 2048, 2049, 4096, 300, 1000]
# Pairs of ~20,000 chars in phase 3c, m != n both ways
WAVEFRONT_BIG = [(20000, 19000), (15000, 20011)]
# Phase 3c, flat kernel: pairs at its strip and lane edges (rows 32 R - 1 ..
# 32 R + 1 at R = 4, the lanes' 31-33 and 63-65 rows, both ways round, as
# the shorter string gives the rows); a batch of more strips than the card
# can hold at once (13,200 strips: 64 warps on each of 132 SMs hold 8,448);
# a cap on the hand-off slots that splits phase 3c's batch into groups (its
# largest, the 2500 x 1200 pair, takes 80,032 bytes of slots when affine).
FLAT_EDGES = [(m, n) for m in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 257)
              for n in (1, 2, 100)]
FLAT_WIDE_EDGES = [(255, 300), (256, 2), (257, 260), (511, 1), (512, 600), (600, 513), (40, 300)]
FLAT_MANY = ((300, 400), 4400)
FLAT_CAP_BYTES = 100_000
# Band pairs of phase 3c: near-duplicates (length, edit rate) and unrelated
# pairs (m, n), of which 5000 x 4800 is over the widest band, 3000 x 10
# has |m - n| over it, 200 x 1150 has n >> m and 1056 x 2000 takes the
# widest band where every strip starts at column 0; 6000 chars at a
# quarter edits a char certify on the widest band
BAND_NEAR = [(1, 0.0), (2, 0.5), (100, 0.03), (4097, 0.01), (20000, 0.003), (19000, 0.015),
             (6000, 0.25)]
BAND_FAR = [(1, 1), (1, 40), (300, 250), (5000, 4800), (3000, 10), (200, 1150), (1056, 2000)]
# A band pair of phase 3c that climbs a long ladder: (length, a tail of
# random chars in b), equal before the tail, so each rung stops late and
# prices the next one low
BAND_TAIL = (2000, 200)
# The cut band plans of phase 3c: (SMs, warps an SM)
BAND_SMALL_CARD = [(1, 64), (2, 64)]
# Phase 4c's band batch: queries, candidates, chars, flips a copy; its seed
BAND_BATCH = (8, 8, 20_000, 100)
BAND_BATCH_SEED = 51
FP_LINES = 32768  # bench_fingerprints' docs of 60-179 printable bytes
FP_DOCS = (2048, 2048, 16385)  # web-page dedup: count, lengths in [lo, hi)
FP_BIG = 3  # phase 3d's 64 KB docs
UTF8_MIXED = (64, 8192)  # bench_levenshtein_utf8's shape
UTF8_CJK = (64, 2048)  # 100-400 runes from 3,000 CJK code points
# Phase 3e: the search kernel's haystack (four of its chunks and a ragged
# end), the needle lengths, a bigger haystack whose hits in many chunks race
# for the early exit, and the UTF-8 pass's buffer with violations at its
# CTA and grid-stride edges
FIND_CHECK = 4 * 65536 + 777
FIND_KS = tuple(range(1, 17)) + (17, 130, 5000)
FIND_RACE = 64 << 20
UTF8_CHECK = 12 << 20  # over the UTF-8 kernel's grid stride (8.65 MB on 132 SMs)
# Phase 4e: benches/bench_all.py's bench_find and bench_lookup buffers,
# bench_utf8_count_device's blob, a mixed-script buffer of the same size,
# and a log file
FIND_BYTES = 1 << 30
LOOKUP_BYTES = 1 << 30
UTF8_BYTES = 1 << 28
FILE_BYTES = 1 << 28
# The mixed-script buffer's runes (first code point, last, weight): ASCII;
# Latin-1 and Cyrillic; CJK ideographs, kana and punctuation, Hangul (ED
# leads among them), Devanagari (E0 leads); emoji and CJK extension B (F0).
# An assumed mix, from no measured corpus: it holds every lead class, and
# its 3% of 4-byte runes put one in nearly every 512-byte row, so nearly
# every row takes the kernel's >= F0 step (text with few 4-byte runes,
# such as most CJK or Cyrillic prose, takes the cheaper step instead).
UTF8_MIX = [(0x20, 0x7E, 15), (0xC0, 0xFF, 3), (0x400, 0x4FF, 7), (0x4E00, 0x9FFF, 52),
            (0x3000, 0x30FF, 8), (0xAC00, 0xD7A3, 8), (0x900, 0x97F, 4), (0x1F300, 0x1F64F, 2),
            (0x20000, 0x2A6DF, 1)]
UTF8_MIX_PIECE = 16 << 20  # drawn once, repeated
# Phase 4h: "ASCII text 256 MiB", the log's lines with ASCII paths and 48
# words of one non-ASCII run each put into the paths, evenly spread; its
# needles; the log's first HOST_BYTES for the host layer and SEGMENT_BYTES
# for the segmenters' unicodedata tier; the Arrow round trip's lines
ASCII_PATHS = (b"users", b"orders", b"items", b"search")
UNCASED_WORDS = ["STRAßE", "École", "\u212Aelvin", "naïve", "GRÖßE", "ﬁle", "café", "señor",
                 "Øresund", "ΣΊΣΥΦΟΣ", "façade", "Привет"] * 4
UNCASED_NEEDLES = {"absent": b"Worker-99 Request", "near the end": b"OUT OF MEMORY",
                   "strasse": b"strasse"}  # and "24 bytes" from a line at 3/4 of the text
LOG_NEEDLE = b"fatal WORKER-9"
HOST_BYTES = 16 << 20
SEGMENT_BYTES = 1 << 20
ARROW_LINES = 100_000
# Phase 4f: bench_hash_tokens' 2^20 tokens a side, the log file's first
# 64 MiB split on spaces, bench_crypto_e2e's documents, bench_fill_random's
# buffer, bench_sha256's tokens and BENCH_NOTES.md's "argsort ~1M words".
INTERSECT_TOKENS = 1 << 20
HASH_SAMPLE = 10_000  # strings checked against the host hash
WORDS_BYTES = 64 << 20
DOCS = (1000, 100_000)
DOC_BIG = 3 << 20
FILL_BYTES = 1 << 28
SHA_TOKENS = 1 << 16
SORT_WORDS = 1 << 20
# Phase 3g: the CPU tests' shapes (m < n, m > n, m = n, and the three where
# the JAX wavefront_score_mim raises) under three cost sets, sweeps to a
# small d_end (a first stage of zero steps), two pairs of 4,000-8,000 chars.
STAGE_SHAPES = [(4, 9), (9, 4), (50, 50), (300, 280), (280, 300), (700, 700), (1100, 900),
                (1024, 1000), (1025, 900)]
STAGE_DEND = [(30, 20, 2), (20, 30, 3), (5, 5, 2)]
STAGE_BIG = [(7919, 4001), (4001, 7919)]
STAGE_COSTS = [(0, 1, 1), (0, 3, 2), (-1, 1, 1)]
# Phase 3g: steps of the stages at the plan's edges, of the many-wave
# stages on a plan cut to SMALL_CARD (SMs, warps an SM; CTAs of 4 warps),
# and the rows of the sweep whose first stage leaves most rows dead.
STAGE_EDGE_STEPS = 40
STAGE_WAVE_STEPS = 300
SMALL_CARD = [(1, 4), (2, 4)]
STAGE_DEAD_ROWS = 100_000
# (m = n, d0) and (match, mismatch, gap) of a 200-step stage whose edge
# gap * d leaves no int32 room for setting edges by the recurrence
STAGE_NO_ROOM = (220_000, 210_000)
STAGE_NO_ROOM_COSTS = (0, 60_000, 10_200)
# Phase 4g: the SMs of the plans that probe the choice of R (fewer SMs take
# wider strips).
STAGE_PROBE_SMS = (66, 33)
# Phase 4g: DNA of MIM_CHARS against a copy with MIM_RATE edits, cut to
# MIM_CHARS and to MIM_SHORT chars.
MIM_CHARS = 180_000
MIM_SHORT = 150_000
MIM_RATE = 0.005

# The card's peak rates for the bounds (H100 SXM data sheet, at 700 W). 67 TFLOP/s float32 is 132 SMs x 128 lanes x 2 (fused
# multiply-add) x 1.98 GHz; int32 has 64 lanes an SM a clock and no fused
# pair, so a quarter of it.
INT32_OPS_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12
# int32 ops the kernels' recurrences need: Myers, 17 64-bit ops per 64-bit
# word per candidate char, two int32 ops each.
MYERS_OPS_PER_WORD_STEP = 34
# f64 has 64 lanes an SM a clock, half of float32's 128; counted as
# instructions (a fused multiply-add is one), like the int32 rate. The
# MinHash roll per (document, dimension, byte): 5 f64-pipe instructions
# (DFMA, DFMA, DFMA.RM, DADD, DFMA; the minimum and count are kept off
# that pipe), counted in fingerprint_minhash's steady loop in the built
# library's SASS by tools/minhash_ab.py --probe (PERF.md §6). The step
# before the redesign counted 10: a multiply, two fused
# multiply-adds, an add, a multiply and a floor for the quotient, two
# compare-and-corrects and the minimum's compare and select.
F64_OPS_PER_S = 67e12 / 4
FINGERPRINT_OPS_PER_STEP = 5
# int32 ops a haystack byte: the search's SWAR first-byte filter, 9 a
# 4-byte word. The UTF-8 pass has no operations term: every design must
# read each byte once, but no count of operations is one that every design
# must do (an all-ASCII 16-byte vector is settled by an OR of its words and
# a test; the bit-7 classes of csrc/utf8.cu take some 25-40 instructions a
# multi-byte word, tools/utf8_ab.py --probe, and a design with fewer is not
# ruled out). Its bound is the bytes read once.
FIND_OPS_PER_BYTE = 2.25
# int32 ops of the AES kernels as written: one AESENC is 16 table loads,
# 16 byte extracts and 16 xors; a sum-lane update 16 byte moves and two
# 64-bit adds (4 int32 ops); a block absorbed is one of each.
AES_OPS = 48
BLOCK_OPS = AES_OPS + 20


# int32 issue slots a DPX add-min/add-max (__viaddmin_s32 and kin, one
# VIADDMNMX) takes: tools/dp_hash_sweep.py's dpx part measured 61.86
# __viaddmin_s32 and 61.82 __viaddmax_s32_relu an SM a clock against 62.02
# plain int32 mins (NVIDIA H100 80GB HBM3, 700 W), so one.
DPX_SLOTS = 1.0


def _dp_ops_per_cell(cfg) -> float:
    """int32 issue slots a DP cell needs on this card, each add fused into
    its min or max by DPX: linear, an add for the diagonal and two
    add-min/max; affine, two adds, three add-min/max and a min/max; local,
    the running best, and for min the clamp at 0 (max clamps in the add-max's
    _relu form). The substitution is left out: a query profile read in
    16-byte loads brings it under one instruction a cell. Used by every DP
    bound (the column DP, the flat, band and stage kernels)."""
    plain, dpx = (3, 3) if cfg.is_affine else (1, 2)
    if cfg.is_local:
        plain += 2 if cfg.objective == "min" else 1
    return plain + DPX_SLOTS * dpx


def _dp_ops_per_cell_unfused(cfg) -> int:
    """The count of the bounds before DPX was counted: every add and every
    min/max one operation, plus the substitution, and the clamp and the
    running best when local. Printed beside the bound so that shares compare
    with those of older runs; no bound uses it."""
    return (10 if cfg.is_affine else 5) + (2 if cfg.is_local else 0)


def _certifying_rung_cells(m: int, n: int, distance: int, k0: int = 64) -> int:
    """Band cells of the band ladder's rung that certifies an m x n pair of
    this distance: half-width k, the first rung's k0 doubled until the band
    holds cell (m, n), then until k >= distance (ops/wavefront.py _band),
    row i holding min(n, i + k) - max(0, i - k) + 1 cells (_band_rung's
    count). The rungs before it, and any the ladder skips to, are left out,
    so this never counts more than the ladder walks."""
    from stringzilla_tpu_torch.ops.wavefront import BAND_KMAX

    k = max(k0, 2)
    while k < abs(m - n) or k < distance:
        k *= 2
    k = min(k, BAND_KMAX)
    i = np.arange(1, m + 1)
    return int((np.minimum(n, i + k) - np.maximum(0, i - k) + 1).sum())


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the int32 peak
    and bytes over the memory rate."""
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _wagner_fischer(a, b) -> int:
    """Row-at-a-time Wagner-Fischer in numpy over bytes or int sequences
    (runes): the in-row dependency cur[j] = min(x[j], cur[j-1] + 1) is
    solved exactly as a running minimum of x[j] - j, plus j."""
    a = np.frombuffer(a, np.uint8) if isinstance(a, bytes) else np.asarray(a, np.int64)
    b = np.frombuffer(b, np.uint8) if isinstance(b, bytes) else np.asarray(b, np.int64)
    j = np.arange(len(b) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(a) + 1):
        x = np.empty_like(prev)
        x[0] = i
        x[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(x - j) + j
    return int(prev[-1])


def _gotoh(a, b, sub, gap, extend, maximize, local) -> int:
    """Row-at-a-time alignment score in numpy, independent of the port:
    linear gaps when ``extend`` is None, else Gotoh's three matrices (a run
    of k gaps costs gap + extend * (k - 1), gap matrices padded at the
    border by gap + extend, the semantics of ``tests/oracles.py``).
    ``sub(i)`` gives the costs of query char i against every candidate
    char. The in-row chains are solved as running min/max, as in
    ``_wagner_fischer``."""
    opt = np.maximum if maximize else np.minimum
    acc = opt.accumulate
    n, m = len(a), len(b)
    j = np.arange(m + 1, dtype=np.int64)

    def bound(k):
        if local or k == 0:
            return 0
        return gap * k if extend is None else gap + extend * (k - 1)

    prev = np.array([bound(k) for k in j], np.int64)
    best = 0
    if extend is None:
        for i in range(1, n + 1):
            x = np.empty_like(prev)
            x[0] = bound(i)
            x[1:] = opt(prev[1:] + gap, prev[:-1] + sub(i))
            if local:
                x[1:] = opt(x[1:], 0)
            prev = acc(x - gap * j) + gap * j
            if local and m:
                best = opt(best, acc(prev[1:])[-1])
        return int(best if local else prev[m])
    chain = max(gap, extend) if maximize else min(gap, extend)
    gbound = lambda k: bound(k) + gap + extend
    vert = prev + gap + extend  # gaps along the query, border included
    jj = j[1:]
    for i in range(1, n + 1):
        vert = opt(prev + gap, vert + extend)
        s = prev[:-1] + sub(i)
        if local:
            s = opt(s, 0)
        y = opt(vert[1:], s)
        # gaps along the candidate: I[1] from the border, then the chain
        # I[k] = opt(y[k-1] + gap, I[k-1] + opt(gap, extend))
        b_ = np.empty(m, np.int64)
        if m:
            b_[0] = opt(bound(i) + gap, gbound(i) + extend)
            b_[1:] = y[:-1] + gap
        horiz = acc(b_ - chain * jj) + chain * jj
        cur = np.empty_like(prev)
        cur[0] = bound(i)
        cur[1:] = opt(y, horiz)
        vert[0] = gbound(i)
        prev = cur
        if local and m:
            best = opt(best, acc(cur[1:])[-1])
    return int(best if local else prev[m])


def _block(rng, q_lens, c_lens, rows, cand_len, lo, hi):
    """Random query/candidate blocks in the ``myers`` layouts; every third
    candidate is a mutated copy of a query, so distances span small to
    large."""
    nq, nc = len(q_lens), len(c_lens)
    q_t = np.full((rows, nq), -1, np.int32)
    for i, m in enumerate(q_lens):
        q_t[:m, i] = rng.integers(lo, hi, m)
    c_t = np.zeros((cand_len, nc), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(lo, hi, n)
        if j % 3 == 0 and nq:
            src = q_t[: q_lens[j % nq], j % nq]
            k = min(n, len(src))
            keep = rng.random(k) > 0.1
            c_t[:k, j] = np.where(keep, src[:k], c_t[:k, j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


class Timing(float):
    """A median time in ms that also carries the fastest (``lo``) and
    slowest (``hi``) of the batches it is the median of."""


def _time_ms(fn, iters, sync, batches=5):
    """Device time of ``fn`` per run, by CUDA events around each of
    ``batches`` batches of ``iters`` runs, after one warm-up run: the
    median batch, with the spread of all of them."""
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(batches):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / iters)
    t = Timing(np.median(times))
    t.lo, t.hi = min(times), max(times)
    return t


def _time_cold_ms(fn, iters, sync, dev, batches=5):
    """``_time_ms`` with the L2 cache flushed before each run: a 256 MiB
    read (five times the 50 MB L2) ahead of each run, outside the CUDA
    events around it. The read keeps the card busy while the run's launch
    is queued, so the events time the run alone."""
    import torch

    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    fn()
    sync()
    times = []
    for _ in range(batches):
        for start, end in zip(starts, ends):
            flush.sum()
            start.record()
            fn()
            end.record()
        sync()
        times.append(sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters)
    t = Timing(np.median(times))
    t.lo, t.hi = min(times), max(times)
    return t


def _raw_launch(symbol, *args):
    """A function that launches the kernel library's ``symbol`` with
    ``args`` built beforehand and raises if the launch fails: a kernel's
    time without its wrapper's host work, for kernels too short to hide
    it (under ~0.1 ms)."""
    from stringzilla_tpu_torch.utils import cuda_build

    lib = cuda_build.load()
    fn = getattr(lib, symbol)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{symbol}: {lib.sz_cuda_error_string(err).decode()} ({err})")

    return launch


def _launch_env(dev):
    """(SM count, current stream handle) of ``dev``, as the wrappers pass them."""
    import torch

    return (torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)


def utf8_launch(mirror, n):
    """A raw launch of ``sz_utf8_validate_count`` over ``mirror[:n]`` with
    its output and arguments made beforehand (``_raw_launch``), as
    ``ops.utf8_device.validate_count_raw`` passes them. The output is the
    function's ``out``."""
    import ctypes

    import torch
    from stringzilla_tpu_torch.ops import utf8_device

    sms, stream = _launch_env(mirror.device)
    out = torch.empty(2, dtype=torch.int64, device=mirror.device)
    masks = (ctypes.c_uint32 * len(utf8_device.MASKS))(*utf8_device.MASKS)
    launch = _raw_launch("sz_utf8_validate_count", mirror.data_ptr(), n, out.data_ptr(), masks,
                         sms, stream)
    launch.out, launch.masks = out, masks
    return launch


def _profile(name, fn, sync, kernel_ms):
    """Prints the device's idle share of one call of ``fn`` under
    ``torch.profiler``: device time is the sum of every kernel's and copy's
    own time (the device's events only: a host op's device time repeats
    the time of the kernels it launched), wall time the host clock to the
    end of a synchronise. The call runs the work of ``kernel_ms`` (its main
    kernel alone, by CUDA events) at least once, so a trace whose device
    time is under half of it has lost device events, all or some: it is
    reported as lost, with the device events it holds, and the call is
    profiled once more in a fresh session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for session in (1, 2):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        on_device = [e for e in averages if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        if device_ms >= 0.5 * kernel_ms:
            print(f"[profile] {name}: one call under torch.profiler (session {session}): "
                  f"device {device_ms:.3f} ms of {wall_ms:.3f} ms wall, idle "
                  f"{100 * (1 - device_ms / wall_ms):.1f}%")
            return
        held = collections.Counter(e.name[:48] for e in prof.events()
                                   if e.device_type == DeviceType.CUDA)
        print(f"[profile] {name}: trace lost (session {session}): device {device_ms:.3f} ms "
              f"against {kernel_ms:.4f} ms of the kernel alone by events, {wall_ms:.3f} ms "
              f"wall; device events held: {dict(held)}")


def _reset(*counters):
    for counts in counters:
        for k in counts:
            counts[k] = 0


def _launched(name, counters, expect, run, launches):
    """Runs one main path with the launch counts set to 0 just before it;
    checks that every kernel of ``expect`` launched and adds the counts up."""
    _reset(*counters)
    out = run()
    got = {k: v for c in counters for k, v in c.items()}
    print(f"[engine] launches on the {name} main path: {got}")
    for k in expect:
        _check(got[k] > 0, f"{name}: {k} was not launched on the main path")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return out


def _host_ms(fn, sync, runs=3):
    """Mean host-clock time of ``fn`` (synchronised) in ms."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    sync()
    return (time.perf_counter() - t0) / runs * 1e3


@contextlib.contextmanager
def _tier_b_segments(seg):
    """Tier B in segments of ``seg`` lanes whatever the plan picks (the
    plan's own pick when ``seg`` is None)."""
    from stringzilla_tpu_torch.ops import myers as myers_mod

    plan = myers_mod.tier_b_plan
    if seg is not None:
        myers_mod.tier_b_plan = lambda *_: seg
    try:
        yield
    finally:
        myers_mod.tier_b_plan = plan


def _each_segment(rows, fn):
    """``fn()`` with tier B in each segment width (8 and 32 lanes) on a
    block of ``rows`` rows that tier B takes, once with the plan's own pick
    otherwise: ``[(width or None, result)]``."""
    from stringzilla_tpu_torch.ops.myers import TIER_B_SEGMENTS, words_of

    results = []
    for seg in (TIER_B_SEGMENTS if words_of(rows) > 4 else (None,)):
        with _tier_b_segments(seg):
            results.append((seg, fn()))
    return results


def _check_myers_kernel(dev, sync, max_err):
    """Phase 3: both Myers tiers against their plain version, tier B in
    each of its segment widths."""
    import torch
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference, words_of

    rng = np.random.default_rng(SEED)
    cases = [  # name, query lengths, candidate lengths, rows, cand_len, chars
        ("w1 abcd", rng.integers(0, 65, 6), rng.integers(0, 101, 300), 64, 100, (97, 101)),
        ("w2 bytes+out-of-range", rng.integers(0, 129, 6), rng.integers(0, 161, 300), 128, 160, (-2, 260)),
        ("w3 ab", rng.integers(0, 193, 5), rng.integers(0, 201, 257), 192, 200, (97, 99)),
        ("w4 lower", rng.integers(0, 257, 5), rng.integers(0, 301, 300), 256, 300, (97, 123)),
        ("w8 ab", rng.integers(257, 513, 4), rng.integers(0, 601, 99), 512, 600, (97, 99)),
        ("w33 lower", rng.integers(2049, 2113, 3), rng.integers(0, 2200, 40), 2112, 2200, (97, 123)),
        ("w64 bytes", rng.integers(3000, 4097, 3), rng.integers(0, 4097, 40), 4096, 4096, (0, 256)),
        ("bounds w1", [0, 1, 63, 64], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 64, 257, (97, 99)),
        ("bounds w2", [0, 63, 64, 65, 127, 128], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 128, 257, (97, 99)),
        ("bounds w4", [0, 127, 128, 129, 255, 256], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 256, 257, (97, 99)),
        ("bounds w8", [255, 256, 257, 511, 512], [0, 1, 255, 256, 257, 511, 512, 513], 512, 513, (97, 99)),
        ("bounds w64", [0, 257, 2047, 2048, 2049, 4095, 4096], [0, 1, 64, 257, 2048, 4095, 4096], 4096, 4096, (97, 99)),
        # tier B's runs of 1-8 words a lane (5-64 words in segments of 8
        # and 32 lanes), candidates of every length in each warp
        ("mixed words", MIXED_WORD_QUERIES, rng.integers(0, 2101, 61), 4096, 2100, (97, 123)),
    ]
    for name, q_lens, c_lens, rows, cand_len, (lo, hi) in cases:
        args = [torch.from_numpy(x).to(dev) for x in
                _block(rng, q_lens, c_lens, rows, cand_len, lo, hi)]
        want = myers_reference(*args)
        tier = "myers_tier_a" if words_of(rows) <= 4 else "myers_tier_b"
        for seg, got in _each_segment(rows, lambda: myers(*args)):
            sync()
            err = int((got.long() - want.long()).abs().max())
            max_err[tier] = max(max_err.get(tier, 0), err)
            lanes = f" S={seg}" if seg else ""
            print(f"[kernel] {name:22s} {tier}{lanes} rows={rows} cand_len={cand_len} "
                  f"{len(q_lens)}x{len(c_lens)} max_abs_err={err}")
            _check(torch.equal(got, want), f"kernel != plain version in case {name}{lanes}")


def _dp_configs(k):
    """The 16 column-DP configurations, with the k-th costs of each kind:
    both signs of every cost appear over k = 0..4, so gaps of the wrong
    sign for the objective are covered."""
    from stringzilla_tpu_torch.ops.similarity import (
        AffineGaps, ClassCosts, LinearGaps, SimilarityConfig, UniformCosts)

    linear = [2, -3, 1, -1, 4]
    affine = [(3, 1), (-3, -1), (-10, -1), (5, -2), (-2, 4)]
    uniform = [(0, 1), (-1, 3), (2, -1), (0, 2), (5, -4)]
    # the kernel reads its table argument, not the config's
    classes = ClassCosts.from_arrays(np.arange(256) % 64, np.zeros((32, 32)))
    for objective, locality, is_affine, uses_classes in itertools.product(
            ("min", "max"), ("global", "local"), (False, True), (False, True)):
        gaps = AffineGaps(*affine[k]) if is_affine else LinearGaps(linear[k])
        costs = classes if uses_classes else UniformCosts(*uniform[k])
        yield SimilarityConfig(objective, locality, gaps, costs)


def _dp_block(rng, rows, q_lens, cand_len, c_lens, lo, hi):
    """Blocks in the column DP's layouts: the query shifted down one row
    (row 0 and padding 0); every third candidate a mutated copy of a
    query."""
    nq, nc = len(q_lens), len(c_lens)
    q_t = np.zeros((rows, nq), np.int32)
    for i, m in enumerate(q_lens):
        q_t[1: m + 1, i] = rng.integers(lo, hi, m)
    c_t = np.zeros((cand_len, nc), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(lo, hi, n)
        if j % 3 == 0:
            src = q_t[1: q_lens[j % nq] + 1, j % nq]
            k = min(n, len(src))
            c_t[:k, j] = np.where(rng.random(k) > 0.2, src[:k], c_t[:k, j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


def _check_dp_kernel(dev, sync, max_err):
    """Phase 3b: the column DP's two routes, forced, in all 16 configurations
    against its plain version: strip edges (query rows 31-33), the warp
    route's pass edges (1,023-1,025, 2,048/2,049) and the longest block."""
    import torch
    from stringzilla_tpu_torch.ops import similarity_dp as dp_mod
    from stringzilla_tpu_torch.ops.similarity import similarity_reference
    from stringzilla_tpu_torch.ops.similarity_dp import ROUTES, similarity

    rng = np.random.default_rng(SEED + 3)
    table = torch.from_numpy(rng.integers(-8, 9, (32, 32)).astype(np.int32)).to(dev)
    shapes = [  # rows, query lengths, cand_len, candidate count
        (8, [0, 7, 3, 5], 40, 300),
        (40, [0, 39, 31, 32, 33], 70, 300),
        (136, [0, 135, 64, 65], 140, 200),
        (1032, [0, 1031, 1023, 1024, 1025, 517], 100, 100),
        (2056, [2048, 2049, 0, 1], 64, 40),
        (4104, [0, 4103], 40, 64),
    ]
    err = 0
    for k, (rows, q_lens, cand_len, nc) in enumerate(shapes):
        c_lens = np.concatenate([[0, 1, 31, 32, 33, cand_len],
                                 rng.integers(0, cand_len + 1, nc - 6)])
        blocks = {  # class ids 0-39 (>= 32 cost 0); raw chars -2..5
            True: [torch.from_numpy(x).to(dev) for x in
                   _dp_block(rng, rows, q_lens, cand_len, c_lens, 0, 40)],
            False: [torch.from_numpy(x).to(dev) for x in
                    _dp_block(rng, rows, q_lens, cand_len, c_lens, -2, 6)]}
        for cfg in _dp_configs(k % 5):
            args = blocks[cfg.uses_classes]
            want = similarity_reference(*args, cfg, table)
            for route in ROUTES:
                got = similarity(*args, cfg, table, route=route)
                sync()
                err = max(err, int((got.long() - want.long()).abs().max()))
                _check(torch.equal(got, want), f"similarity kernel ({route} route) != plain "
                       f"version at rows {rows} in {cfg}")
        print(f"[kernel] similarity_dp, similarity_dp_warp rows={rows} cand_len={cand_len} "
              f"{len(q_lens)}x{nc} (query rows {q_lens}): 16 configurations exact on both routes")
    # A scratch cap below one launch's need splits it over query and
    # candidate ranges; the last shape's affine configurations then run as
    # 2 x 64 and as 1 x 8 launches on either route.
    cap = dp_mod.SCRATCH_CAP_BYTES
    try:
        for dp_mod.SCRATCH_CAP_BYTES in (cand_len * 8, cand_len * 8 * 2 * 9):
            for cfg in _dp_configs((len(shapes) - 1) % 5):
                if cfg.is_affine:
                    args = blocks[cfg.uses_classes]
                    want = similarity_reference(*args, cfg, table)
                    for route, name in ROUTES.items():
                        before = dp_mod.KERNEL_LAUNCHES[name]
                        got = similarity(*args, cfg, table, route=route)
                        launched = dp_mod.KERNEL_LAUNCHES[name] - before
                        sync()
                        _check(launched > 1 and torch.equal(got, want),
                               f"similarity kernel ({route} route) split over {launched} "
                               f"launches != plain version in {cfg}")
    finally:
        dp_mod.SCRATCH_CAP_BYTES = cap
    print("[kernel] similarity_dp, similarity_dp_warp split over query and candidate ranges: "
          "exact")
    max_err["similarity_dp"] = max_err["similarity_dp_warp"] = err


def _check_lut_kernel(dev, sync, max_err):
    """Phase 3b: the byte LUT against its plain version."""
    import torch
    from stringzilla_tpu_torch.ops.memory import lookup_transform

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    lut = torch.randperm(256, generator=gen, device=dev).to(torch.uint8)
    err = 0
    for n, offset in [(0, 0), (1, 0), (15, 0), (16, 0), (17, 0),
                      (2**24 + 3, 0), (2**20 + 5, 1)]:
        base = torch.randint(0, 256, (n + offset,), dtype=torch.uint8,
                             generator=gen, device=dev)
        x = base[offset:]
        got = lookup_transform(x, lut)
        want = lut[x.long()]
        sync()
        if n:
            err = max(err, int((got.int() - want.int()).abs().max()))
        _check(torch.equal(got, want), f"lut kernel != plain version at n={n}")
        print(f"[kernel] byte_lut n={n} offset={offset} exact")
    max_err["byte_lut"] = err


def headline_strings():
    """Phase 4's ``headline`` workload (``HEADLINE``): ``bench.py``'s
    draws in its order, lines of N(100, 12.5) lowercase bytes clipped to
    [8, 128]."""
    rng = np.random.default_rng(SEED)

    def make_batch(count, maxlen, mean_len=100):
        lens = np.clip(rng.normal(mean_len, mean_len / 8, count).astype(np.int32),
                       8, maxlen)
        chars = rng.integers(97, 123, size=(maxlen, count), dtype=np.int32)
        return [chars[: lens[i], i].astype(np.uint8).tobytes()
                for i in range(count)]

    return make_batch(HEADLINE[0], 128), make_batch(HEADLINE[1], 128)


def long_strings():
    """Phase 4's ``long`` workload (``LONG``): queries and candidates of
    300-4096 lowercase bytes, every fourth candidate a near-duplicate of a
    query."""
    long_rng = np.random.default_rng(SEED + 1)
    long_q = [long_rng.integers(97, 123, n).astype(np.uint8).tobytes()
              for n in long_rng.integers(300, 4097, LONG[0])]
    long_c = []
    for j, n in enumerate(long_rng.integers(300, 4097, LONG[1])):
        chars = long_rng.integers(97, 123, n).astype(np.uint8)
        if j % 4 == 0:  # near-duplicates of a query as well as random lines
            src = np.frombuffer(long_q[j % LONG[0]], np.uint8)[:n]
            keep = long_rng.random(len(src)) > 0.05
            chars[: len(src)] = np.where(keep, src, chars[: len(src)])
        long_c.append(chars.tobytes())
    return long_q, long_c


def myers_block(qs, cs, dev):
    """One ``myers`` block of every query and one of every candidate, packed
    on the card as the engine packs its blocks: the kernel's inputs when
    timed alone."""
    from stringzilla_tpu_torch import Tape
    from stringzilla_tpu_torch.ops.pack_device import device_tape, pack_chars

    rows = max(32, -(-max(map(len, qs)) // 32) * 32)
    cand_len = max(map(len, cs))
    qdt = device_tape(Tape.from_strings(qs), dev)
    cdt = device_tape(Tape.from_strings(cs), dev)
    q_offs, q_lens = qdt.bucket_arrays(np.arange(len(qs)))
    c_offs, c_lens = cdt.bucket_arrays(np.arange(len(cs)))
    return (pack_chars(qdt.data, q_offs, q_lens, row_len=rows, transpose=True, fill=-1),
            q_lens.view(-1, 1),
            pack_chars(cdt.data, c_offs, c_lens, row_len=cand_len, transpose=True, fill=0),
            c_lens.view(1, -1))


def tier_b_launch(block, dev, seg=None):
    """A function that launches tier B's raw ``sz_myers`` on a packed byte
    block, its match table built, its candidates ordered by length and its
    segment width picked (``ops.myers.tier_b_plan``, or ``seg`` when given)
    beforehand, and the output it writes. A library from before tier B took
    its candidates by length (an ``sz_myers`` of 10 arguments) gets neither
    the order nor the width."""
    import torch
    from stringzilla_tpu_torch.ops import myers as myers_mod
    from stringzilla_tpu_torch.utils import cuda_build

    q_t, qlens, cands_t, clens = block
    (rows, nq), (cand_len, nc) = q_t.shape, cands_t.shape
    words = myers_mod.words_of(rows)
    peq = myers_mod._peq(q_t, qlens, words)
    out = torch.empty((nq, nc), dtype=torch.int32, device=dev)
    by_length = torch.argsort(clens.view(-1)).to(torch.int32)
    sms, stream = _launch_env(dev)
    extra = []
    if len(cuda_build.load().sz_myers.argtypes) > 10:
        extra = [by_length.data_ptr(), myers_mod.tier_b_plan(words, nq, nc, sms) if seg is None
                 else seg]
    head = [peq.data_ptr(), words, qlens.data_ptr(), nq, cands_t.data_ptr(), clens.data_ptr()]
    launch = _raw_launch("sz_myers", *head, *extra, cand_len, nc, out.data_ptr(), stream)
    launch.keep = (peq, by_length)  # alive as long as the launch
    launch.seg = extra[1] if extra else None
    return launch, out


def rune_launch(block, dev, seg=None, tables=None):
    """A function that launches the raw ``sz_myers_runes`` (either tier)
    on a packed rune block, its rune tables (``tables``, or ``_rune_peq``'s)
    built, its candidates ordered by length and tier B's segment width
    picked (``ops.myers.tier_b_plan``, or ``seg`` when given) beforehand,
    and the output it writes."""
    import torch
    from stringzilla_tpu_torch.ops import myers as myers_mod

    q_t, qlens, cands_t, clens = block
    (rows, nq), (cand_len, nc) = q_t.shape, cands_t.shape
    words = myers_mod.words_of(rows)
    keys, key_offs, peq = (myers_mod._rune_peq(q_t, qlens, words) if tables is None
                           else tables)
    out = torch.empty((nq, nc), dtype=torch.int32, device=dev)
    by_length = torch.argsort(clens.view(-1)).to(torch.int32)
    sms, stream = _launch_env(dev)
    seg = myers_mod.tier_b_plan(words, nq, nc, sms) if seg is None else seg
    launch = _raw_launch("sz_myers_runes", keys.data_ptr(), key_offs.data_ptr(), peq.data_ptr(),
                         words, qlens.data_ptr(), nq, cands_t.data_ptr(), clens.data_ptr(),
                         by_length.data_ptr(), seg, cand_len, nc, out.data_ptr(), stream)
    launch.keep = (keys, key_offs, peq, by_length)  # alive as long as the launch
    launch.seg = seg if words > 4 else None
    return launch, out


def _engine_blocks(engine, qs, cs, keep):
    """The ``myers`` calls one call of ``engine`` makes whose query block
    and alphabet pass ``keep``: ``[(block, keywords)]``, each block the
    engine's own packed ``(q_t, qlens, cands_t, clens)``."""
    from stringzilla_tpu_torch.models import similarities as sim_mod

    real, calls = sim_mod.myers, []

    def spy(q_t, qlens, cands_t, clens, alphabet=256, **kw):
        if keep(q_t, alphabet):
            calls.append(((q_t, qlens, cands_t, clens), kw))
        return real(q_t, qlens, cands_t, clens, alphabet=alphabet, **kw)

    sim_mod.myers = spy
    try:
        engine(qs, cs)
    finally:
        sim_mod.myers = real
    return calls


def _block_bound_ms(block):
    """A Myers block's operations bound, each query on its own words."""
    word_steps = (np.ceil(block[1].cpu().numpy() / 64).sum()
                  * block[3].cpu().numpy().astype(np.float64).sum())
    return _bound(MYERS_OPS_PER_WORD_STEP * word_steps, 0)[0]


def _engine_tier_b(engine, qs, cs, dev, sync, launcher=tier_b_launch):
    """The tier-B blocks one call of ``engine`` launches (byte strings),
    each one raw kernel launch on the engine's own packed block
    (``launcher``) timed alone by CUDA events (the median of batches) and
    checked against the plain version: a list of ``(rows, queries,
    candidates, ms, bound ms, lanes a candidate)``, the bound counting each
    query's own words."""
    from stringzilla_tpu_torch.ops import myers as myers_mod

    calls = _engine_blocks(engine, qs, cs, lambda q_t, alphabet: (
        myers_mod.words_of(q_t.shape[0]) > 4 and alphabet is not None))
    timed = []
    for block, _ in calls:
        (rows, nq), (_, nc) = block[0].shape, block[2].shape
        launch, out = launcher(block, dev)
        ms = _time_ms(launch, 10, sync)
        _check(bool((out == myers_mod.myers_reference(*block)).all()),
               f"tier B on the engine's {rows}-row block != the plain version")
        timed.append((rows, nq, nc, ms, _block_bound_ms(block), launch.seg))
    return timed


def _engine_runes(engine, qs, cs, dev, sync):
    """The rune blocks one call of ``engine`` launches, each one raw
    ``sz_myers_runes`` launch on the engine's own packed block and rune
    tables (``rune_launch``; built there where the engine passes none)
    timed alone by CUDA events and checked against the plain version: a
    list of ``(tier, rows, queries, candidates, ms, bound ms, lanes a
    candidate)``, the bound counting each query's own words."""
    from stringzilla_tpu_torch.ops import myers as myers_mod

    timed = []
    for block, kw in _engine_blocks(engine, qs, cs, lambda q_t, alphabet: alphabet is None):
        (rows, nq), (_, nc) = block[0].shape, block[2].shape
        launch, out = rune_launch(block, dev, tables=kw.get("rune_tables"))
        ms = _time_ms(launch, 10, sync)
        _check(bool((out == myers_mod.myers_reference(*block, alphabet=None)).all()),
               f"the rune kernel on the engine's {rows}-row block != the plain version")
        tier = "myers_tier_a_runes" if myers_mod.words_of(rows) <= 4 else "myers_tier_b_runes"
        timed.append((tier, rows, nq, nc, ms, _block_bound_ms(block), launch.seg))
    return timed


def _myers_main_path(dev, sync, report):
    """Phase 4: unit-cost Levenshtein through the engine."""
    from stringzilla_tpu_torch import LevenshteinDistances
    from stringzilla_tpu_torch.ops import myers as myers_mod
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference
    from tests.oracles import levenshtein

    head_q, head_c = headline_strings()
    long_q, long_c = long_strings()

    engine = LevenshteinDistances()
    sync()
    _reset(myers_mod.KERNEL_LAUNCHES)
    head = engine(head_q, head_c)
    long_ = engine(long_q, long_c)
    launches = dict(myers_mod.KERNEL_LAUNCHES)
    print(f"[engine] launches on the unit-cost main path: {launches}")
    for k in ("myers_tier_a", "myers_tier_b"):  # byte strings: the rune tiers run in 4d
        _check(launches[k] > 0, f"{k} was not launched on the main path")

    for name, qs, cs, res, n_wf, tier in (
            ("headline", head_q, head_c, head, 256, "myers_tier_a"),
            ("long", long_q, long_c, long_, 16, "myers_tier_b")):
        _check(res.dtype == np.uint64 and res.shape == (len(qs), len(cs)),
               f"{name}: result {res.dtype} {res.shape}")
        # the same packed device inputs for the kernel alone and the plain
        # version: one block of every query and one of every candidate
        packed = myers_block(qs, cs, dev)
        (rows, _), (cand_len, _) = packed[0].shape, packed[2].shape
        plain = myers_reference(*packed)
        _check(np.array_equal(res.astype(np.int64), plain.cpu().numpy()),
               f"{name}: engine result != plain version on the card")
        pick = np.random.default_rng(SEED + 2)
        wf = levenshtein if name == "headline" else _wagner_fischer
        for i, j in zip(pick.integers(0, len(qs), n_wf), pick.integers(0, len(cs), n_wf)):
            _check(int(res[i, j]) == wf(qs[i], cs[j]),
                   f"{name}: pair ({i}, {j}) != Wagner-Fischer")
        print(f"[engine] {name}: {len(qs)}x{len(cs)} equals the plain version "
              f"and Wagner-Fischer on {n_wf} pairs")

        ql = np.array([len(q) for q in qs], np.float64)
        cl = np.array([len(c) for c in cs], np.float64)
        cells = ql.sum() * cl.sum()
        word_steps = np.ceil(ql / 64).sum() * cl.sum()
        nbytes = 4.0 * (rows * len(qs) + cand_len * len(cs) + len(qs) * len(cs))
        t0 = time.perf_counter()
        engine_runs = 3
        for _ in range(engine_runs):
            engine(qs, cs)
        engine_s = (time.perf_counter() - t0) / engine_runs
        kernel_ms = _time_ms(lambda: myers(*packed), 10, sync)
        plain_ms = _time_ms(lambda: myers_reference(*packed), 1, sync, batches=1)
        _profile(name, lambda: engine(qs, cs), sync, kernel_ms)
        bound_ms, bound_by = _bound(MYERS_OPS_PER_WORD_STEP * word_steps, nbytes)
        report[tier] = dict(launches=launches[tier], ms=kernel_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
        print(f"[perf] {name} rows={rows} cand_len={cand_len} cells={cells:.0f}: "
              f"engine+pull {engine_s * 1e3:.3f} ms = {cells / engine_s / 1e9:.3f} GCUPS; "
              f"kernel {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = "
              f"{cells / kernel_ms / 1e6:.3f} GCUPS; "
              f"plain {plain_ms:.3f} ms = {cells / plain_ms / 1e6:.3f} GCUPS; "
              f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of it")
        if tier == "myers_tier_b" and dev.type == "cuda":
            seg = myers_mod.tier_b_plan(myers_mod.words_of(rows), len(qs), len(cs),
                                        _launch_env(dev)[0])
            print(f"[perf] {name}: tier B takes the block in segments of {seg} lanes")
            timed = _engine_tier_b(engine, qs, cs, dev, sync)
            print(f"[perf] {name}: the engine's own tier-B launches: {len(timed)}, kernel "
                  f"{sum(t[3] for t in timed):.4f} ms summed by CUDA events "
                  f"({', '.join(f'{r} rows {q}x{c} S={g} {t:.4f}' for r, q, c, t, _, g in timed)}"
                  f"); bound {sum(t[4] for t in timed):.4f} ms summed over its blocks")


def _proteins(rng):
    """``bench_nw_proteins``'s draws, in its order: the symmetric random
    table, then queries, then candidates."""
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    b2c = np.zeros(256, dtype=np.uint8)
    b2c[aa] = np.arange(len(aa))
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    table = ((table + table.T) // 2).astype(np.int32)
    np.fill_diagonal(table, rng.integers(4, 10, 32))
    qs = [rng.choice(aa, int(n)).tobytes() for n in
          np.clip(rng.normal(1000, 100, PROTEINS[0]).astype(int), 100, 1024)]
    cs = [rng.choice(aa, int(n)).tobytes() for n in
          np.clip(rng.normal(1000, 100, PROTEINS[1]).astype(int), 100, 1024)]
    return b2c, table, qs, cs


def _lines(rng):
    """``bench.py``'s lines: lengths N(100, 12.5) clipped to [8, 128]."""
    def make_batch(count, maxlen=128, mean_len=100):
        lens = np.clip(rng.normal(mean_len, mean_len / 8, count).astype(np.int32),
                       8, maxlen)
        chars = rng.integers(97, 123, size=(maxlen, count), dtype=np.int32)
        return [chars[: lens[i], i].astype(np.uint8).tobytes() for i in range(count)]
    return make_batch(LINES[0]), make_batch(LINES[1])


def _dp_main_path(dev, sync, report):
    """Phase 4b: the column-DP engines on proteins and weighted lines."""
    import torch
    from stringzilla_tpu_torch import (LevenshteinDistances, NeedlemanWunschScores,
                                       SmithWatermanScores, Tape)
    from stringzilla_tpu_torch.ops import memory as memory_mod
    from stringzilla_tpu_torch.ops import similarity_dp as dp_mod
    from stringzilla_tpu_torch.ops.memory import lookup_reference, lookup_transform
    from stringzilla_tpu_torch.ops.pack_device import device_tape, pack_chars
    from stringzilla_tpu_torch.ops.similarity import similarity_reference
    from stringzilla_tpu_torch.ops.similarity_dp import ROUTES, dp_plan, similarity

    b2c, table, prot_q, prot_c = _proteins(np.random.default_rng(SEED))
    line_q, line_c = _lines(np.random.default_rng(SEED))
    # Tapes built once, outside the timed calls, as bench_nw_proteins does.
    prot_qt, prot_ct = Tape.from_strings(prot_q), Tape.from_strings(prot_c)
    runs = [  # name, engine, inputs, strings, gaps (open, extend or None)
        ("nw-linear", NeedlemanWunschScores(b2c, table, open=-5, extend=-5),
         (prot_qt, prot_ct), (prot_q, prot_c), (-5, None)),
        ("sw-linear", SmithWatermanScores(b2c, table, open=-5, extend=-5),
         (prot_qt, prot_ct), (prot_q, prot_c), (-5, None)),
        ("nw-affine", NeedlemanWunschScores(b2c, table, open=-10, extend=-1),
         (prot_qt, prot_ct), (prot_q, prot_c), (-10, -1)),
        ("sw-affine", SmithWatermanScores(b2c, table, open=-10, extend=-1),
         (prot_qt, prot_ct), (prot_q, prot_c), (-10, -1)),
        ("lev-weighted", LevenshteinDistances(match=0, mismatch=2, open=3, extend=1),
         (line_q, line_c), (line_q, line_c), (3, 1)),
    ]
    sync()
    _reset(dp_mod.KERNEL_LAUNCHES, memory_mod.KERNEL_LAUNCHES)
    results = [engine(*inputs) for _, engine, inputs, _, _ in runs]
    launches = {**dp_mod.KERNEL_LAUNCHES, **memory_mod.KERNEL_LAUNCHES}
    print(f"[engine] launches on the column-DP main path: {launches}")
    for k, n in launches.items():
        _check(n > 0, f"{k} was not launched on the main path")

    padded = np.zeros((33, 33), np.int64)
    padded[:32, :32] = table
    err = 0
    for (name, engine, inputs, (qs, cs), (gap, extend)), res in zip(runs, results):
        cfg = engine.config
        want_dtype = np.uint64 if name.startswith("lev") else np.int64
        _check(res.dtype == want_dtype and res.shape == (len(qs), len(cs)),
               f"{name}: result {res.dtype} {res.shape}")
        # one block of every query (shifted layout) and one of every
        # candidate, class-mapped on the host for class costs
        to_chars = ((lambda s: b2c[np.frombuffer(s, np.uint8)].tobytes())
                    if cfg.uses_classes else (lambda s: s))
        rows = -(-(max(map(len, qs)) + 1) // 8) * 8
        cand_len = max(map(len, cs))
        qdt = device_tape(Tape.from_strings([to_chars(q) for q in qs]), dev)
        cdt = device_tape(Tape.from_strings([to_chars(c) for c in cs]), dev)
        q_offs, q_lens = qdt.bucket_arrays(np.arange(len(qs)))
        c_offs, c_lens = cdt.bucket_arrays(np.arange(len(cs)))
        packed = (pack_chars(qdt.data, q_offs, q_lens, row_len=rows - 1,
                             transpose=True, fill=0, shift=True), q_lens.view(-1, 1),
                  pack_chars(cdt.data, c_offs, c_lens, row_len=cand_len,
                             transpose=True, fill=0), c_lens.view(1, -1))
        table_t = (torch.from_numpy(cfg.costs.table_np()).to(dev)
                   if cfg.uses_classes else None)
        plain = similarity_reference(*packed, cfg, table_t)
        alone = similarity(*packed, cfg, table_t)
        sync()
        err = max(err, int((alone.long() - plain.long()).abs().max()))
        _check(torch.equal(alone, plain), f"{name}: kernel != plain version")
        _check(np.array_equal(res.astype(np.int64), plain.cpu().numpy()),
               f"{name}: engine result != plain version on the card")
        pick = np.random.default_rng(SEED + 4)
        n_pairs = 3 if cfg.uses_classes else 8
        for i, j in zip(pick.integers(0, len(qs), n_pairs),
                        pick.integers(0, len(cs), n_pairs)):
            a = np.frombuffer(qs[i], np.uint8)
            b = np.frombuffer(cs[j], np.uint8)
            if cfg.uses_classes:
                sub = lambda r, a=a, b=b: padded[b2c[a[r - 1]], b2c[b]]
            else:
                sub = lambda r, a=a, b=b: np.where(b == a[r - 1], cfg.costs.match,
                                                   cfg.costs.mismatch)
            want = _gotoh(a, b, sub, gap, extend, cfg.objective == "max", cfg.is_local)
            _check(int(res.astype(np.int64)[i, j]) == want,
                   f"{name}: pair ({i}, {j}) != the numpy DP")
        print(f"[engine] {name}: {len(qs)}x{len(cs)} equals the plain version "
              f"and the numpy DP on {n_pairs} pairs")

        ql = np.array([len(q) for q in qs], np.float64)
        cl = np.array([len(c) for c in cs], np.float64)
        cells = ql.sum() * cl.sum()
        nbytes = 4.0 * (rows * len(qs) + cand_len * len(cs) + len(qs) * len(cs))
        t0 = time.perf_counter()
        engine_runs = 3
        for _ in range(engine_runs):
            engine(*inputs)
        engine_s = (time.perf_counter() - t0) / engine_runs
        plan = dp_plan(rows, len(qs), cand_len, len(cs), cfg.is_affine,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
        kernel_ms = _time_ms(lambda: similarity(*packed, cfg, table_t), 10, sync)
        plain_ms = _time_ms(lambda: similarity_reference(*packed, cfg, table_t), 1, sync,
                            batches=1)
        _profile(name, lambda: engine(*inputs), sync, kernel_ms)
        bound_ms, bound_by = _bound(_dp_ops_per_cell(cfg) * cells, nbytes)
        unfused_ms = _bound(_dp_ops_per_cell_unfused(cfg) * cells, nbytes)[0]
        kernel = ROUTES[plan.route]
        # the reference's CUDA row (BASELINE.md:34) for the warp route, the
        # weighted lines for the thread route
        if name in ("nw-affine", "lev-weighted"):
            report[kernel] = dict(launches=launches[kernel], ms=kernel_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                                  max_abs_err=err)
        print(f"[perf] {name} rows={rows} cand_len={cand_len} cells={cells:.0f}: "
              f"engine+pull {engine_s * 1e3:.3f} ms = {cells / engine_s / 1e9:.3f} GCUPS; "
              f"kernel ({plan.route} route, {kernel}) {kernel_ms:.4f} ms "
              f"[{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = {cells / kernel_ms / 1e6:.3f} GCUPS; "
              f"plain {plain_ms:.3f} ms = {cells / plain_ms / 1e6:.3f} GCUPS; "
              f"bound {bound_ms:.4f} ms ({bound_by}, {_dp_ops_per_cell(cfg):g} slots a cell), "
              f"{100 * bound_ms / kernel_ms:.1f}% of it; with the unfused count "
              f"({_dp_ops_per_cell_unfused(cfg)} a cell) {unfused_ms:.4f} ms, "
              f"{100 * unfused_ms / kernel_ms:.1f}%")
    for kernel in ROUTES.values():
        report[kernel]["max_abs_err"] = err

    lut_t = torch.from_numpy(b2c).to(dev)
    for name, blob in (("protein candidates' blob", device_tape(prot_ct, dev).data),
                       ("16 MiB", torch.randint(0, 256, (1 << 24,), dtype=torch.uint8,
                                                device=dev))):
        out = torch.empty_like(blob)
        kernel_ms = _time_ms(_raw_launch("sz_lookup", blob.data_ptr(), blob.numel(),
                                         lut_t.data_ptr(), out.data_ptr(), *_launch_env(dev)),
                             100, sync)
        _check(torch.equal(out, lookup_transform(blob, lut_t)),
               f"byte_lut by its raw launch != its wrapper on the {name}")
        plain_ms = _time_ms(lambda: lookup_reference(blob, lut_t), 100, sync)
        library_ms = _time_ms(lambda: lut_t[blob.long()], 100, sync)
        bound_ms, bound_by = _bound(0.0, 2.0 * blob.numel())
        if name.startswith("protein"):
            report["byte_lut"] = dict(
                launches=launches["byte_lut"], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        print(f"[perf] byte_lut on the {name}, {blob.numel()} bytes: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, lut[x.long()] "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


def _wf_pairs(rng, shapes, lo, hi, dev):
    """Pairs of the given shapes, chars drawn from [lo, hi), end to end in
    one int32 device tensor; b is a mutated copy of a on every other pair.
    Returns the tensor and a_off, a_len, b_off, b_len."""
    import torch

    parts, cols = [], []
    pos = 0
    for k, (m, n) in enumerate(shapes):
        a, b = rng.integers(lo, hi, m), rng.integers(lo, hi, n)
        if k % 2 == 0:
            kk = min(m, n)
            b[:kk] = np.where(rng.random(kk) < 0.8, a[:kk], b[:kk])
        parts += [a, b]
        cols.append((pos, m, pos + m, n))
        pos += m + n
    chars = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    return (chars, *np.array(cols, np.int64).T)


def _flat_config(cfg) -> int:
    """The flat kernel's configuration index of an engine config, as
    ``wavefront_batch`` computes it."""
    return (8 * (cfg.objective == "max") + 4 * (cfg.locality == "local") + 2 * cfg.is_affine
            + cfg.uses_classes)


def _check_wavefront_kernel(dev, sync, max_err):
    """Phase 3c: the flat wavefront in all 16 configurations, with costs of
    both signs, against its plain version: pairs at the strip and lane
    edges; in two configurations a batch of more strips than the card holds
    at once (edges too); a split over groups."""
    import torch
    from stringzilla_tpu_torch.ops import wavefront as wf_mod
    from stringzilla_tpu_torch.ops.wavefront import (FLAT_WARPS, config_costs, flat_card,
                                                     flat_plan, wavefront_batch,
                                                     wavefront_reference)

    rng = np.random.default_rng(SEED + 5)
    table = torch.from_numpy(rng.integers(-9, 10, (32, 32)).astype(np.int32)).to(dev)
    shapes = FLAT_EDGES + [(1, 300), (300, 1), (31, 63), (32, 64), (33, 65), (63, 33), (64, 32),
                           (65, 31), (700, 3), (3, 700), (700, 2000), (2500, 1200), (4097, 90),
                           (90, 4097)]
    batches = {  # class ids 0-39 (>= 32 clamp to 31); raw chars 0-3
        True: _wf_pairs(rng, shapes, 0, 40, dev), False: _wf_pairs(rng, shapes, 0, 4, dev)}
    many = FLAT_WIDE_EDGES + [FLAT_MANY[0]] * FLAT_MANY[1]
    wide = {True: _wf_pairs(rng, many, 0, 40, dev), False: _wf_pairs(rng, many, 0, 4, dev)}
    counts = wf_mod.KERNEL_LAUNCHES
    err = 0

    def check(args, kw, what):
        nonlocal err
        before = counts["wavefront_flat"]
        got = wavefront_batch(*args, **kw)
        launched = counts["wavefront_flat"] - before
        want = wavefront_reference(*args, **kw)
        sync()
        err = max(err, int((got.long() - want.long()).abs().max()))
        _check(torch.equal(got, want), f"wavefront kernel != plain version in {what}")
        return launched

    plans = {}
    for k in (0, 1):  # both signs of every cost
        for c, cfg in enumerate(_dp_configs(k)):
            kw = config_costs(cfg, table)
            args = batches[cfg.uses_classes]
            if k == 0 and c in (0, 15):  # min-global-linear-uniform, max-local-affine-classes
                args = _wf_pairs(rng, shapes + WAVEFRONT_BIG, 0, 40 if cfg.uses_classes else 4, dev)
            check(args, kw, f"{cfg}, costs set {k}")
            if k == 0 and c in (0, 15):  # more strips than the card holds
                plan = flat_plan([(int(m), int(n)) for m, n in zip(wide[True][2], wide[True][4])],
                                 cfg.is_affine, *flat_card(dev, _flat_config(cfg)))
                held = plan.groups[0].ctas * FLAT_WARPS
                _check(plan.groups[0].claims > held, f"the wide batch's plan {plan.groups[0]}")
                launched = check(wide[cfg.uses_classes], kw, f"{cfg}, the wide batch")
                _check(launched == len(plan.groups), f"{launched} launches, {plan.groups}")
                plans[str(cfg)] = (plan.groups[0].claims, held)
        print(f"[kernel] wavefront_flat, costs set {k}: 16 configurations exact on "
              f"{len(shapes)} pairs of 1-4097 chars (strip and lane edges), "
              f"{len(WAVEFRONT_BIG)} more of ~{WAVEFRONT_BIG[0][0]} in two"
              + (f"; and two of them on {len(many)} pairs in one launch, strips / warps "
                 f"the grid holds at once {sorted(set(plans.values()))}" if k == 0 else ""))
    # A cap on the hand-off slots below the batch's need splits it into
    # groups, one launch each
    args = batches[True]
    kw = config_costs(cfg, table)
    cap = wf_mod.SCRATCH_CAP_BYTES
    try:
        wf_mod.SCRATCH_CAP_BYTES = FLAT_CAP_BYTES
        plan = flat_plan([(int(m), int(n)) for m, n in zip(args[2], args[4])], cfg.is_affine,
                         *flat_card(dev, _flat_config(cfg)))
        launched = check(args, kw, f"{cfg} under a cap of {FLAT_CAP_BYTES} bytes")
    finally:
        wf_mod.SCRATCH_CAP_BYTES = cap
    _check(launched == len(plan.groups) > 1, f"{launched} launches for {len(plan.groups)} groups")
    print(f"[kernel] wavefront_flat under a {FLAT_CAP_BYTES}-byte cap on its hand-off slots: "
          f"{len(plan.groups)} groups of {[g.pairs for g in plan.groups]} pairs, "
          f"{launched / len(plan.groups):.0f} launch a group, exact")
    max_err["wavefront_flat"] = err


def _band_first(m, n, k0):
    """The band ladder's first half-width for an ``m x n`` pair: ``k0``
    (at least 2), doubled until it reaches ``|m - n|``."""
    k = max(k0, 2)
    while k < abs(m - n):
        k *= 2
    return k


def _check_band_kernel(dev, sync, max_err):
    """Phase 3c, band tier: the band kernel against its plain version (all
    four columns) with tiny and default first rungs, on the card's plan and
    on plans cut to ``BAND_SMALL_CARD`` (turns of persistent groups, the
    circle's ring wrapping from the last CTA to the first), then
    ``levenshtein_batch`` (band, flat for what it does not certify) against
    Wagner-Fischer."""
    import torch
    from stringzilla_tpu_torch.ops.wavefront import (BAND_KMAX, BAND_ROWS, band_batch,
                                                     band_card, band_plan, band_reference,
                                                     levenshtein_batch)

    rng = np.random.default_rng(SEED + 6)
    letters = np.arange(4, dtype=np.uint8)
    strings = []
    for m, rate in BAND_NEAR:  # near-duplicates: ~rate edits a char
        a = rng.choice(letters, m)
        strings += [a, _mutate(rng, a, letters, rate)]
    for m, n in BAND_FAR:  # unrelated pairs
        strings += [rng.choice(letters, m), rng.choice(letters, n)]
    for q in (1, 3):  # m at the edges of q strips of 32 R rows
        for m in (32 * BAND_ROWS * q - 1, 32 * BAND_ROWS * q, 32 * BAND_ROWS * q + 1):
            a = rng.choice(letters, m)
            strings += [a, _mutate(rng, a, letters, 0.02)]
    a = rng.choice(letters, BAND_TAIL[0])
    b = a.copy()
    b[-BAND_TAIL[1]:] = rng.choice(letters, BAND_TAIL[1])
    strings += [a, b]
    lens = np.array([len(x) for x in strings])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32)).to(dev)
    cols = (chars, offs[0::2], lens[0::2], offs[1::2], lens[1::2])
    err, longest = 0, 0
    for k0 in (2, 64):
        rungs = []
        want = band_reference(*cols, k0, rungs=rungs)
        status, last_k = want[:, 1].tolist(), want[:, 2].tolist()
        _check(1 in status and 2 in status, f"band statuses {status}: want 1 and 2")
        _check((1, BAND_KMAX) in zip(status, last_k), f"no pair certified at k = {BAND_KMAX}")
        ladders = collections.Counter(p for p, _, _ in rungs)
        longest = max(longest, max(ladders.values()))
        live = [(int(m), int(n)) for m, n in zip(lens[0::2], lens[1::2])
                if m > 0 and n > 0 and _band_first(int(m), int(n), k0) <= BAND_KMAX]
        seen = []
        for card in [None, *BAND_SMALL_CARD]:
            name = (f"{card[0]} SM{'s' if card[0] > 1 else ''} of {card[1]} warps" if card
                    else "the card's plan")
            got = band_batch(*cols, k0, card=card)
            sync()
            err = max(err, int((got - want).abs().max()))
            _check(torch.equal(got, want), f"band kernel != plain version with k0 = {k0} on "
                                           f"{name}")
            if dev.type == "cuda":  # a CPU rehearsal runs the plain version: no plan
                plan = band_plan(live, *(card or band_card(dev)))
                name += (f": {plan.groups} groups of {plan.group_ctas} CTAs, "
                         f"{-(-len(live) // plan.groups)} turns")
            seen.append(name)
        print(f"[kernel] wavefront_band, k0 = {k0}: exact in all four columns on "
              f"{len(lens) // 2} pairs of 1-{lens.max()} chars (status {status}, last k "
              f"{last_k}, cells {want[:, 3].tolist()}, up to {max(ladders.values())} rungs) "
              f"on {len(seen)} plans (R = {BAND_ROWS}): {'; '.join(seen)}")
    _check(longest >= 3, f"the longest ladder has {longest} rungs")
    dist = levenshtein_batch(*cols).cpu().tolist()
    wf = [_wagner_fischer(strings[2 * p].tobytes(), strings[2 * p + 1].tobytes())
          for p in range(len(dist))]
    _check(dist == wf, f"levenshtein_batch {dist} != Wagner-Fischer {wf}")
    print(f"[kernel] levenshtein_batch (band up to k = {BAND_KMAX}, then flat) equals "
          f"Wagner-Fischer on every pair")
    max_err["wavefront_band"] = err


def _mutate(rng, src, alphabet, rate):
    """A copy of ``src`` with substitutions, deletions and insertions, each
    at ``rate / 3`` a position."""
    r = rng.random(len(src))
    x = src.copy()
    sub = r < rate / 3
    x[sub] = rng.choice(alphabet, int(sub.sum()))
    times = np.where(r < 2 * rate / 3, np.where(sub, 1, 0), np.where(r < rate, 2, 1))
    y = np.repeat(x, times)
    inserted = np.cumsum(times)[times == 2] - 1
    y[inserted] = rng.choice(alphabet, len(inserted))
    return y


def _long_reads(rng):
    """8 x 8 DNA reads of 5,000-15,000 bases, half the candidates mutated
    copies of a query at ~1% edits, then two ~100-base reads a side."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lengths = lambda k: rng.integers(*READ_LENGTHS, k)
    qs = [rng.choice(acgt, int(n)) for n in lengths(READS[0])]
    cs = [_mutate(rng, qs[j % READS[0]], acgt, 0.01) if j % 2 == 0
          else rng.choice(acgt, int(n)) for j, n in enumerate(lengths(READS[1]))]
    qs += [rng.choice(acgt, int(n)) for n in rng.integers(90, 111, 2)]
    cs += [rng.choice(acgt, int(n)) for n in rng.integers(90, 111, 2)]
    return [q.tobytes() for q in qs], [c.tobytes() for c in cs]


def band_batch_strings():
    """Phase 4c's band batch (``BAND_BATCH``): queries and candidates, as
    bytes, each a copy of one lowercase string (seed ``BAND_BATCH_SEED``)
    with random positions flipped by ``^= 1``. Every query against every
    candidate differs by at most twice the flips: two rungs from the
    default first rung of 64."""
    rng = np.random.default_rng(BAND_BATCH_SEED)
    nq, nc, length, flips = BAND_BATCH
    base = rng.integers(97, 123, length).astype(np.uint8)
    copies = []
    for _ in range(nq + nc):
        x = base.copy()
        x[rng.choice(length, flips, replace=False)] ^= 1
        copies.append(x.tobytes())
    return copies[:nq], copies[nq:]


def _band_chain(m, n, k, stop_row):
    """Steps on the critical path of one band rung of half-width ``k``
    (``stop_row`` 0 when it reached cell (m, n)): each strip of 32 * R rows
    trails the one above by 64 R - 1 steps and a chunk, and the last
    walked strip runs its own steps."""
    from stringzilla_tpu_torch.ops.wavefront import BAND_CHUNK, BAND_ROWS

    h = 32 * BAND_ROWS
    strips = -(-(stop_row or m) // h)
    r0, i_last = (strips - 1) * h + 1, min(m, strips * h)
    steps = min(n, i_last + k) - max(0, r0 - k) + (i_last - r0) + 1
    return (strips - 1) * (2 * h - 1 + BAND_CHUNK) + steps


def _wavefront_main_path(dev, sync, report):
    """Phase 4c: pairs over 4096 bytes through the engines."""
    import torch
    from stringzilla_tpu_torch import LevenshteinDistances, NeedlemanWunschScores
    from stringzilla_tpu_torch.ops import memory as memory_mod
    from stringzilla_tpu_torch.ops import similarity_dp as dp_mod
    from stringzilla_tpu_torch.ops import wavefront as wf_mod
    from stringzilla_tpu_torch.ops.wavefront import (band_batch, band_card, band_plan,
                                                     band_reference, config_costs, flat_card,
                                                     flat_plan, wavefront_batch,
                                                     wavefront_reference)
    from tests.oracles import score_affine

    rng = np.random.default_rng(SEED)  # bench_wavefront's draws, in its order
    a = rng.integers(97, 123, LONG_PAIR).astype(np.uint8)
    b = a.copy()
    b[rng.choice(LONG_PAIR, 500, replace=False)] ^= 1
    pair = ([a.tobytes()], [b.tobytes()])
    reads = _long_reads(np.random.default_rng(SEED + 2))
    b2c = np.zeros(256, np.uint8)
    b2c[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dna = np.full((32, 32), -3, np.int32)
    np.fill_diagonal(dna, 2)
    runs = [  # name, engine, inputs
        ("long pair", LevenshteinDistances(), pair),
        ("band batch", LevenshteinDistances(), band_batch_strings()),
        ("long reads", NeedlemanWunschScores(b2c, dna, open=-7, extend=-2), reads),
    ]
    counters = (wf_mod.KERNEL_LAUNCHES, dp_mod.KERNEL_LAUNCHES, memory_mod.KERNEL_LAUNCHES)
    sync()
    _reset(*counters)
    results = [engine(*inputs) for _, engine, inputs in runs]
    launches = {k: v for counts in counters for k, v in counts.items()}
    print(f"[engine] launches on the long-pair main path: {launches}")
    for k in ("wavefront_band", "wavefront_flat", "byte_lut"):  # stage: 4g
        _check(launches[k] > 0, f"{k} was not launched on the main path")
    # the short reads' 2 x 2 pairs: the column DP on the route its plan picks
    _check(launches["similarity_dp"] + launches["similarity_dp_warp"] > 0,
           "the column DP was not launched on the main path")

    for (name, engine, (qs, cs)), res in zip(runs, results):
        cfg = engine.config
        _check(res.shape == (len(qs), len(cs)) and np.isfinite(res).all(),
               f"{name}: result {res.dtype} {res.shape}")
        # every long pair through the kernel alone and the plain version,
        # from class-mapped chars built on the host
        to_ids = (lambda s: b2c[np.frombuffer(s, np.uint8)]) if cfg.uses_classes \
            else (lambda s: np.frombuffer(s, np.uint8))
        ql = np.array([len(q) for q in qs])
        cl = np.array([len(c) for c in cs])
        qi, cj = np.nonzero((ql[:, None] > 4096) | (cl[None, :] > 4096))
        strings = [to_ids(q) for q in qs] + [to_ids(c) for c in cs]
        offs = np.concatenate([[0], np.cumsum([len(x) for x in strings])[:-1]])
        chars = torch.from_numpy(np.concatenate(strings).astype(np.int32)).to(dev)
        packed = (chars, offs[qi], ql[qi], offs[len(qs) + cj], cl[cj])
        kw = config_costs(cfg, torch.from_numpy(dna).to(dev))
        band = name != "long reads"  # unit costs: the band kernel
        kernel = "wavefront_band" if band else "wavefront_flat"
        call = (lambda: band_batch(*packed)) if band else (lambda: wavefront_batch(*packed, **kw))
        rungs = []
        alone = call()
        if name == "band batch":
            # The plain version takes minutes on all 64 pairs: it runs on
            # the first and the last, all four columns; every distance is
            # held against the flat kernel
            t0 = time.perf_counter()
            flat = wavefront_batch(*packed)
            sync()
            flat_ms = (time.perf_counter() - t0) * 1e3
            ends = [0, len(qi) - 1]
            t0 = time.perf_counter()
            few = band_reference(chars, *(x[ends] for x in packed[1:]))
            sync()
            few_ms = (time.perf_counter() - t0) * 1e3
            _check(torch.equal(alone[ends], few),
                   f"{name}: kernel {alone[ends].tolist()} != plain version {few.tolist()}")
            _check(bool((alone[:, 1] == 1).all()), f"{name}: band status {alone[:, 1]}")
            err = max(int((alone[:, 0] - flat.long()).abs().max()),
                      int((alone[ends] - few).abs().max()))
            _check(err == 0, f"{name}: band distances != the flat kernel's")
            plain, plain_ms = alone, None
        else:
            t0 = time.perf_counter()
            plain = (band_reference(*packed, rungs=rungs) if band
                     else wavefront_reference(*packed, **kw))
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = int((alone.long() - plain.long()).abs().max())
            _check(torch.equal(alone, plain), f"{name}: kernel != plain version")
        scores = plain
        if band:
            scores = plain[:, 0]
            _check(bool((plain[:, 1] == 1).all()), f"{name}: band status {plain[:, 1]}")
        _check(np.array_equal(res.astype(np.int64)[qi, cj], scores.cpu().numpy()),
               f"{name}: engine result != plain version on the card")
        if name == "long pair":
            _check(int(res[0, 0]) == 500, f"{name}: distance {res[0, 0]} != 500 flips")
            checked = (f"and the 500 flips (band: last k {int(plain[0, 2])}, "
                       f"{int(plain[0, 3])} band cells walked, rungs (k, stop row) "
                       f"{[(k, r) for _, k, r in rungs]})")
        elif band:
            checked = (f"the flat kernel's distances (up to {int(plain[:, 0].max())}; last k "
                       f"{sorted(set(plain[:, 2].tolist()))}; the flat kernel {flat_ms:.3f} ms "
                       f"with its launches), and the plain version in all four columns on "
                       f"pairs {ends} ({few.tolist()}, {few_ms:.3f} ms)")
        else:
            sub = lambda x, y: int(dna[b2c[x], b2c[y]])
            short_long = sorted(((i, j) for i, j in zip(qi, cj) if min(ql[i], cl[j]) < 200),
                                key=lambda ij: ql[ij[0]] * cl[ij[1]])[:2]
            for i, j in short_long + [(i, j) for i in range(len(qs)) for j in range(len(cs))
                                      if max(ql[i], cl[j]) < 200]:
                _check(int(res[i, j]) == score_affine(qs[i], cs[j], sub, -7, -2),
                       f"{name}: pair ({i}, {j}) != the Gotoh oracle")
            qa, cb = np.frombuffer(qs[0], np.uint8), np.frombuffer(cs[0], np.uint8)
            padded = np.zeros((33, 33), np.int64)
            padded[:32, :32] = dna
            _check(int(res[0, 0]) == _gotoh(qa, cb, lambda r: padded[b2c[qa[r - 1]], b2c[cb]],
                                            -7, -2, True, False),
                   f"{name}: pair (0, 0) != the numpy Gotoh DP")
            checked = "and the Gotoh oracle on 2 short x long and the short x short pairs"
        print(f"[engine] {name}: {len(qs)}x{len(cs)}, {len(qi)} long pairs, equal "
              f"{'the plain version ' if plain_ms is not None else ''}{checked}")

        # GCUPS count the pairs' whole matrices; the band's bound counts
        # only band cells: those its rungs walked on this data, as the plain
        # version counted them, or for the batch, whose plain version ran on
        # two pairs, those of the rung that certifies each verified distance
        cells = float((ql[qi] * cl[cj]).sum())
        if name == "band batch":
            work = float(sum(_certifying_rung_cells(int(ql[i]), int(cl[j]), int(d))
                             for i, j, d in zip(qi, cj, flat.tolist())))
        else:
            work = float(plain[:, 3].sum()) if band else cells
        nbytes = 4.0 * (ql[qi].sum() + cl[cj].sum()) + (32.0 if band else 4.0) * len(qi)
        engine_runs = 3
        t0 = time.perf_counter()
        for _ in range(engine_runs):
            engine._device_scores(qs, cs)
            sync()
        device_s = (time.perf_counter() - t0) / engine_runs
        t0 = time.perf_counter()
        for _ in range(engine_runs):
            engine(qs, cs)
        engine_s = (time.perf_counter() - t0) / engine_runs
        kernel_ms = _time_ms(call, 5, sync)
        _profile(name, lambda: engine(qs, cs), sync, kernel_ms)
        bound_ms, bound_by = _bound(_dp_ops_per_cell(cfg) * work, nbytes)
        unfused_ms = _bound(_dp_ops_per_cell_unfused(cfg) * work, nbytes)[0]
        bound = (f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.2f}% of "
                 f"it; with the unfused count {unfused_ms:.4f} ms, "
                 f"{100 * unfused_ms / kernel_ms:.2f}%")
        if name != "band batch":
            report[kernel] = dict(
                launches=launches[kernel], ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, max_abs_err=err)
        print(f"[perf] {name} cells={cells:.0f} bound-cells={work:.0f}"
              + f": {kernel} {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = "
              f"{cells / kernel_ms / 1e6:.3f} GCUPS; engine to device "
              f"result {device_s * 1e3:.3f} ms = {cells / device_s / 1e9:.3f} GCUPS; "
              f"engine+pull {engine_s * 1e3:.3f} ms = {cells / engine_s / 1e9:.3f} GCUPS; "
              + (f"plain {plain_ms:.3f} ms = {cells / plain_ms / 1e6:.3f} GCUPS; "
                 if plain_ms is not None else "plain on all pairs not run; ")
              + bound)
        if dev.type != "cuda":  # a CPU rehearsal runs the plain version: no plan
            continue
        if not band:  # the flat kernel's plan: one launch a group
            pairs = [(int(ql[i]), int(cl[j])) for i, j in zip(qi, cj)]
            card = flat_card(dev, _flat_config(cfg))
            plan_s = []
            for _ in range(21):
                t0 = time.perf_counter()
                plan = flat_plan(pairs, cfg.is_affine, *card)
                plan_s.append(time.perf_counter() - t0)
            before = wf_mod.KERNEL_LAUNCHES["wavefront_flat"]
            call()
            print(f"[perf] {name}: wavefront_flat plan R = {wf_mod.FLAT_ROWS}, "
                  f"{sum(plan.strips)} strips of {32 * wf_mod.FLAT_ROWS} rows in "
                  f"{len(plan.groups)} group(s) of {[g.ctas for g in plan.groups]} CTAs "
                  f"(the card holds {plan.ctas_per_sm} an SM); "
                  f"{wf_mod.KERNEL_LAUNCHES['wavefront_flat'] - before} launch(es) a call; "
                  f"flat_plan {1e3 * float(np.median(plan_s)):.4f} ms of host time "
                  f"(median of 21)")
            continue
        # The band kernel's plan, for the long pair the model's chain (steps
        # on the critical path), and the flat kernel on the same pairs
        plan = band_plan([(int(ql[i]), int(cl[j])) for i, j in zip(qi, cj)], *band_card(dev))
        line = (f"[perf] {name}: wavefront_band plan R = {plan.rows_per_lane}, a circle of "
                f"{plan.warps} warps in {plan.group_ctas} CTAs a pair, {plan.groups} groups, "
                f"{plan.ctas} CTAs")
        if name == "long pair":
            chain = sum(_band_chain(LONG_PAIR, LONG_PAIR, k, stop) for _, k, stop in rungs)
            line += (f"; {chain} chain steps over {len(rungs)} rungs, "
                     f"{kernel_ms * 1e3 / chain:.4f} us a step")
        print(line)
        flat_ms = _time_ms(lambda: wavefront_batch(*packed), 3, sync)
        flat_bound = _bound(_dp_ops_per_cell(cfg) * cells, nbytes)[0]
        plan = flat_plan([(int(ql[i]), int(cl[j])) for i, j in zip(qi, cj)], False,
                         *flat_card(dev, 0))
        print(f"[perf] {name}: wavefront_flat on the same pairs {flat_ms:.4f} ms "
              f"[{flat_ms.lo:.4f}-{flat_ms.hi:.4f}] = {cells / flat_ms / 1e6:.3f} GCUPS, "
              f"{flat_ms / kernel_ms:.2f}x the band's time; R = {wf_mod.FLAT_ROWS}, "
              f"{sum(plan.strips)} strips, {len(plan.groups)} launch(es); bound on every "
              f"cell {flat_bound:.4f} ms (operations), {100 * flat_bound / flat_ms:.2f}% of it")


def _fp_inputs(dev, docs):
    """``fingerprint_all``'s device inputs: the docs end to end, plus one
    zero byte, and each doc's start and length."""
    import torch

    lens = np.array([len(d) for d in docs], np.int64)
    starts = np.zeros(len(docs), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    blob = np.frombuffer(b"".join(docs) + b"\0", np.uint8).copy()
    return (torch.from_numpy(blob).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(lens).to(dev))


def _fp_params(dev, ndim, widths, seed):
    """``derive_params``' parameters as ``kernel_params`` makes them on ``dev``."""
    from stringzilla_tpu_torch.ops.fingerprints import derive_params
    from stringzilla_tpu_torch.ops.fingerprints_kernel import kernel_params

    return kernel_params(derive_params(ndim, widths, seed), dev)


def _fp_split_err(got, want, whole):
    """Largest difference between two ``minhash_ranges`` results (the
    rows of whole documents, the partial slots), or between two merged
    ``(hashes, counts)`` when ``whole`` is None."""
    if whole is not None:
        got = (got[0][whole], got[1][whole], *got[2:])
        want = (want[0][whole], want[1][whole], *want[2:])
    return max([0] + [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
                      if g.numel()])


def _fp_split_check(name, docs, params, units, dev, sync, max_err, oracle=()):
    """Both MinHash kernels on ``docs`` cut at each of ``units``:
    ``minhash_ranges`` against ``ranges_reference`` (whole documents' rows
    and every partial slot), ``minhash_merge`` against ``merge_reference``
    on the kernel's own partials, the merged results of every unit equal;
    then against ``fingerprint_reference`` (on documents of up to 4 KB: it
    steps byte by byte, seconds a 64 KB document) and, on the docs at
    ``oracle``, the numpy oracle. Exact."""
    import torch
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fk
    from stringzilla_tpu_torch.ops.fingerprints import fingerprint_oracle

    blob, starts, lens = _fp_inputs(dev, docs)
    first = None
    for unit in units:
        plan = fk.minhash_plan(lens.cpu().numpy(), unit)
        pa = fk.plan_arrays(plan, starts.cpu().numpy(), dev)
        got = fk.minhash_ranges(blob, pa, params)
        want = fk.ranges_reference(blob, pa, params)
        sync()
        whole = torch.from_numpy(np.isin(np.arange(len(docs)), plan.cut_docs,
                                         invert=True)).to(dev)
        err = _fp_split_err(got, want, whole)
        _check(err == 0, f"fingerprint_minhash != plain version on {name} at unit {unit}")
        merged = fk.minhash_merge(pa, got[2], got[3], got[0].clone(), got[1].clone())
        plain = fk.merge_reference(pa, got[2], got[3], got[0].clone(), got[1].clone())
        sync()
        merge_err = _fp_split_err(merged, plain, None)
        _check(merge_err == 0, f"fingerprint_merge != plain version on {name} at unit {unit}")
        if first is None:
            first = merged
        _check(all(torch.equal(g, w) for g, w in zip(merged, first)),
               f"fingerprint kernels on {name}: unit {unit} != unit {units[0]}")
        print(f"[kernel] fingerprint_minhash + fingerprint_merge {name}: {len(docs)} docs of "
              f"{min(map(len, docs))}-{max(map(len, docs))} bytes x {params['width'].numel()} "
              f"dims at unit {unit}: {len(plan.out)} pieces, {len(plan.cut_docs)} cut docs in "
              f"{int(plan.cut_first[-1])} ranges, {len(plan.cta_first) - 1} CTAs; both equal "
              f"their plain versions")
        max_err["fingerprint_minhash"] = max(max_err.get("fingerprint_minhash", 0), err)
        max_err["fingerprint_merge"] = max(max_err.get("fingerprint_merge", 0), merge_err)
    if max(map(len, docs)) <= 4096:
        ref = fk.fingerprint_reference(blob, starts, lens, params)
        _check(all(torch.equal(g, w) for g, w in zip(first, ref)),
               f"fingerprint kernels != fingerprint_reference on {name}")
    host = {k: v.cpu().numpy() for k, v in params.items() if k != "kernel"}
    for i in oracle:
        oh, oc = fingerprint_oracle(docs[i], host)
        _check(np.array_equal(first[0][i].cpu().numpy().view(np.uint32), oh)
               and np.array_equal(first[1][i].cpu().numpy().view(np.uint32), oc),
               f"fingerprint kernels != numpy oracle on {name} doc {i}")
    print(f"[kernel] fingerprint kernels on {name}: exact at every unit"
          f"{', against fingerprint_reference' if max(map(len, docs)) <= 4096 else ''}"
          f" and the numpy oracle on {len(oracle)} docs")


def _check_fingerprint_kernel(dev, sync, max_err):
    """Phase 3d: the MinHash kernels against their plain versions, the
    golden vectors and the numpy oracle; then cut documents at the plan's
    unit edges."""
    import torch
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fk
    from stringzilla_tpu_torch.ops.fingerprints import (DEFAULT_WINDOW_WIDTHS, derive_params,
                                                        fingerprint_oracle)
    from stringzilla_tpu_torch.ops.fingerprints_kernel import (fingerprint_all,
                                                               fingerprint_reference)

    rng = np.random.default_rng(SEED + 5)
    short = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in
             (0, 1, 2, 3, 30, 31, 32, 0, 100, 1999, 2000, 2001, 4095, 4096, 4097, 5000)]
    big = [rng.integers(32, 127, 65536, dtype=np.uint8).tobytes() for _ in range(FP_BIG - 1)]
    big.append(b"ab" * 32768)  # every window ties with the minimum of its phase
    cases = [  # name, ndim, widths, seed, docs
        ("default widths", 256, None, 42, short),
        ("widths 1/3/31 over 100 dims", 100, (1, 3, 31), 5, short),
        ("width 2000", 64, (3, 2000), 1, short),
        ("widths 64/1024/1025 (the widest halo and past it)", 64, (64, 1024, 1025), 3, short),
        ("64 KB docs", 100, (1, 3, 31), 7, big),
    ]
    err = 0
    for name, ndim, widths, seed, docs in cases:
        args = (*_fp_inputs(dev, docs), _fp_params(dev, ndim, widths, seed))
        got = fingerprint_all(*args)
        want = fingerprint_reference(*args)
        sync()
        err = max(err, *(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)))
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"fingerprint kernel != plain version in case {name}")
        params = derive_params(ndim, widths, seed)
        for i in (1, 5, len(docs) - 1) if docs is short else ():
            oh, oc = fingerprint_oracle(docs[i], params)
            _check(np.array_equal(got[0][i].cpu().numpy().view(np.uint32), oh)
                   and np.array_equal(got[1][i].cpu().numpy().view(np.uint32), oc),
                   f"fingerprint kernel != numpy oracle on doc {i} in case {name}")
        print(f"[kernel] fingerprint_minhash {name}: {len(docs)} docs of "
              f"{min(map(len, docs))}-{max(map(len, docs))} bytes x {ndim} dims exact")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                           "fingerprint_vectors.json")) as f:
        golden = json.load(f)
    groups = {}
    for case in golden:
        groups.setdefault((case["seed"], case["nwidths"]), []).append(case)
    for (seed, nw), group in sorted(groups.items()):
        docs = [bytes(case["doc"]) for case in group]
        h, c = fingerprint_all(*_fp_inputs(dev, docs),
                               _fp_params(dev, 64 * nw, DEFAULT_WINDOW_WIDTHS[:nw], seed))
        h, c = h.cpu().numpy().view(np.uint32), c.cpu().numpy().view(np.uint32)
        for i, case in enumerate(group):
            _check(h[i].tolist() == case["hashes"] and c[i].tolist() == case["counts"],
                   f"fingerprint kernel != golden vector seed {seed} widths {nw} "
                   f"doc of {len(case['doc'])} bytes")
    print(f"[kernel] fingerprint_minhash: all {len(golden)} golden vectors exact")
    max_err["fingerprint_minhash"] = max(max_err.get("fingerprint_minhash", 0), err)

    # The cut: documents at the unit the card's plan takes for them (- 1,
    # at it, + 31: one range more, its last one short of the widest
    # window), through fingerprint_all and through both kernels at that unit;
    # a 64 KB b"ab" document cut into many ranges under widths 1 and 2 (ties
    # whose counts add across every cut); width 2000 on a cut document (a
    # warm-up longer than its ranges).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" \
        else 132
    edge = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (fk.UNIT_MIN - 1, fk.UNIT_MIN, fk.UNIT_MIN + 31) * 3]
    unit = fk.minhash_unit([len(d) for d in edge], sms)
    _check(unit == fk.UNIT_MIN, f"the unit edge case's unit is {unit}, not {fk.UNIT_MIN}")
    params = _fp_params(dev, 256, None, 42)
    args = (*_fp_inputs(dev, edge), params)
    got, want = fingerprint_all(*args), fingerprint_reference(*args)
    sync()
    _check(all(torch.equal(g, w) for g, w in zip(got, want)),
           "fingerprint_all != plain version on documents at the unit's edges")
    _fp_split_check("unit - 1, unit, unit + 31", edge, params, [unit], dev, sync, max_err,
                    oracle=(0, 1, 2))
    ab = [b"ab" * 32768]
    for widths in ((1,), (2,)):
        params = _fp_params(dev, 64, widths, 9)
        _fp_split_check(f"64 KB b'ab' widths {widths}", ab, params, [fk.UNIT_MIN, 97], dev,
                        sync, max_err, oracle=(0,))
    wide = [rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(), b"xy" * 700]
    params = _fp_params(dev, 64, (3, 2000), 1)
    _fp_split_check("width 2000, cut", wide, params, [4096], dev, sync, max_err, oracle=(0,))
    params = _fp_params(dev, 64, (64, 512), 4)  # a halo of 512 bytes
    _fp_split_check("widths 64/512, cut", wide, params, [4096, 600], dev, sync, max_err,
                    oracle=(0,))


def _rune_block(rng, q_lens, c_lens, rows, cand_len, alphabet):
    """``_block``'s layouts over the runes of ``alphabet``: query padding
    stays -1."""
    q_t, ql, c_t, cl = _block(rng, q_lens, c_lens, rows, cand_len, 0, len(alphabet))
    alphabet = np.asarray(alphabet, np.int32)
    return np.where(q_t >= 0, alphabet[q_t.clip(0)], -1).astype(np.int32), ql, alphabet[c_t], cl


CJK = np.arange(0x4E00, 0x4E00 + 3000)


def _same_home(count, words, home=5):
    """``count`` runes that share one home slot of the rune hash table of a
    block of ``words`` words."""
    from stringzilla_tpu_torch.ops import myers as myers_mod

    runes = np.arange(1 << 22, dtype=np.int64)
    runes = runes[myers_mod._home(runes, myers_mod.rune_table_bits(words)) == home]
    return runes[:count].astype(np.int32)


INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
EXTREME_RUNES = np.array([0, -1, -5, INT32_MIN, INT32_MAX, 0x10FFFF], np.int32)


def _check_rune_myers_kernel(dev, sync, max_err):
    """Phase 3d: both Myers tiers' rune route against their plain version
    and Wagner-Fischer."""
    import torch
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference, words_of
    from tests.oracles import levenshtein

    rng = np.random.default_rng(SEED + 6)
    # U+0000, 4-byte runes (U+10000.., emoji), Latin and CJK
    mixed = np.concatenate([[0], np.arange(0x10000, 0x10040), np.arange(0x1F600, 0x1F640),
                            np.arange(97, 123), CJK[:600]])
    extremes = np.concatenate([EXTREME_RUNES, CJK[:40]])
    wide = np.arange(0x4E00 - 1000, 0x4E00 + 3096)  # 4,096 distinct runes
    cases = [  # name, query lengths, candidate lengths, rows, cand_len, runes
        ("runes w1", [1, 17, 64, 0], rng.integers(0, 101, 300), 64, 100, mixed[:40]),
        ("runes w1 wide", [1, 64, 60, 50, 64], rng.integers(0, 101, 300), 64, 100, mixed),
        ("runes w4", [256, 255, 1, 64], rng.integers(0, 301, 300), 256, 300, CJK),
        ("runes w5", [257, 300, 64], rng.integers(0, 400, 64), 320, 400, mixed),
        ("runes w64", [4096, 4000, 257, 1], rng.integers(0, 4097, 24), 4096, 4096, CJK),
        ("runes mixed words", MIXED_WORD_QUERIES, rng.integers(0, 1201, 37), 4096, 1200, CJK),
        # the fullest tables: a query of 256 distinct runes (tier A, 512
        # slots) and one of 4,096 (tier B, 8,192 slots, 64 KB)
        ("runes 256 distinct", [256, 200, 256], rng.integers(0, 301, 300), 256, 300, CJK[:256]),
        ("runes 4096 distinct", [4096, 3000, 64], rng.integers(0, 4097, 24), 4096, 4096, wide),
        # -1, 0, INT32_MIN and INT32_MAX as candidate runes, a query with
        # U+0000 and one without, in each tier
        ("runes extremes w2", [64, 100, 128, 7], rng.integers(0, 129, 300), 128, 128, extremes),
        ("runes extremes w5", [300, 257, 320], rng.integers(0, 321, 64), 320, 320, extremes),
        # runes that all share one home slot: the longest probes
        ("runes colliding w4", [256, 255, 30], rng.integers(0, 301, 300), 256, 300,
         _same_home(256, 4)),
        ("runes colliding w5", [320, 300, 5], rng.integers(0, 321, 64), 320, 320,
         _same_home(320, 5)),
    ]
    for name, q_lens, c_lens, rows, cand_len, runes in cases:
        q_t, ql, c_t, cl = _rune_block(rng, q_lens, c_lens, rows, cand_len, runes)
        c_t[:2, 1] = [0, -1]  # U+0000 matches; the padding value is a rune like any
        if "distinct" in name or "colliding" in name:  # query 0 holds every rune once
            q_t[: q_lens[0], 0] = rng.permutation(runes)[: q_lens[0]]
        if "extremes" in name:
            q_t[0, 0] = 0  # query 0 holds U+0000, query 1 does not
            q_t[: q_lens[1], 1] = np.where(q_t[: q_lens[1], 1] == 0, CJK[0], q_t[: q_lens[1], 1])
            for j in range(0, len(c_lens), 3):
                c_t[: min(4, cl[0, j]), j] = [-1, 0, INT32_MIN, INT32_MAX][: min(4, cl[0, j])]
        args = [torch.from_numpy(x).to(dev) for x in (q_t, ql, c_t, cl)]
        want = myers_reference(*args, alphabet=None)
        tier = ("myers_tier_a" if words_of(rows) <= 4 else "myers_tier_b") + "_runes"
        distinct = [len(np.unique(q_t[:m, i])) for i, m in enumerate(q_lens)]
        in_block = len(np.unique(np.concatenate([q_t[:m, i] for i, m in enumerate(q_lens)])))
        for seg, got in _each_segment(rows, lambda: myers(*args, alphabet=None)):
            sync()
            err = int((got.long() - want.long()).abs().max())
            max_err[tier] = max(max_err.get(tier, 0), err)
            lanes = f" S={seg}" if seg else ""
            print(f"[kernel] {name:19s} {tier}{lanes} rows={rows} cand_len={cand_len} "
                  f"{len(q_lens)}x{len(c_lens)}, {in_block} distinct runes in the block, at most "
                  f"{max(distinct)} a query, max_abs_err={err}")
            _check(torch.equal(got, want), f"rune kernel != plain version in case {name}{lanes}")
        res = got.cpu().numpy()
        # tests/oracles.py's Wagner-Fischer is pure Python: the numpy one
        # takes the 4096-rune queries
        wf = levenshtein if rows <= 320 else _wagner_fischer
        for i, j in [(0, 0), (0, 1), (len(q_lens) - 1, 2), (1, len(c_lens) - 1)]:
            _check(res[i, j] == wf(q_t[: ql[i, 0], i], c_t[: cl[0, j], j]),
                   f"{name}: pair ({i}, {j}) != Wagner-Fischer")


def _fingerprint_main_path(dev, sync, report):
    """Phase 4d: ``Fingerprints`` on lines and on web-page-sized docs."""
    import torch
    from stringzilla_tpu_torch import Fingerprints, Tape
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fp_mod
    from stringzilla_tpu_torch.ops.fingerprints import band_keys, fingerprint_oracle
    from stringzilla_tpu_torch.ops.fingerprints_kernel import (fingerprint_all,
                                                               fingerprint_reference)
    from stringzilla_tpu_torch.ops.pack_device import device_tape

    lines, pages = _fp_workloads()
    engine = Fingerprints(ndim=256, seed=42)
    sync()
    _reset(fp_mod.KERNEL_LAUNCHES)
    results = [engine(lines), engine(pages)]
    launches = dict(fp_mod.KERNEL_LAUNCHES)
    print(f"[engine] launches on the fingerprints main path: {launches}")
    for k in launches:
        _check(launches[k] > 0, f"{k} was not launched on the fingerprints main path")

    for (name, docs, n_oracle), (h, c) in zip(
            (("fingerprints-lines", lines, 16), ("fingerprints-docs", pages, 2)), results):
        _check(h.dtype == c.dtype == np.uint32 and h.shape == c.shape == (len(docs), 256),
               f"{name}: result {h.dtype} {h.shape}")
        dt = device_tape(Tape.from_strings(docs), dev)
        params = engine._params_on(dev)
        args = (dt.data, torch.from_numpy(dt.starts), torch.from_numpy(dt.lengths), params)
        # the plain version is timed on this one call: it takes seconds
        sync()
        t0 = time.perf_counter()
        plain = fingerprint_reference(*args)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _check(np.array_equal(h, plain[0].cpu().numpy().view(np.uint32))
               and np.array_equal(c, plain[1].cpu().numpy().view(np.uint32)),
               f"{name}: engine result != plain version on the card")
        for i in np.random.default_rng(SEED + 8).integers(0, len(docs), n_oracle):
            oh, oc = fingerprint_oracle(docs[i], engine._params)
            _check(np.array_equal(h[i], oh) and np.array_equal(c[i], oc),
                   f"{name}: doc {i} != the numpy oracle")
        print(f"[engine] {name}: {len(docs)} docs equal the plain version and the numpy "
              f"oracle on {n_oracle} docs")

        # Each kernel at the main path's shapes against its plain version,
        # from the card's plan, with the parameters prepared once; then
        # timed by raw launches (the kernel alone) beside the wrapper.
        sms, stream = _launch_env(dev)
        plan = fp_mod.minhash_plan(dt.lengths, fp_mod.minhash_unit(
            dt.lengths, sms, params["kernel"].widest))
        pa = fp_mod.plan_arrays(plan, dt.starts, dev)
        got = fp_mod.minhash_ranges(dt.data, pa, params)
        t0 = time.perf_counter()
        want = fp_mod.ranges_reference(dt.data, pa, params)
        sync()
        ranges_plain_ms = (time.perf_counter() - t0) * 1e3
        whole = torch.from_numpy(np.isin(np.arange(len(docs)), plan.cut_docs,
                                         invert=True)).to(dev)
        ranges_err = _fp_split_err(got, want, whole)
        _check(ranges_err == 0, f"{name}: fingerprint_minhash != plain version")
        merged = fp_mod.minhash_merge(pa, got[2], got[3], got[0].clone(), got[1].clone())
        t0 = time.perf_counter()
        merged_plain = fp_mod.merge_reference(pa, got[2], got[3], got[0].clone(),
                                              got[1].clone())
        sync()
        merge_plain_ms = (time.perf_counter() - t0) * 1e3
        merge_err = _fp_split_err(merged, merged_plain, None)
        _check(merge_err == 0, f"{name}: fingerprint_merge != plain version")
        _check(np.array_equal(merged[0].cpu().numpy().view(np.uint32), h),
               f"{name}: the two kernels' result != the engine's")
        print(f"[kernel] {name}: plan unit {plan.unit}, {len(plan.out)} pieces, "
              f"{len(plan.cta_first) - 1} CTAs, {len(plan.cut_docs)} cut docs in "
              f"{pa.n_slots} ranges; fingerprint_minhash and fingerprint_merge equal their "
              f"plain versions")

        total = float(sum(map(len, docs)))
        hashes = total * 256  # (doc, dimension, byte) steps
        runs = 3

        def host_ms(fn):
            sync()
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            sync()
            return (time.perf_counter() - t0) / runs * 1e3

        engine_ms = host_ms(lambda: engine(docs))
        device_ms = host_ms(lambda: engine(docs, device_out=True))
        bands_ms = host_ms(lambda: band_keys(engine(docs, device_out=True)[0], bands=16))
        ints, floats, halo, _ = params["kernel"]
        f = floats.data_ptr()
        out_h, out_c, part_min, part_count = got
        kernel_ms = _time_ms(_raw_launch(
            "sz_fingerprints", dt.data.data_ptr(), pa.pieces.data_ptr(),
            pa.cta_first.data_ptr(), pa.cta_first.numel() - 1, ints[0].data_ptr(),
            ints[1].data_ptr(), f, f + 8 * 256, f + 16 * 256, f + 24 * 256, 256, halo,
            out_h.data_ptr(), out_c.data_ptr(), part_min.data_ptr(), part_count.data_ptr(),
            stream), 10, sync)
        n_cut = len(plan.cut_docs)
        merge = _raw_launch(
            "sz_fingerprints_merge", pa.cut.data_ptr(), n_cut, part_min.data_ptr(),
            part_count.data_ptr(), 256, out_h.data_ptr(), out_c.data_ptr(), stream)
        # On the main path the merge finds its partials in L2, just written
        # by fingerprint_minhash (warm); its bound counts them read from HBM,
        # so it is held to that bound with L2 flushed before each launch
        merge_warm_ms = _time_ms(merge, 10, sync) if n_cut else None
        merge_ms = _time_cold_ms(merge, 10, sync, dev) if n_cut else None
        wrapper_ms = _time_ms(lambda: fingerprint_all(*args), 10, sync)
        _profile(name, lambda: engine(docs), sync, kernel_ms)
        if name == "fingerprints-docs":  # its trace is often lost (PERF.md §7)
            _profile(name + " (again)", lambda: engine(docs), sync, kernel_ms)
        ops_ms = FINGERPRINT_OPS_PER_STEP * hashes / F64_OPS_PER_S * 1e3
        ops10_ms = 10 * hashes / F64_OPS_PER_S * 1e3
        bytes_ms = (total + 16.0 * len(docs) + 8.0 * 256 * len(docs)) / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
        if name == "fingerprints-lines":
            report["fingerprint_minhash"] = dict(
                launches=launches["fingerprint_minhash"], ms=kernel_ms,
                plain_ms=ranges_plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, max_abs_err=ranges_err)
        merge_note = "no cut document"
        if merge_ms is not None:
            # the merge reads each slot's minimum and count once and writes
            # each cut document's row once, here from and to HBM
            merge_bound = (12.0 * pa.n_slots + 8.0 * n_cut) * 256 / HBM_BYTES_PER_S * 1e3
            merge_note = (f"merge {merge_ms:.4f} ms [{merge_ms.lo:.4f}-{merge_ms.hi:.4f}] with "
                          f"L2 flushed before each launch, {merge_warm_ms:.4f} ms "
                          f"[{merge_warm_ms.lo:.4f}-{merge_warm_ms.hi:.4f}] with its partials "
                          f"in L2 as on the main path, on {n_cut} docs of {pa.n_slots} ranges, "
                          f"plain {merge_plain_ms:.3f} ms, bound {merge_bound:.4f} ms (bytes "
                          f"from HBM), {100 * merge_bound / merge_ms:.1f}% of it flushed")
            report["fingerprint_merge"] = dict(
                launches=launches["fingerprint_merge"], ms=merge_ms, plain_ms=merge_plain_ms,
                bound_ms=merge_bound, bound_by="bytes", library_ms=None, max_abs_err=merge_err)
        print(f"[perf] {name} {len(docs)} docs, {total:.0f} bytes x 256 dims: "
              f"kernel {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = "
              f"{hashes / kernel_ms / 1e6:.3f} Ghash/s (raw launch, parameters and plan made "
              f"once); {merge_note}; fingerprint_all {wrapper_ms:.4f} ms "
              f"[{wrapper_ms.lo:.4f}-{wrapper_ms.hi:.4f}] (plan, its upload and both "
              f"launches); engine to device_out {device_ms:.3f} ms = "
              f"{hashes / device_ms / 1e6:.3f} Ghash/s; "
              f"device_out + band_keys(16) {bands_ms:.3f} ms; "
              f"engine+pull {engine_ms:.3f} ms = {hashes / engine_ms / 1e6:.3f} Ghash/s; "
              f"plain {plain_ms:.3f} ms, the plain range version {ranges_plain_ms:.3f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}, {FINGERPRINT_OPS_PER_STEP} f64 "
              f"instructions a step), {100 * bound_ms / kernel_ms:.1f}% of it; at 10 a step "
              f"{ops10_ms:.4f} ms, {100 * ops10_ms / kernel_ms:.1f}%")


def _fp_workloads():
    """Phase 4d's fingerprint documents: ``bench_fingerprints``' lines and
    web-page-sized docs."""
    def docs_of(rng, count, lo, hi):
        lens = rng.integers(lo, hi, count)
        chars = rng.integers(32, 127, int(lens.sum()), dtype=np.uint8).tobytes()
        ends = np.cumsum(lens)
        return [chars[e - n: e] for e, n in zip(ends, lens)]

    return (docs_of(np.random.default_rng(SEED), FP_LINES, 60, 180),
            docs_of(np.random.default_rng(SEED + 7), *FP_DOCS))


def _utf8_sets():
    """Phase 4d's UTF-8 workloads: (name, queries, candidates) as str."""
    rng = np.random.default_rng(SEED)
    # bench_levenshtein_utf8's pools: ASCII, Cyrillic, CJK, 1-3 bytes a rune
    pools = [np.arange(97, 123), np.arange(0x430, 0x450), np.arange(0x4E00, 0x4E60)]

    def mixed(count):
        lens = np.clip(rng.normal(100, 12, count).astype(int), 8, 128)
        which = rng.integers(0, 3, int(lens.sum()))
        pick = rng.integers(0, 1 << 20, int(lens.sum()))
        runes = np.choose(which, [p[pick % len(p)] for p in pools])
        return [runes[e - n: e] for e, n in zip(np.cumsum(lens), lens)]

    def cjk(count):
        lens = rng.integers(100, 401, count)
        runes = rng.choice(CJK, int(lens.sum()))
        return [runes[e - n: e] for e, n in zip(np.cumsum(lens), lens)]

    text = lambda rs: ["".join(map(chr, r)) for r in rs]
    return [("utf8-mixed", text(mixed(UTF8_MIXED[0])), text(mixed(UTF8_MIXED[1]))),
            ("utf8-cjk", text(cjk(UTF8_CJK[0])), text(cjk(UTF8_CJK[1])))]


def utf8_block(qs, cs, dev):
    """One rune block of every query and one of every candidate (str),
    decoded and packed on the card as the engine packs its blocks: the
    rune kernel's inputs when timed alone."""
    import torch
    from stringzilla_tpu_torch import Tape
    from stringzilla_tpu_torch.ops.pack_device import device_tape
    from stringzilla_tpu_torch.ops.tape import dyadic_bucket
    from stringzilla_tpu_torch.ops.utf8_pack_device import decode_pack_device

    def packed(texts, rows, fill):
        raw = [t.encode() for t in texts]
        dt = device_tape(Tape.from_strings(raw), dev)
        return decode_pack_device(dt, np.arange(len(raw)), dyadic_bucket(max(map(len, raw))),
                                  rows, fill=fill)

    ql = np.array([len(q) for q in qs], np.int32)
    cl = np.array([len(c) for c in cs], np.int32)
    rows = -(-int(ql.max()) // 32) * 32
    return (packed(qs, rows, -1), torch.from_numpy(ql).to(dev).view(-1, 1),
            packed(cs, int(cl.max()), 0), torch.from_numpy(cl).to(dev).view(1, -1))


def _utf8_main_path(dev, sync, report):
    """Phase 4d: ``LevenshteinDistancesUTF8`` on mixed-script and CJK-wide
    sets, then a malformed collection."""
    import torch
    from stringzilla_tpu_torch import LevenshteinDistancesUTF8
    from stringzilla_tpu_torch.ops import myers as myers_mod
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference
    from stringzilla_tpu_torch.ops.tape import dyadic_bucket

    sets = _utf8_sets()
    engine = LevenshteinDistancesUTF8()
    sync()
    _reset(myers_mod.KERNEL_LAUNCHES)
    results = [engine(qs, cs) for _, qs, cs in sets]
    launches = dict(myers_mod.KERNEL_LAUNCHES)
    print(f"[engine] launches on the UTF-8 main path: {launches}")
    for k in ("myers_tier_a_runes", "myers_tier_b_runes"):
        _check(launches[k] > 0, f"{k} was not launched on the main path")

    for (name, qs, cs), res in zip(sets, results):
        _check(res.dtype == np.uint64 and res.shape == (len(qs), len(cs)),
               f"{name}: result {res.dtype} {res.shape}")
        q_runes = [[ord(ch) for ch in q] for q in qs]
        ql = np.array([len(r) for r in q_runes], np.float64)
        cl = np.array([len(c) for c in cs], np.float64)
        # the engine's query blocks are dyadic rune buckets
        blocks = {}
        for r in q_runes:
            blocks.setdefault(dyadic_bucket(len(r)), set()).update(r)
        distinct = {b: len(v) for b, v in sorted(blocks.items())}
        print(f"[engine] {name}: distinct runes per query block {distinct}")
        if name == "utf8-cjk":
            _check(min(distinct.values()) > 256, f"{name}: a query block with <= 256 runes")

        packed = utf8_block(qs, cs, dev)
        (rows, _), (cand_len, _) = packed[0].shape, packed[2].shape
        plain = myers_reference(*packed, alphabet=None)
        _check(np.array_equal(res.astype(np.int64), plain.cpu().numpy()),
               f"{name}: engine result != plain version on the card")
        pick = np.random.default_rng(SEED + 9)
        for i, j in zip(pick.integers(0, len(qs), 16), pick.integers(0, len(cs), 16)):
            _check(int(res[i, j]) == _wagner_fischer(q_runes[i], [ord(ch) for ch in cs[j]]),
                   f"{name}: pair ({i}, {j}) != Wagner-Fischer over runes")
        print(f"[engine] {name}: {len(qs)}x{len(cs)} equals the plain version and "
              f"Wagner-Fischer over runes on 16 pairs")

        # one engine call builds each query block's rune tables once
        _reset(myers_mod.TABLE_BUILDS)
        engine._device_scores(qs, cs)
        builds = myers_mod.TABLE_BUILDS["rune_tables"]
        print(f"[engine] {name}: {builds} rune table builds in one engine call, "
              f"{len(distinct)} query blocks")
        _check(builds == len(distinct), f"{name}: {builds} rune table builds for "
               f"{len(distinct)} query blocks")

        cells = ql.sum() * cl.sum()
        word_steps = np.ceil(ql / 64).sum() * cl.sum()
        nbytes = 4.0 * (rows * len(qs) + cand_len * len(cs) + len(qs) * len(cs))
        engine_runs = 3
        t0 = time.perf_counter()
        for _ in range(engine_runs):
            engine._device_scores(qs, cs)
            sync()
        device_s = (time.perf_counter() - t0) / engine_runs
        t0 = time.perf_counter()
        for _ in range(engine_runs):
            engine(qs, cs)
        engine_s = (time.perf_counter() - t0) / engine_runs
        # the kernel alone: its raw launch, the rune tables built beforehand
        launch, out = rune_launch(packed, dev)
        kernel_ms = _time_ms(launch, 10, sync)
        _check(torch.equal(out, plain), f"{name}: raw rune kernel != plain version")
        wrapper_ms = _time_ms(lambda: myers(*packed, alphabet=None), 10, sync)
        plain_ms = _time_ms(lambda: myers_reference(*packed, alphabet=None), 1, sync,
                            batches=1)
        _profile(name, lambda: engine(qs, cs), sync, kernel_ms)
        bound_ms, bound_by = _bound(MYERS_OPS_PER_WORD_STEP * word_steps, nbytes)
        tier = "myers_tier_a_runes" if rows <= 256 else "myers_tier_b_runes"
        report[tier] = dict(launches=launches[tier], ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        print(f"[perf] {name} rows={rows} cand_len={cand_len} cells={cells:.0f}: "
              f"engine+pull {engine_s * 1e3:.3f} ms = {cells / engine_s / 1e9:.3f} GCUPS; "
              f"engine to device result {device_s * 1e3:.3f} ms; "
              f"{tier} {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] raw launch = "
              f"{cells / kernel_ms / 1e6:.3f} GCUPS; the myers wrapper (its tables built "
              f"each call) {wrapper_ms:.4f} ms [{wrapper_ms.lo:.4f}-{wrapper_ms.hi:.4f}]; "
              f"plain {plain_ms:.3f} ms = {cells / plain_ms / 1e6:.3f} GCUPS; "
              f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of it")
        timed = _engine_runes(engine, qs, cs, dev, sync)
        for k in ("myers_tier_a_runes", "myers_tier_b_runes"):
            mine = [t for t in timed if t[0] == k]
            if mine:
                ms, bound = sum(t[4] for t in mine), sum(t[5] for t in mine)
                print(f"[perf] {name}: the engine's own {k} launches: {len(mine)}, kernel "
                      f"{ms:.4f} ms summed by CUDA events ("
                      + ", ".join(f"{r} rows {q}x{c}" + (f" S={g}" if g else "") + f" {t:.4f}"
                                  for _, r, q, c, t, _, g in mine)
                      + f"); bound {bound:.4f} ms summed, {100 * bound / ms:.1f}% of it")

    # A malformed collection: its strings are decoded on the host, each
    # maximal invalid subpart becoming U+FFFD, then scored on the card.
    name, qs, cs = sets[0]
    bad = [c.encode() for c in cs[:512]]
    bad[3] = bad[3][:10] + b"\xff" + bad[3][10:]
    bad[7] = bad[7] + b"\xe2\x82"
    res = engine(qs[:16], bad)
    fixed = engine(qs[:16], [b.decode("utf-8", "replace") for b in bad])
    _check(np.array_equal(res, fixed), "malformed collection != its host decode")
    for i, j in [(0, 3), (5, 7), (2, len(bad) - 1)]:
        _check(int(res[i, j]) == _wagner_fischer(
            [ord(ch) for ch in qs[i]], [ord(ch) for ch in bad[j].decode("utf-8", "replace")]),
            f"malformed collection: pair ({i}, {j}) != Wagner-Fischer over runes")
    print("[engine] a malformed collection of 16x512 takes the host decode and equals "
          "Wagner-Fischer over its U+FFFD runes")


UTF8_CASES = [
    b"", b"plain ascii", "héllo wörld".encode(), "日本語".encode(),
    "emoji \U0001f389\U0001f38a".encode(), b"\x80", b"\xC0\xAF", b"\xC1\xBF",
    b"\xE0\x80\x80", b"\xE0\xA0\x80", b"\xED\x9F\xBF", b"\xED\xA0\x80",
    b"\xF0\x8F\xBF\xBF", b"\xF0\x90\x80\x80", b"\xF4\x8F\xBF\xBF", b"\xF4\x90\x80\x80",
    b"\xF5\x80\x80\x80", b"\xFF", b"ok\xC3", b"ok\xE2\x82", "ab€cd".encode()[:-1],
    b"\xC3\xA9" * 50,
]  # tests/test_intersect_utf8.py's case list
UTF8_POOL = (b"xyz", "é".encode(), "€".encode(), "\U0001f389".encode(),
             b"\xC3", b"\x80", b"\xED\xA0\x80", b"\xF4\x90\x80\x80")


def _check_find_kernel(dev, sync, max_err):
    """Phase 3e: the streaming search against its plain version."""
    import torch
    from stringzilla_tpu_torch.ops.find import byteset_mask
    from stringzilla_tpu_torch.ops.find_kernel import (CHUNK_POSITIONS, search_positions,
                                                       search_positions_reference)

    rng = np.random.default_rng(SEED + 20)
    err, calls = 0, 0

    def same(hay, n, what, modes=("first", "last", "count"), **kw):
        nonlocal err, calls
        for mode in modes:
            got = int(search_positions(hay, n, mode, **kw))
            want = int(search_positions_reference(hay, n, mode, **kw))
            err = max(err, abs(got - want))
            calls += 1
            _check(got == want, f"find_search {mode} {what}: {got} != plain {want}")

    def on_card(buf):
        return torch.from_numpy(np.ascontiguousarray(buf)).to(dev)

    n = FIND_CHECK
    edges = list(range(CHUNK_POSITIONS, n, CHUNK_POSITIONS))
    b1 = edges[0]
    for k in FIND_KS:
        needle = rng.integers(97, 123, k, dtype=np.uint8)
        spots = {"edges+-k": [0, n - k] + [p for b in edges for p in (b - k, b + k)],
                 "across edges": [b - max(k // 2, 1) for b in edges]}
        for name, at in spots.items():
            buf = rng.integers(97, 123, n + 16, dtype=np.uint8)
            buf[n:] = 0
            for p in at:
                if 0 <= p <= n - k:
                    buf[p: p + k] = needle
            hay = on_card(buf)
            for lo, hi in [(0, None), (1, None), (b1, b1), (b1 - k, b1 + k), (b1 + 1, b1 - 1),
                           (CHUNK_POSITIONS - 1, n - k - 1), (-5, 3)]:
                same(hay, n, f"k={k} {name} [{lo}, {hi}]", needle=needle, lo=lo, hi=hi)
            if k in (1, 5, 17):  # a haystack that is not 16-byte aligned
                same(on_card(np.concatenate([np.zeros(3, np.uint8), buf]))[3:], n,
                     f"k={k} {name} unaligned", needle=needle)
    for k in (1, 2, 16, 17, 130):  # every position a hit
        hay = on_card(np.full(n, 97, np.uint8))
        same(hay, n, f"k={k} all hits", needle=np.full(k, 97, np.uint8))
        _check(int(search_positions(hay, n, "count", needle=np.full(k, 97, np.uint8))) == n - k + 1,
               f"find_search k={k} all hits: count != {n - k + 1}")
    empty = torch.zeros(16, dtype=torch.uint8, device=dev)
    same(empty, 0, "empty buffer", needle=np.frombuffer(b"a", np.uint8))
    same(empty, 3, "n < k", needle=np.zeros(5, np.uint8))

    buf = rng.integers(97, 123, n + 16, dtype=np.uint8)
    buf[n:] = 0
    for j, b in enumerate(edges):
        buf[b - 1 + (j % 2)] = 0 if j % 2 else 0xFF
    buf[0], buf[n - 1] = 0xFF, 0
    hay = on_card(buf)
    for charset in (b"\x00", b"\xff", b"\x00\xffq", bytes(range(97, 123))):
        words = byteset_mask(charset)
        for w, name in ((words, "set"), (~words, "inverted set")):
            for lo, hi in [(0, None), (b1 - 2, b1 + 1), (5, n - 2)]:
                same(hay, n, f"{name} {charset!r} [{lo}, {hi}]", byteset_words=w, lo=lo, hi=hi)

    race = rng.integers(97, 123, FIND_RACE, dtype=np.uint8)
    needle = np.frombuffer(b"race!hit", np.uint8)
    chunks = FIND_RACE // CHUNK_POSITIONS
    for c in (3, 4, chunks // 3, chunks // 3 + 1, 2 * chunks // 3, chunks - 2):
        p = c * CHUNK_POSITIONS - 4 + int(rng.integers(0, 9))
        race[p: p + len(needle)] = needle
    hay = on_card(race)
    for _ in range(3):  # blocks claim chunks in a different order each time
        same(hay, FIND_RACE, "hits in six chunks", needle=needle)
    max_err["find_search"] = err
    print(f"[kernel] find_search: needles of {len(FIND_KS)} lengths up to {max(FIND_KS)} "
          f"bytes, bytesets, bounds, all-hit, empty, unaligned and racing haystacks: "
          f"{calls} results exact")


def _check_utf8_kernel(dev, sync, max_err):
    """Phase 3e: the UTF-8 validation and count pass against its plain version."""
    import ctypes

    import torch
    from stringzilla_tpu_torch.ops import utf8_device as U
    from stringzilla_tpu_torch.ops.utf8_device import validate_count_raw, validate_count_reference
    from stringzilla_tpu_torch.utils import cuda_build

    rng = np.random.default_rng(SEED + 21)
    err, calls = 0, 0

    def same(mirror, n, what):
        nonlocal err, calls
        got = validate_count_raw(mirror, n).tolist()
        want = validate_count_reference(mirror, n).tolist()
        err = max(err, abs(got[0] - want[0]), abs(got[1] - want[1]))
        calls += 1
        _check(got == want, f"utf8_validate_count {what}: {got} != plain {want}")
        return got

    fuzz = [b"".join(UTF8_POOL[int(i)] for i in rng.integers(0, len(UTF8_POOL), int(m)))
            for m in rng.integers(0, 40, 300)]
    for buf in UTF8_CASES + fuzz:
        mirror = torch.from_numpy(np.frombuffer(buf + bytes(16), np.uint8).copy()).to(dev)
        got = same(mirror, len(buf), repr(buf[:16]))
        try:
            buf.decode("utf-8")
            _check(got[0] == 0 and got[1] == len(buf.decode("utf-8")), f"valid {buf!r}: {got}")
        except UnicodeDecodeError:
            _check(got[0] > 0, f"invalid {buf!r} counted no violation")

    # the kernel's geometry: CTA, group and grid-stride edges from it
    geometry = (ctypes.c_int * len(U.GEOMETRY))()
    cuda_build.load().sz_utf8_geometry(geometry)
    _check(tuple(geometry) == U.GEOMETRY, f"sz_utf8_geometry {tuple(geometry)} != {U.GEOMETRY}")
    stride = U.grid_stride(torch.cuda.get_device_properties(dev).multi_processor_count)
    size = max(UTF8_CHECK, stride + 2 * U.CTA_BYTES)
    pieces = [p for p in UTF8_POOL if p.decode("utf-8", "ignore").encode() == p]
    text = bytearray(b"".join(pieces[int(i)] for i in rng.integers(0, len(pieces), size // 2)))
    edges = [U.CTA_BYTES * j + d for j in (1, 2, 100) for d in (-3, -1, 0, 2)]
    edges += [U.GROUP_BYTES * 3 + d for d in (-2, 1)]
    edges += [stride + d for d in (-2, 0, 1)] + [stride + U.GROUP_BYTES - 1, len(text) - 1]
    big = bytes(text)
    for at in edges:
        text[at] = 0x80 if at % 2 else 0xF5
    for name, buf in (("valid", big), ("violations at CTA, group and stride edges", bytes(text)),
                      ("cut-off lead at the end", big + b"\xF0\x9F\x8E")):
        mirror = torch.from_numpy(np.frombuffer(buf + bytes(16), np.uint8).copy()).to(dev)
        got = same(mirror, len(buf), f"{len(buf)} bytes {name}")
        _check((got[0] == 0) == (name == "valid"), f"utf8 {name}: violations {got[0]}")
        for k in range(1, 16) if name != "valid" else (1, 7, 15):
            same(mirror[k:], len(buf) - k, f"{len(buf) - k} bytes {name}, offset {k}")
    # ASCII with a lead or a violation in the last 1-3 bytes of each span:
    # the next span's first vector must look back, which the all-ASCII row
    # branch must not skip
    spans = {"vector": U.VECTOR_BYTES, "row": U.ROW_BYTES, "group": U.GROUP_BYTES,
             "CTA": U.CTA_BYTES}
    tails = [b"\xC3", b"\xE2\x82", b"\xF0\x9F\x8E", b"\xFF", b"\xE0\x80", b"\x80", b"\xE2",
             b"\xF0", b"\xF8\x88\x80\x80", b"\xC0\x80"]
    for span_name, span in spans.items():
        for piece in tails:
            buf = bytearray(b"y" * (5 * U.CTA_BYTES + 777))
            for i, end in enumerate(range(span, len(buf) - 8, span)):
                at = end - 1 - i % 3
                buf[at: at + len(piece)] = piece
            mirror = torch.from_numpy(np.frombuffer(bytes(buf) + bytes(32), np.uint8).copy()).to(dev)
            for k in (0, 5):  # the spans from the aligned start, then 11 bytes on
                got = same(mirror[k:], len(buf) - k, f"{piece!r} at {span_name} ends, offset {k}")
                _check(got[0] > 0, f"{piece!r} at {span_name} ends: no violation counted")
    max_err["utf8_validate_count"] = err
    print(f"[kernel] utf8_validate_count: {calls} buffers (the UTF-8 case list, fuzz, "
          f"{size / 2**20:.2f} MiB with violations at CTA, group and stride edges at offsets "
          f"0-15, ASCII runs with a lead or a violation ending each vector, row, group and CTA "
          f"span) exact")


def _log_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_log.txt")


def _write_log(path_name) -> bytes:
    """Writes the FILE_BYTES log of phases 4e and 4f (``log_body``) to
    ``path_name``; returns its bytes. The caller unlinks it."""
    body = log_body()
    os.makedirs(os.path.dirname(path_name), exist_ok=True)
    with open(path_name, "wb") as f:
        f.write(body)
    return body


def log_body(paths=(b"users", b"orders", "cafés".encode(), "数据".encode())) -> bytes:
    """The FILE_BYTES log of phases 4e and 4f: lines of ~90 bytes, seed
    SEED + 30, a FATAL line last; each line's path one of ``paths``."""
    lines_rng = np.random.default_rng(SEED + 30)
    levels = np.array([b"INFO", b"WARN", b"DEBUG", b"ERROR"])
    lines = [b"2026-10-17T05:%02d:%02d.%03d %s worker-%d request id=%d took %d ms path=/api/v1/%s\n"
             % (int(a), int(b), int(c), lv, int(w), int(i), int(t), p)
             for a, b, c, lv, w, i, t, p in zip(
                 *(lines_rng.integers(0, m, 4096) for m in (60, 60, 1000)),
                 levels[lines_rng.integers(0, 4, 4096)], lines_rng.integers(0, 64, 4096),
                 lines_rng.integers(0, 10**9, 4096), lines_rng.integers(0, 5000, 4096),
                 list(paths) * (4096 // len(paths)))]
    body = b"".join(lines[int(i)] for i in lines_rng.integers(0, 4096, FILE_BYTES // 80))
    return (body[: body.index(b"\n", FILE_BYTES) + 1]
            + b"2026-10-17T06:00:00.000 FATAL worker-9 out of memory\n")


def utf8_blob(n: int) -> np.ndarray:
    """bench_utf8_count_device's blob: n printable ASCII bytes (seed SEED)
    with a 2-byte "é" every 4096 bytes."""
    blob = np.random.default_rng(SEED).integers(32, 127, n, dtype=np.uint8)
    pos = np.arange(1000, n - 2, 4096)
    blob[pos], blob[pos + 1] = 0xC3, 0xA9
    return blob


def utf8_mixed(n: int) -> np.ndarray:
    """n bytes of valid mixed-script UTF-8: runes drawn one by one from
    UTF8_MIX's ranges by weight (seed SEED + 40), a piece of
    UTF8_MIX_PIECE bytes (at most n) cut after its last whole rune and
    padded with spaces, repeated, the rest spaces."""
    rng = np.random.default_rng(SEED + 40)
    piece = min(UTF8_MIX_PIECE, n)
    lo, hi, weight = (np.array(c) for c in zip(*UTF8_MIX))
    kind = rng.choice(len(UTF8_MIX), piece // 2, p=weight / weight.sum())
    cp = lo[kind] + (rng.random(len(kind)) * (hi - lo + 1)[kind]).astype(np.int64)
    width = 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000)
    enc = np.zeros((len(cp), 4), np.uint8)
    for w, lead in ((1, 0), (2, 0xC0), (3, 0xE0), (4, 0xF0)):
        sel = width == w
        c = cp[sel]
        enc[sel, 0] = lead | (c >> (6 * (w - 1)))
        for k in range(1, w):
            enc[sel, k] = 0x80 | ((c >> (6 * (w - 1 - k))) & 0x3F)
    ends = np.cumsum(width)
    keep = int(np.searchsorted(ends, piece, side="right"))
    out = np.full(piece, 0x20, np.uint8)
    starts = ends[:keep] - width[:keep]
    for k in range(4):
        sel = width[:keep] > k
        out[starts[sel] + k] = enc[:keep][sel, k]
    return np.concatenate([np.tile(out, n // piece), np.full(n % piece, 0x20, np.uint8)])


def _buffer_main_path(dev, sync, report):
    """Phase 4e: ``Str`` / ``File`` on benches/bench_all.py's buffers."""
    import torch
    import stringzilla_tpu_torch as szt
    from stringzilla_tpu_torch.ops import find_kernel as find_mod
    from stringzilla_tpu_torch.ops import memory as memory_mod
    from stringzilla_tpu_torch.ops import utf8_device as utf8_mod
    from stringzilla_tpu_torch.ops.find import byteset_mask
    from stringzilla_tpu_torch.ops.find_kernel import search_positions, search_positions_reference
    from stringzilla_tpu_torch.ops.memory import lookup_transform
    from stringzilla_tpu_torch.ops.utf8_device import validate_count_raw, validate_count_reference

    def held(kernel, what, cases, plain):
        """Each case's kernel result against its plain version on the main
        path's own buffer, exactly; returns the largest difference."""
        err = 0
        for name, args in cases.items():
            got, want = kernel(*args).tolist(), plain(*args).tolist()
            err = max(err, max(abs(a - b) for a, b in zip(np.ravel(got), np.ravel(want))))
            _check(got == want, f"{kernel.__name__} {name} {what}: {got} != plain {want}")
        print(f"[kernel] {kernel.__name__} on {what}: {len(cases)} results equal the plain "
              f"version's")
        return err

    def first_call(make, call):
        """A fresh ``Str``'s first call: the mirror's H2D and the search."""
        sync()
        t0 = time.perf_counter()
        s = make()
        out = call(s)
        sync()
        return s, out, (time.perf_counter() - t0) * 1e3

    launches = {}

    def path(name, counters, run):
        return _launched(name, counters, [k for c in counters for k in c], run, launches)

    # -- find 1 GiB --------------------------------------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    n = FIND_BYTES
    hay = rng.integers(97, 123, n, dtype=np.uint8)
    hay[n - 4096: n - 4091] = np.frombuffer(b"XqZwV", np.uint8)
    long = rng.integers(97, 123, 130, dtype=np.uint8)
    for p in (n // 3, 2 * n // 3):
        hay[p: p + 130] = long
    data, needle, lb = hay.tobytes(), b"XqZwV", long.tobytes()
    lo, hi = n // 3 + 1, 2 * n // 3 + 130
    print(f"[setup] find: {n} random lowercase bytes in {time.perf_counter() - t0:.3f} s")
    calls = {
        "find": (lambda s: s.find(needle), lambda: data.find(needle)),
        "rfind": (lambda s: s.rfind(needle), lambda: data.rfind(needle)),
        "count ab": (lambda s: s.count(b"ab", allowoverlap=True), lambda: data.count(b"ab")),
        "find_first_of": (lambda s: s.find_first_of(b"\n\r"),
                          lambda: min((p for p in map(data.find, (b"\n", b"\r")) if p >= 0),
                                      default=-1)),
        "find_last_of": (lambda s: s.find_last_of(b" \t\n\r\x0b\x0c"),
                         lambda: max(map(data.rfind, (b" ", b"\t", b"\n", b"\r", b"\x0b",
                                                      b"\x0c")))),
        "find 130": (lambda s: s.find(lb), lambda: data.find(lb)),
        "rfind 130": (lambda s: s.rfind(lb), lambda: data.rfind(lb)),
        "find 130 bounded": (lambda s: s.find(lb, lo, hi), lambda: data.find(lb, lo, hi)),
        "rfind 130 bounded": (lambda s: s.rfind(lb, lo - 1, hi - 1),
                              lambda: data.rfind(lb, lo - 1, hi - 1)),
    }

    def run_find():
        s, first, first_ms = first_call(lambda: szt.Str(hay), calls["find"][0])
        return s, first_ms, {name: fn(s) for name, (fn, _) in calls.items()}

    s, first_ms, got = path("find", [find_mod.KERNEL_LAUNCHES], run_find)
    for name, (_, oracle) in calls.items():
        want = oracle()
        _check(got[name] == want, f"Str.{name} on {n >> 20} MiB: {got[name]} != bytes {want}")
    print(f"[engine] find {n >> 20} MiB: {len(calls)} Str calls equal Python's bytes: {got}")
    mirror = s._device()
    nd = np.frombuffer(needle, np.uint8)
    hit = got["find"]
    kernel_ms = _time_ms(lambda: search_positions(mirror, n, "first", needle=nd), 10, sync)
    plain_ms = _time_ms(lambda: search_positions_reference(mirror, n, "first", needle=nd), 1, sync)
    scanned = hit + len(needle)  # "first" reads up to its hit: here the whole buffer
    bound_ms, bound_by = _bound(FIND_OPS_PER_BYTE * scanned, scanned)
    _profile(f"Str.find {n >> 20} MiB", lambda: s.find(needle), sync, kernel_ms)
    print(f"[perf] find {n >> 20} MiB: first call with the mirror's H2D {first_ms:.3f} ms; "
          f"kernel {kernel_ms:.4f} ms = {n / kernel_ms / 1e6:.3f} GB/s; plain {plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}, the hit at N - 4096 makes it a full scan)")
    for name, (fn, _) in calls.items():
        ms = _host_ms(lambda: fn(s), sync)
        print(f"[perf] Str.{name} {n >> 20} MiB, mirror cached: {ms:.3f} ms = {n / ms / 1e6:.3f} GB/s")
    words = {"first_of": (b"\n\r", "first"), "last_of": (b" \t\n\r\x0b\x0c", "last")}
    for name, (charset, mode) in words.items():
        ws = byteset_mask(charset)
        ms = _time_ms(lambda: search_positions(mirror, n, mode, byteset_words=ws), 10, sync)
        print(f"[perf] find_search byteset {name} {n >> 20} MiB: kernel {ms:.4f} ms = "
              f"{n / ms / 1e6:.3f} GB/s")
    # bytes the search must read: up to the hit and its needle ("first"),
    # from the hit on ("last"), all of them (count). The 130-byte needle's
    # first 16 bytes hit at the same place, with no needle to upload.
    for name, args, scanned in (
            ("130 first", ("first", long), got["find 130"] + len(lb)),
            ("130's first 16 bytes, first", ("first", long[:16]), got["find 130"] + 16),
            ("130 last", ("last", long), n - got["rfind 130"]),
            ("count ab", ("count", np.frombuffer(b"ab", np.uint8)), n)):
        ms = _time_ms(lambda: search_positions(mirror, n, args[0], needle=args[1]), 10, sync)
        print(f"[perf] find_search {name} {n >> 20} MiB: kernel {ms:.4f} ms = {n / ms / 1e6:.3f} GB/s "
              f"of the buffer; it must read {scanned} bytes: {scanned / ms / 1e6:.3f} GB/s of those "
              f"(the full scan above: {n / kernel_ms / 1e6:.3f} GB/s)")
    ab = np.frombuffer(b"ab", np.uint8)
    err = held(search_positions, f"the {n >> 20} MiB mirror", {
        f"{mode} {label}": (mirror, n, mode, *kw) for label, kw in (
            ("XqZwV", (nd,)), ("ab", (ab,)), ("130", (long,)),
            ("130 bounded", (long, None, lo, hi - 130)),
            ("set \\n\\r", (None, byteset_mask(b"\n\r"))),
            ("set whitespace", (None, byteset_mask(b" \t\n\r\x0b\x0c"))),
            ("set not a-y", (None, ~byteset_mask(bytes(range(97, 122))))))
        for mode in ("first", "last", "count")}, search_positions_reference)
    report["find_search"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None, max_abs_err=err)
    del s, mirror, data, hay

    # -- lookup 1 GiB ------------------------------------------------------
    n = LOOKUP_BYTES
    buf = np.frombuffer(np.random.default_rng(SEED + 7).bytes(n), np.uint8)
    lut = np.frombuffer(bytes(range(256)).swapcase(), np.uint8)
    _, out_s, first_ms = path("lookup", [memory_mod.KERNEL_LAUNCHES],
                              lambda: first_call(lambda: szt.Str(buf), lambda s: s.translate(lut)))
    _check(np.array_equal(out_s._buf, lut[buf]), f"Str.translate {n >> 20} MiB != numpy lut[buf]")
    s = szt.Str(buf)
    mirror = s._device()
    kernel_ms = _time_ms(lambda: lookup_transform(mirror[:n], lut), 10, sync)
    call_ms = _host_ms(lambda: s.translate(lut), sync, runs=2)
    print(f"[engine] translate {n >> 20} MiB equals numpy's lut[buf]")
    print(f"[perf] translate {n >> 20} MiB: first call with the mirror's H2D {first_ms:.3f} ms; "
          f"Str call, mirror cached, host pull included {call_ms:.3f} ms = "
          f"{n / call_ms / 1e6:.3f} GB/s; byte_lut kernel {kernel_ms:.4f} ms "
          f"[{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = {2 * n / kernel_ms / 1e6:.3f} GB/s moved; "
          f"bound {_bound(0, 2.0 * n)[0]:.4f} ms (bytes: the GiB read and written once), "
          f"{100 * _bound(0, 2.0 * n)[0] / kernel_ms:.1f}% of it")
    del s, mirror, out_s, buf

    # -- UTF-8 256 MiB -----------------------------------------------------
    n = UTF8_BYTES
    blob = utf8_blob(n)
    bad = bytearray(blob[: 2 << 20].tobytes())
    for p in (17, 70000, 1 << 20):
        bad[p] = 0xFF
    bad = bytes(bad) + b"\xE2\x82"

    def run_utf8():
        s, count, first_ms = first_call(lambda: szt.Str(blob), lambda s: s.utf8_count())
        return s, count, first_ms, s.utf8_valid(), szt.Str(bad).utf8_count(), szt.Str(bad).utf8_valid()

    s, count, first_ms, valid, bad_count, bad_valid = path(
        "UTF-8", [utf8_mod.KERNEL_LAUNCHES], run_utf8)
    text = blob.tobytes()
    _check(valid and count == len(text.decode("utf-8")),
           f"Str.utf8_count {n >> 20} MiB: {count}, valid {valid}")
    _check(not bad_valid and bad_count == len(bad.decode("utf-8", "replace")),
           f"invalid 2 MiB buffer: count {bad_count}, valid {bad_valid}")
    print(f"[engine] UTF-8 {n >> 20} MiB: {count} runes and valid, as Python decodes it; an invalid "
          f"2 MiB buffer: {bad_count} runes with U+FFFD, as errors='replace' decodes it")
    mirror = s._device()
    wrapper_ms = _time_ms(lambda: validate_count_raw(mirror, n), 10, sync)
    kernel_ms = _time_ms(utf8_launch(mirror, n), 10, sync)
    plain_ms = _time_ms(lambda: validate_count_reference(mirror, n), 1, sync)
    call_ms = _host_ms(lambda: s.utf8_count(), sync)
    bound_ms, bound_by = _bound(0, n)  # the bytes read once (see FIND_OPS_PER_BYTE)
    print(f"[perf] utf8_count {n >> 20} MiB: first call with the mirror's H2D {first_ms:.3f} ms; "
          f"Str call, mirror cached {call_ms:.3f} ms = {n / call_ms / 1e6:.3f} GB/s; kernel by raw "
          f"launch {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = "
          f"{n / kernel_ms / 1e6:.3f} GB/s, {100 * bound_ms / kernel_ms:.1f}% of its bound "
          f"{bound_ms:.4f} ms ({bound_by}); through validate_count_raw {wrapper_ms:.4f} ms; "
          f"plain {plain_ms:.3f} ms")
    bad_s = szt.Str(bad)
    err = held(validate_count_raw, f"the {n >> 20} MiB and the invalid 2 MiB mirrors", {
        f"{n >> 20} MiB": (mirror, n), "invalid 2 MiB": (bad_s._device(), len(bad))},
        validate_count_reference)
    report["utf8_validate_count"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=None, max_abs_err=err)
    del s, bad_s, mirror, text, blob
    # the same kernel on a valid mixed-script buffer (UTF8_MIX, an assumed mix)
    mixed = utf8_mixed(n)
    want = len(mixed.tobytes().decode("utf-8"))
    s = szt.Str(mixed)
    count = s.utf8_count()
    _check(count == want, f"Str.utf8_count on {n >> 20} MiB mixed script: {count} != {want}")
    mirror = s._device()
    err = held(validate_count_raw, f"the {n >> 20} MiB mixed-script mirror",
               {"mixed": (mirror, n)}, validate_count_reference)
    report["utf8_validate_count"]["max_abs_err"] = max(err, report["utf8_validate_count"]
                                                       ["max_abs_err"])
    mixed_ms = _time_ms(utf8_launch(mirror, n), 10, sync)
    call_ms = _host_ms(lambda: s.utf8_count(), sync)
    print(f"[perf] utf8_count {n >> 20} MiB mixed script, assumed mix ({want} runes, valid): "
          f"Str call, mirror cached {call_ms:.3f} ms; kernel by raw launch {mixed_ms:.4f} ms "
          f"[{mixed_ms.lo:.4f}-{mixed_ms.hi:.4f}] = {n / mixed_ms / 1e6:.3f} GB/s, "
          f"{100 * bound_ms / mixed_ms:.1f}% of its bound {bound_ms:.4f} ms (bytes)")
    del s, mirror, mixed

    # -- a log file ----------------------------------------------------------
    path_name = _log_path()
    body = _write_log(path_name)
    try:
        def run_file():
            f, fatal, first_ms = first_call(lambda: szt.File(path_name), lambda f: f.find(b"FATAL"))
            return f, first_ms, (fatal, f.count(b"ERROR", allowoverlap=True), f.utf8_count(),
                                 f.rfind(b"users"))

        f, first_ms, got = path("File", [find_mod.KERNEL_LAUNCHES, utf8_mod.KERNEL_LAUNCHES],
                                run_file)
        want = (body.find(b"FATAL"), body.count(b"ERROR"), len(body.decode("utf-8")),
                body.rfind(b"users"))
        _check(got == want, f"File on {len(body)} bytes: {got} != bytes {want}")
        call_ms = _host_ms(lambda: f.find(b"FATAL"), sync)
        log_ms = _time_ms(utf8_launch(f._device(), len(f)), 10, sync)
        log_bound = _bound(0, len(f))[0]
        print(f"[perf] utf8_count {len(body)} bytes of log lines: Str call, mirror cached "
              f"{_host_ms(lambda: f.utf8_count(), sync):.3f} ms; kernel by raw launch "
              f"{log_ms:.4f} ms [{log_ms.lo:.4f}-{log_ms.hi:.4f}] = "
              f"{len(body) / log_ms / 1e6:.3f} GB/s, {100 * log_bound / log_ms:.1f}% of its "
              f"bound {log_bound:.4f} ms (bytes)")
        fatal = np.frombuffer(b"FATAL", np.uint8)
        kernel_ms = _time_ms(lambda: search_positions(f._device(), len(f), "first",
                                                      needle=fatal), 10, sync)
        print(f"[engine] File {len(body)} bytes (log lines): find, count, utf8_count, rfind "
              f"equal Python's bytes: {got}")
        print(f"[perf] File.find FATAL {len(body)} bytes: first call with the mirror's H2D "
              f"{first_ms:.3f} ms; mirror cached {call_ms:.3f} ms = "
              f"{len(body) / call_ms / 1e6:.3f} GB/s; kernel {kernel_ms:.4f} ms = "
              f"{len(body) / kernel_ms / 1e6:.3f} GB/s")
        f.close()
        _check(f._mirror is None, "File.close kept its mirror")
    finally:
        os.unlink(path_name)
    for k in ("find_search", "utf8_validate_count"):
        report[k]["launches"] = launches[k]
    print(f"[engine] launches on the buffer tier's main path: {launches}")


# -- phases 3f and 4f: hashing and set operations ------------------------------

def _hash_ops(lengths) -> float:
    """int32 operations the hash kernels need for strings of these lengths:
    a block absorbed is an AESENC and a sum-lane update; a short string ends
    with three AESENC, a long one with four lanes' final blocks and nine."""
    lengths = np.asarray(lengths, np.int64)
    short = lengths <= 64
    blocks = np.maximum((lengths[short] + 15) // 16, 1)
    full = (lengths[~short] - 1) // 64
    return float(BLOCK_OPS * blocks.sum() + 3 * AES_OPS * short.sum()
                 + 4 * BLOCK_OPS * (full + 1).sum() + 9 * AES_OPS * (~short).sum())


def _hash_bytes(lengths) -> float:
    """Bytes the hash kernels must move: each string once, its start and
    length (int64) and its digest (8 bytes)."""
    return float(np.sum(lengths, dtype=np.int64) + 24 * len(lengths))


def _digests_err(got, want) -> int:
    """Largest |got - want| over u64 digests given as int64 bits (0 when equal)."""
    got, want = np.asarray(got).view(np.uint64), np.asarray(want).view(np.uint64)
    bad = np.nonzero(got != want)[0]
    return max((abs(int(got[i]) - int(want[i])) for i in bad), default=0)


def _on_card_tape(rng, lengths, dev, skew=0):
    """Strings of these lengths at odd offsets (0-3 junk bytes before each)
    in one blob on the card, ``skew`` bytes past a 16-byte boundary, with one
    trailing byte; returns (blob, starts, lengths) tensors and the host bytes."""
    import torch

    lengths = np.asarray(lengths, np.int64)
    gaps = rng.integers(0, 4, len(lengths))
    starts = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(lengths)[:-1]])
    total = int(starts[-1] + lengths[-1]) + 1 if len(lengths) else 1
    host = rng.integers(0, 256, total, dtype=np.uint8)
    blob = torch.zeros(total + skew, dtype=torch.uint8, device=dev)[skew:]
    blob.copy_(torch.from_numpy(host))
    return (blob, torch.from_numpy(starts).to(dev), torch.from_numpy(lengths).to(dev), host,
            starts)


def _check_hash_kernels(dev, sync, max_err):
    """Phase 3f: hash_short, hash_long and fill_random against their plain
    versions on the card, and against the host hash and golden vectors."""
    import torch
    from stringzilla_tpu_torch.ops import hash as host_hash
    from stringzilla_tpu_torch.ops.aes_kernel import fill_random_device, fill_random_reference
    from stringzilla_tpu_torch.ops.hash_kernel import (KERNEL_LAUNCHES, WIDE_BYTES,
                                                       hash_batch_device, hash_long,
                                                       hash_long_reference, hash_short,
                                                       hash_short_reference)

    rng = np.random.default_rng(SEED + 40)
    err = {"hash_short": 0, "hash_long": 0, "hash_long_wide": 0, "fill_random": 0}
    calls = dict.fromkeys(err, 0)
    seeds = (0, 42, 2**63 + 9, 2**64 - 1)

    def same(name, kernel, plain, tape, seed, what, host=True):
        """``kernel`` against ``plain`` on a tape; for ``hash_long`` the
        errors and launches go to the kernel each string was routed to."""
        blob, starts, lengths, buf, st = tape
        before = dict(KERNEL_LAUNCHES)
        got = kernel(blob, starts, lengths, seed).cpu().numpy()
        want = plain(blob, starts, lengths, seed).cpu().numpy()
        lens = lengths.cpu().numpy()
        parts = ({name: None} if name == "hash_short" else
                 {"hash_long": lens < WIDE_BYTES, "hash_long_wide": lens >= WIDE_BYTES})
        for part, mask in parts.items():
            sel = slice(None) if mask is None else mask
            err[part] = max(err[part], _digests_err(got[sel], want[sel]))
            calls[part] += KERNEL_LAUNCHES[part] - before[part]
        _check(np.array_equal(got, want), f"{name} {what} seed {seed}: differs from plain")
        if host:  # the strings of this kernel's path against the host sz_hash
            mine = (lens <= 64) if name == "hash_short" else (lens > 64)
            for i in np.nonzero(mine)[0][::max(1, int(mine.sum()) // 300)]:
                s = buf[st[i]: st[i] + lens[i]].tobytes()
                _check(int(got.view(np.uint64)[i]) == int(host_hash.hash_multiseed(s, [seed])[0]),
                       f"{name} {what} seed {seed}: string {i} of {lens[i]} B != host sz_hash")
        return got

    short_lens = list(range(0, 65)) + [65, 200]  # the long two stay 0
    for seed in seeds:
        for skew in (0, 1):
            same("hash_short", hash_short, hash_short_reference,
                 _on_card_tape(rng, short_lens, dev, skew), seed, f"lengths 0-64 skew {skew}")
    many = rng.integers(0, 65, (1 << 19) + 777)
    same("hash_short", hash_short, hash_short_reference, _on_card_tape(rng, many, dev, 3), 42,
         f"{len(many)} tokens")

    long_lens = (list(range(65, 301)) + [64 * k + d for k in range(2, 17) for d in (-1, 0, 1)]
                 + list(rng.integers(64 * 64 + 1, 64 * 128 + 63, 12))  # the 8 KiB bucket
                 + list(rng.integers(64 * 128 + 1, 64 * 256 + 63, 12)) + [5, 64])  # 16 KiB
    for seed in seeds:
        same("hash_long", hash_long, hash_long_reference,
             _on_card_tape(rng, long_lens, dev, int(seed % 3)), seed, "lengths 65-16447")
    # hash_long_wide's ring of P = 32 chunks (csrc/hash.cu kPrefetch): the
    # strings it takes (WIDE_BYTES on) of mP - 1, mP and mP + 1 full chunks
    # (and 1 or 64 bytes more), among quad strings at odd offsets, then each
    # alone in a blob that ends at its last byte and starts 0-3 bytes past a
    # 4-byte boundary; the quad's strings just under WIDE_BYTES the same way
    ring = 32
    m0 = WIDE_BYTES // (64 * ring)
    lens = [64 * f + d for m in range(m0, m0 + 4) for f in (m * ring - 1, m * ring, m * ring + 1)
            for d in (1, 64) if 64 * f + d >= WIDE_BYTES][:12]
    lens += [WIDE_BYTES - 1, WIDE_BYTES - 64, 65, 129]
    for skew in range(4):
        same("hash_long", hash_long, hash_long_reference, _on_card_tape(rng, lens, dev, skew),
             42, f"the ring's edges, skew {skew}")
        whole = torch.zeros(max(lens) + 4, dtype=torch.uint8, device=dev)
        for length in lens:
            kernel = "hash_long_wide" if length >= WIDE_BYTES else "hash_long"
            host = rng.integers(0, 256, length, dtype=np.uint8)
            blob = whole[skew: skew + length]
            blob.copy_(torch.from_numpy(host))
            whole[skew + length:] = 0xA5  # bytes past the blob's end, never read
            args = (blob, torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.full((1,), length, dtype=torch.int64, device=dev))
            before = KERNEL_LAUNCHES[kernel]
            got = hash_long(*args, 5).cpu().numpy().view(np.uint64)
            want = hash_long_reference(*args, 5).cpu().numpy().view(np.uint64)
            calls[kernel] += KERNEL_LAUNCHES[kernel] - before
            _check(KERNEL_LAUNCHES[kernel] == before + 1,
                   f"a {length}-byte string did not reach {kernel}")
            err[kernel] = max(err[kernel], abs(int(got[0]) - int(want[0])))
            _check(got[0] == want[0] == host_hash.hash_multiseed(host.tobytes(), [5])[0],
                   f"{kernel}: a {length}-byte string ending at its blob's last byte "
                   f"(skew {skew}) != plain or host")
    big = _on_card_tape(rng, [3 << 20], dev, 1)
    got = hash_long(*big[:3], 7).cpu().numpy().view(np.uint64)
    want = host_hash.hash_multiseed(big[3][big[4][0]: big[4][0] + (3 << 20)].tobytes(), [7])[0]
    err["hash_long_wide"] = max(err["hash_long_wide"], abs(int(got[0]) - int(want)))
    _check(int(got[0]) == int(want), "hash_long on a 3 MiB string != host sz_hash")

    for length in (1, 15, 16, 17, 5000, 40000, 1 << 24):
        for nonce in (0, 123456789, 2**63 + 9, 2**64 - 3):
            got = fill_random_device(length, nonce, dev)
            want = fill_random_reference(length, nonce, dev)
            calls["fill_random"] += 1
            same_bytes = torch.equal(got, want)
            if not same_bytes:
                err["fill_random"] = max(err["fill_random"],
                                         int((got.int() - want.int()).abs().max()))
            _check(same_bytes and bytes(got.cpu().numpy()) == host_hash.fill_random(length, nonce),
                   f"fill_random {length} bytes nonce {nonce}: differs from plain or host")

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                           "hash_vectors.json")) as f:
        golden = json.load(f)
    data = bytes(golden["input"])
    for seed in sorted({int(s) for _, s, _ in golden["hash"]}):
        cases = [(n, int(e)) for n, s, e in golden["hash"] if int(s) == seed]
        got = hash_batch_device([data[:n] for n, _ in cases], seed, device=dev)
        _check([int(g) for g in got] == [e for _, e in cases], f"golden sz_hash seed {seed}")
    for length, nonce, expected in golden["fill_random"]:
        _check(fill_random_device(length, int(nonce), dev).tolist() == expected,
               f"golden fill_random {length} nonce {nonce}")
    max_err.update(err)
    print(f"[kernel] hash_short: lengths 0-64 at odd offsets, 4 seeds (carry into the high "
          f"word), {len(many)} tokens: {calls['hash_short']} launches equal the plain version")
    print(f"[kernel] hash_long: lengths 65-300, 64k-1..64k+1, the 8/16 KiB buckets, 4 seeds; "
          f"hash_long_wide's ring edges (mP - 1..mP + 1 full chunks, P = 32, from "
          f"{WIDE_BYTES} B) and the quad's last lengths, at odd offsets and ending at the "
          f"blob's last byte: {calls['hash_long']} launches of hash_long (a quad a string, "
          f"under {WIDE_BYTES} B) and {calls['hash_long_wide']} of hash_long_wide equal the "
          f"plain version; a 3 MiB string (hash_long_wide) equals the host")
    print(f"[kernel] fill_random: 7 lengths x 4 nonces (one wraps the counter): "
          f"{calls['fill_random']} buffers equal the plain version and the host; "
          f"{len(golden['hash'])} + {len(golden['fill_random'])} golden vectors exact")


def _hash_main_path(dev, sync, report):
    """Phase 4f: intersect, Strs.hashes, documents, fill_random, SHA-256 and sort."""
    import hashlib

    import torch
    import stringzilla_tpu_torch as szt
    from stringzilla_tpu_torch.ops import aes_kernel, hash_kernel
    from stringzilla_tpu_torch.ops import hash as host_hash
    from stringzilla_tpu_torch.ops import intersect as ix
    from stringzilla_tpu_torch.ops import sort as sort_mod
    from stringzilla_tpu_torch.ops.pack_device import device_tape
    from stringzilla_tpu_torch.ops.sha256 import sha256_batch
    from stringzilla_tpu_torch.ops.tape import Tape

    counters = [hash_kernel.KERNEL_LAUNCHES, aes_kernel.KERNEL_LAUNCHES]
    launches = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def raw_args(dt):
        return (dt.data, torch.from_numpy(dt.starts).to(dev), torch.from_numpy(dt.lengths).to(dev))

    def raw_hash_short(args):
        """``hash_short(*args, 0)`` by its raw launch, checked against the
        wrapper once."""
        blob, starts, lengths = args
        out = torch.zeros(starts.numel(), dtype=torch.int64, device=dev)
        launch = _raw_launch("sz_hash_short", blob.data_ptr(), blob.numel(), starts.data_ptr(),
                             lengths.data_ptr(), starts.numel(), 0, out.data_ptr(),
                             *_launch_env(dev))
        launch()
        _check(torch.equal(out, hash_kernel.hash_short(*args, 0)),
               "hash_short by its raw launch != its wrapper")
        return launch

    # -- intersect: bench_hash_tokens' tokens ----------------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()

    def tokens(count):
        lens = rng.integers(4, 13, count)
        blob = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8).tobytes()
        ends = np.cumsum(lens).tolist()
        return [blob[e - n: e] for e, n in zip(ends, lens.tolist())]

    first = tokens(INTERSECT_TOKENS)
    second = [first[int(i)] for i in rng.permutation(INTERSECT_TOKENS)[: INTERSECT_TOKENS // 2]]
    second += tokens(INTERSECT_TOKENS - len(second))
    second = [second[int(i)] for i in rng.permutation(len(second))]
    print(f"[setup] intersect: 2 x {INTERSECT_TOKENS} tokens in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    ia, ib = _launched("intersect", counters, ["hash_short"],
                       lambda: szt.intersect(first, second), launches)
    call_ms = (time.perf_counter() - t0) * 1e3
    first_at, second_at = {}, {}
    for i, s in enumerate(first):
        first_at.setdefault(s, i)
    for i, s in enumerate(second):
        second_at.setdefault(s, i)
    common = sorted(first_at.keys() & second_at.keys(), key=first_at.get)
    _check(ia.tolist() == [first_at[s] for s in common]
           and ib.tolist() == [second_at[s] for s in common],
           f"intersect: {len(ia)} pairs != Python's set of {len(common)} common tokens")
    print(f"[engine] intersect 2 x {INTERSECT_TOKENS} tokens: {len(ia)} common distinct tokens, "
          f"first occurrences, equal Python's sets")
    t = [time.perf_counter()]
    a_strs, _ = ix._distinct(first)
    b_strs, _ = ix._distinct(second)
    t.append(time.perf_counter())
    a_hash = ix.hash_batch_device(a_strs, 0)
    b_hash = ix.hash_batch_device(b_strs, 0)
    t.append(time.perf_counter())
    pa, pb = ix._sorted_match(a_hash, b_hash)
    t.append(time.perf_counter())
    keep = [k for k in range(len(pa)) if a_strs[pa[k]] == b_strs[pb[k]]]
    t.append(time.perf_counter())
    _check(len(keep) == len(ia), "intersect's parts disagree with the call")
    parts = np.diff(t) * 1e3
    dt = device_tape(Tape.from_strings(a_strs), dev)
    args = raw_args(dt)
    kernel_ms = _time_ms(raw_hash_short(args), 20, sync)
    plain_ms = _time_ms(lambda: hash_kernel.hash_short_reference(*args, 0), 2, sync)
    keys = torch.from_numpy((a_hash ^ np.uint64(1 << 63)).view(np.int64)).to(dev)
    sort_ms = _time_ms(lambda: torch.sort(keys, stable=True), 20, sync)
    bound_ms, bound_by = _bound(_hash_ops(dt.lengths), _hash_bytes(dt.lengths))
    _profile(f"intersect 2 x {INTERSECT_TOKENS}", lambda: szt.intersect(first, second), sync,
             kernel_ms)
    print(f"[perf] intersect 2 x {INTERSECT_TOKENS} tokens: call {call_ms:.3f} ms = _distinct "
          f"{parts[0]:.3f} + hashing (two hash_batch_device, tape build, H2D and pull) "
          f"{parts[1]:.3f} + device sort and match {parts[2]:.3f} + exact check {parts[3]:.3f} ms")
    print(f"[perf] hash_short on {len(a_strs)} distinct tokens: kernel {kernel_ms:.4f} ms = "
          f"{len(a_strs) / kernel_ms / 1e3:.3f} Mtokens/s; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}); torch.sort of {len(a_hash)} int64 keys {sort_ms:.4f} ms")
    report["hash_short"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
    del first, second, a_strs, b_strs, dt, args, keys

    # -- Strs.hashes on a log file's lines and words ---------------------------
    path_name = _log_path()
    body = _write_log(path_name)
    try:
        f = szt.File(path_name)
        t0 = time.perf_counter()
        lines = f.splitlines()
        split_ms = (time.perf_counter() - t0) * 1e3
        lens = lines.lengths
        # every line but the closing FATAL one (52 bytes) is over 64 bytes
        _check(int(lens[:-1].min()) > 64, "a log line is not over 64 bytes")
        t0 = time.perf_counter()
        got = _launched("Strs.hashes (lines)", counters, ["hash_long"], lines.hashes, launches)
        first_ms = (time.perf_counter() - t0) * 1e3
        mirror = f._mirror
        t0 = time.perf_counter()
        again = lines.hashes()
        again_ms = (time.perf_counter() - t0) * 1e3
        _check(f._mirror is mirror and np.array_equal(again, got),
               "Strs.hashes: a second call rebuilt the mirror or differs")
        starts = torch.from_numpy(lines._starts).to(dev)
        lengths = torch.from_numpy(lens).to(dev)
        short = hash_kernel.hash_short_reference(mirror, starts, lengths, 0)
        plain = hash_kernel.hash_long_reference(mirror, starts, lengths, 0, short).cpu().numpy()
        err = _digests_err(got.view(np.int64), plain)
        _check(err == 0, f"Strs.hashes on {len(lines)} lines != the plain version on the card")
        sample = np.random.default_rng(SEED + 41).choice(len(lines), HASH_SAMPLE, replace=False)
        want = host_hash.hash_batch([bytes(lines[int(i)]) for i in sample], 0)
        _check(np.array_equal(got[sample], want), "Strs.hashes (lines) != host hash_batch")
        print(f"[engine] Strs.hashes on {len(lines)} lines of {int(lens[:-1].min())}-"
              f"{int(lens.max())} bytes and one of {int(lens[-1])}: equal the plain version on the card and the host on {HASH_SAMPLE} samples")
        args = (mirror, starts, lengths)
        routes = hash_kernel.kernel_routes(lens)  # as Strs.hashes reads them
        _check(routes["quad"] and not routes["wide"], "the lines reach hash_long_wide")
        kernel_ms = _time_ms(lambda: hash_kernel.hash_long(*args, 0, quad=True, wide=False),
                             10, sync)
        plain_ms = _time_ms(lambda: hash_kernel.hash_long_reference(*args, 0), 1, sync)
        bound_ms, bound_by = _bound(_hash_ops(lens), _hash_bytes(lens))
        _profile(f"Strs.hashes {len(lines)} lines", lines.hashes, sync, kernel_ms)
        threads, blocks = hash_kernel.hash_long_plan(len(lines), sms, "hash_long")
        print(f"[perf] Strs.hashes {len(lines)} lines ({len(f) >> 20} MiB): splitlines "
              f"{split_ms:.3f} ms; first call with the mirror's H2D {first_ms:.3f} ms; again "
              f"{again_ms:.3f} ms; hash_long kernel (a quad a string, {blocks} CTAs of "
              f"{threads}) {kernel_ms:.4f} ms [{kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}] = "
              f"{len(f) / kernel_ms / 1e6:.3f} GB/s; plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of it")
        report["hash_long"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=None, max_abs_err=err)
        del lines, starts, lengths, args, short, plain

        head = f[: WORDS_BYTES]
        t0 = time.perf_counter()
        words = head.split(b" ")
        split_ms = (time.perf_counter() - t0) * 1e3
        wl = words.lengths
        t0 = time.perf_counter()
        got = _launched("Strs.hashes (words)", counters, ["hash_short"], words.hashes, launches)
        call_ms = (time.perf_counter() - t0) * 1e3
        starts = torch.from_numpy(words._starts).to(dev)
        lengths = torch.from_numpy(wl).to(dev)
        args = (head._mirror, starts, lengths)
        plain = hash_kernel.hash_short_reference(*args, 0).cpu().numpy()
        err = _digests_err(got.view(np.int64), plain)
        report["hash_short"]["max_abs_err"] = err
        _check(err == 0, f"Strs.hashes on {len(words)} words != the plain version on the card")
        sample = np.random.default_rng(SEED + 42).choice(len(words), HASH_SAMPLE, replace=False)
        want = host_hash.hash_batch([bytes(words[int(i)]) for i in sample], 0)
        _check(np.array_equal(got[sample], want), "Strs.hashes (words) != host hash_batch")
        kernel_ms = _time_ms(raw_hash_short(args), 10, sync)
        bound_ms, bound_by = _bound(_hash_ops(wl), _hash_bytes(wl))
        print(f"[engine] Strs.hashes on {len(words)} words of {int(wl.min())}-{int(wl.max())} "
              f"bytes (the first {WORDS_BYTES >> 20} MiB split on spaces): equal the plain "
              f"version on the card and the host on {HASH_SAMPLE} samples")
        print(f"[perf] Strs.hashes {len(words)} words: split {split_ms:.3f} ms; call with the "
              f"slice's mirror H2D {call_ms:.3f} ms; hash_short kernel {kernel_ms:.4f} ms = "
              f"{len(words) / kernel_ms / 1e3:.3f} Mtokens/s; bound {bound_ms:.4f} ms ({bound_by})")
        sort_words = szt.Strs(words[:SORT_WORDS].to_list())  # a copy: the file closes
        del words, head, starts, lengths, args, plain, got
        f.close()
    finally:
        os.unlink(path_name)

    # -- documents: bench_crypto_e2e's 1000 x 100 KB, and one 3 MiB string -----
    drng = np.random.default_rng(SEED + 43)
    count, size = DOCS
    docs_blob = drng.integers(0, 256, count * size, dtype=np.uint8).tobytes()
    docs = [docs_blob[i * size: (i + 1) * size] for i in range(count)]
    docs.append(drng.integers(0, 256, DOC_BIG, dtype=np.uint8).tobytes())
    t0 = time.perf_counter()
    got = _launched("documents", counters, ["hash_long_wide"],
                    lambda: hash_kernel.hash_batch_device(docs), launches)
    call_ms = (time.perf_counter() - t0) * 1e3
    for i in (0, 1, count // 2, count - 1, count):
        _check(int(got[i]) == int(host_hash.hash_multiseed(docs[i], [0])[0]),
               f"hash_batch_device document {i} ({len(docs[i])} B) != host sz_hash")
    dt = device_tape(Tape.from_strings(docs), dev)
    args = raw_args(dt)
    _check(hash_kernel.kernel_routes(dt.lengths) == {"short": False, "quad": False,
                                                      "wide": True},
           "a document does not reach hash_long_wide")
    docs_ms = _time_ms(lambda: hash_kernel.hash_long(*args, 0, quad=False, wide=True), 3, sync)
    # the plain version steps the 3 MiB string's 49,152 chunks one launch
    # group at a time (~50 s): one call, on the host clock
    t0 = time.perf_counter()
    plain = hash_kernel.hash_long_reference(*args, 0)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _digests_err(hash_kernel.hash_long(*args, 0).cpu().numpy(), plain.cpu().numpy())
    _check(err == 0, "hash_long on the documents != the plain version on the card")
    bound_ms, bound_by = _bound(_hash_ops(dt.lengths), _hash_bytes(dt.lengths))
    threads, blocks = hash_kernel.hash_long_plan(len(dt.lengths), sms, "hash_long_wide")
    chunks = (DOC_BIG - 1) // 64 + 1  # the full ones and the deferred one, a chain each lane
    print(f"[engine] hash_batch_device on {count} x {size} B documents and one {DOC_BIG >> 20} "
          f"MiB string: 5 samples equal the host sz_hash, all the plain version")
    print(f"[perf] documents: hash_batch_device call {call_ms:.3f} ms; hash_long_wide kernel "
          f"(a warp a string, {blocks} CTAs of {threads}) {docs_ms:.4f} ms "
          f"[{docs_ms.lo:.4f}-{docs_ms.hi:.4f}] = {dt.lengths.sum() / docs_ms / 1e6:.3f} GB/s; "
          f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / docs_ms:.2f}% of it; the "
          f"{DOC_BIG >> 20} MiB string's chain of {chunks} chunks at "
          f"{docs_ms * 1e3 / chunks:.4f} us a chunk; plain {plain_ms:.3f} ms")
    report["hash_long_wide"] = dict(ms=docs_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None, max_abs_err=err)
    del docs, docs_blob, dt, args, plain

    # -- fill_random: bench_fill_random --------------------------------------
    out = _launched("fill_random", counters, ["fill_random"],
                    lambda: aes_kernel.fill_random_device(FILL_BYTES, 42), launches)
    want = aes_kernel.fill_random_reference(FILL_BYTES, 42, dev)
    same = torch.equal(out, want)
    err = 0 if same else int((out.int() - want.int()).abs().max())
    _check(same, f"fill_random_device({FILL_BYTES}, 42) != the plain version on the card")
    raw = torch.empty(FILL_BYTES, dtype=torch.uint8, device=dev)
    kernel_ms = _time_ms(_raw_launch("sz_fill_random", 42, FILL_BYTES // 16, raw.data_ptr(),
                                     *_launch_env(dev)), 10, sync)
    _check(torch.equal(raw, out), "fill_random by its raw launch != its wrapper")
    plain_ms = _time_ms(lambda: aes_kernel.fill_random_reference(FILL_BYTES, 42, dev), 1, sync)
    bound_ms, bound_by = _bound(AES_OPS * FILL_BYTES / 16, FILL_BYTES)
    print(f"[engine] fill_random_device({FILL_BYTES}, 42) equals the plain version on the card")
    print(f"[perf] fill_random {FILL_BYTES >> 20} MiB: kernel {kernel_ms:.4f} ms = "
          f"{FILL_BYTES / kernel_ms / 1e6:.3f} GB/s; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    report["fill_random"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None, max_abs_err=err)
    del out, want

    # -- SHA-256: bench_sha256's tokens and tpu_sweep's messages ---------------
    srng = np.random.default_rng(SEED + 44)
    toks = [srng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in srng.integers(4, 48, SHA_TOKENS)]
    msgs = [srng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in list(srng.integers(0, 120, 60)) + [600]]
    for name, items in (("tokens", toks), ("messages", msgs)):
        digests = sha256_batch(items)
        _check([bytes(d) for d in digests] == [hashlib.sha256(s).digest() for s in items],
               f"sha256_batch {name} != hashlib")
        ms = _host_ms(lambda: sha256_batch(items), sync, runs=2)
        print(f"[perf] sha256_batch {len(items)} {name} (plain torch on the card): {ms:.3f} ms "
              f"= {len(items) / ms / 1e3:.3f} Mmessages/s; equal hashlib")

    # -- sort: 2^20 words ------------------------------------------------------
    items = sort_words.to_list()
    t0 = time.perf_counter()
    ordered = sort_words.sort()
    sort_ms = (time.perf_counter() - t0) * 1e3
    _check(ordered.to_list() == sorted(items), "Strs.sort != Python's sorted")
    t0 = time.perf_counter()
    order = szt.argsort_strings(items, prefer_device=True)
    device_ms = (time.perf_counter() - t0) * 1e3
    _check(np.array_equal(order, sort_words.order()), "argsort_strings(prefer_device) != host")
    maxlen = int(sort_words.lengths.max())
    keys = sort_mod.pack_pgram_keys(items)
    pad = np.full(((1 << (len(items) - 1).bit_length()) - len(items), keys.shape[1]), 0xFFFFFFFF,
                  np.uint32)
    keys = np.concatenate([keys, pad])
    passes_ms = _host_ms(lambda: sort_mod._device_argsort(keys, dev), sync, runs=2)
    print(f"[engine] Strs.sort and argsort_strings(prefer_device=True) on {len(items)} words "
          f"(up to {maxlen} B) equal Python's sorted")
    print(f"[perf] sort {len(items)} words: Strs.sort (host lexsort) {sort_ms:.3f} ms; "
          f"argsort_strings(prefer_device=True) {device_ms:.3f} ms, of which the stable "
          f"torch.sort passes over {keys.shape[1]} key columns with the pull {passes_ms:.3f} ms")

    for k in ("hash_short", "hash_long", "hash_long_wide", "fill_random"):
        report[k]["launches"] = launches[k]
    print(f"[engine] launches on the hashing main path: {launches}")


def _check_stage_kernel(dev, sync, max_err):
    """Phase 3g: the stage kernel against its plain version, stage by stage
    (a call's two sweeps sharing each launch) and over whole ladders of
    1-8 stages; ``wavefront_score_mim`` on the card against the flat
    kernel."""
    import torch
    from stringzilla_tpu_torch.ops import wavefront as wf_mod
    from stringzilla_tpu_torch.ops.wavefront import (stage_batch, stage_reference,
                                                     wavefront_score, wavefront_score_mim)
    from stringzilla_tpu_torch.utils import cuda_build

    rng = np.random.default_rng(SEED + 7)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)
    err, stages, ladders = 0, 0, 0

    def checked(sweeps, *costs):
        """A stage through the kernel and the plain version from the same
        state; the plain result carries on."""
        nonlocal err, stages
        got = stage_batch(sweeps, *costs)
        want = stage_reference(sweeps, *costs)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                err = max(err, int((x.long() - y.long()).abs().max()))
        _check(err == 0, f"stage kernel != plain version on stages "
                         f"{[(sw[4], sw[5]) for sw in sweeps]}, costs {costs}")
        stages += 1
        return want

    cases = [(m, n, None, c, range(1, 9)) for m, n in STAGE_SHAPES for c in STAGE_COSTS]
    cases += [(m, n, d, c, range(1, 9)) for m, n, d in STAGE_DEND for c in STAGE_COSTS]
    cases += [(m, n, None, (0, 1, 1), (4,)) for m, n in STAGE_BIG]
    for m, n, d_end, costs, n_stages in cases:
        a, b = rng.integers(0, 4, m), rng.integers(0, 4, n)
        k = min(m, n)
        b[:k] = np.where(rng.random(k) < 0.7, a[:k], b[:k])
        if d_end is None:  # a meet-in-the-middle call's two sweeps
            d_star = (m + n) // 2
            jobs = [(up(a), up(b), d_star), (up(a[::-1]), up(b[::-1]), m + n - d_star)]
        else:
            jobs = [(up(a), up(b), d_end)]
        whole = wf_mod._sweeps(jobs, *costs, 4, checked)
        for count in n_stages:
            got = wf_mod._sweeps(jobs, *costs, count, stage_batch)
            ladders += 1
            _check(all(torch.equal(x, y) for g, w in zip(got, whole) for x, y in zip(g, w)),
                   f"stage kernel over {count} stages != plain version on {m} x {n}, {costs}")
        if d_end is None:
            got = wavefront_score_mim(a, b, *costs, device=dev)
            want = wavefront_score(a, b, *costs, device=dev)
            _check(got == want, f"wavefront_score_mim {m} x {n} {costs}: {got} != flat {want}")
    sync()
    print(f"[kernel] wavefront_stage: {stages} stages exact against the plain version from "
          f"the same state ({len(cases)} sweeps or pairs of sweeps, 4 stages each), "
          f"{ladders} whole ladders of 1-8 stages exact, on {len(STAGE_SHAPES)} shapes x "
          f"{len(STAGE_COSTS)} cost sets, d_end 2-3 and {STAGE_BIG}; the scores equal the "
          f"flat kernel")

    def stage_of(m, n, d0, d1):
        """One sweep's stage from random diagonals."""
        a, b = rng.integers(0, 4, m), rng.integers(0, 4, n)
        k = min(m, n)
        b[:k] = np.where(rng.random(k) < 0.7, a[:k], b[:k])
        D1, D2 = (rng.integers(-1000, 1000, m + 1) for _ in range(2))
        return (up(a), up(b), up(D1), up(D2), d0, d1)

    def exact(sweeps, what, costs=(0, 1, 1), card=None):
        """A stage on the card's plan, or on a plan cut to ``card`` (SMs,
        warps an SM), against the plain version."""
        nonlocal err, stages
        got = wf_mod._stage_launch(sweeps, *costs, **dict(zip(("sms", "warps_per_sm"),
                                                              card or ())))
        want = stage_reference(sweeps, *costs)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                err = max(err, int((x.long() - y.long()).abs().max()))
        _check(err == 0, f"stage kernel != plain version on {what}")
        stages += 1

    lib = cuda_build.load()
    sms, per_sm = wf_mod._stage_card(lib, dev)
    W = wf_mod.STAGE_WARPS
    one_cta_an_sm = sms * W * 32  # rows at R = 1 before the plan widens its strips
    wave = sms * (per_sm // W) * W * 32 * wf_mod.STAGE_ROWS_PER_LANE[-1]  # rows of one wave
    edges = {"strip": [32 * 5 + e for e in (-1, 0, 1)],
             "CTA": [32 * W * 3 + e for e in (-1, 0, 1)],
             "one CTA an SM": [one_cta_an_sm + e for e in (0, 1)],
             "second wave": [wave, wave + 1, 2 * wave]}
    for edge, rows in edges.items():
        for r in rows:
            m = r - 1
            plan = wf_mod.stage_plan([(m, m + 7, m, m + STAGE_EDGE_STEPS)], sms, per_sm)
            exact([stage_of(m, m + 7, m, m + STAGE_EDGE_STEPS)],
                  f"m + 1 = {r} rows ({edge} edge; R = {plan.rows_per_lane}, "
                  f"{plan.sweeps[0].strips} strips, {plan.sweeps[0].waves} waves)")
        print(f"[kernel] wavefront_stage at the {edge} edge: m + 1 = {rows} rows, "
              f"{STAGE_EDGE_STEPS} steps, exact")
    shape = lambda sweeps: [(x[0].numel(), x[1].numel(), x[4], x[5]) for x in sweeps]
    small_wave = W * 32 * wf_mod.STAGE_ROWS_PER_LANE[-1]  # rows of a wave on (1, 4)
    for card in SMALL_CARD:
        for rows in (small_wave - 1, small_wave, small_wave + 1, 2 * small_wave + 1,
                     5 * small_wave):
            m = rows - 1
            sweeps = [stage_of(m, m + STAGE_WAVE_STEPS, m, m + STAGE_WAVE_STEPS)]
            if card[0] > 1:  # and m > n, its rows above d0 - n dead
                sweeps.append(stage_of(m + 50, 250, m, m + STAGE_WAVE_STEPS))
            plan = wf_mod.stage_plan(shape(sweeps), *card)
            exact(sweeps, f"{rows} rows on {card[0]} SMs "
                          f"({[sp.waves for sp in plan.sweeps]} waves)", card=card)
    print(f"[kernel] wavefront_stage in waves on plans cut to {SMALL_CARD} (SMs, warps an SM): "
          f"{small_wave - 1}-{5 * small_wave + 50} rows, one and two sweeps, "
          f"{STAGE_WAVE_STEPS} steps, exact")
    for r in wf_mod.STAGE_ROWS_PER_LANE:  # each kernel, on the fewest SMs that pick it
        m = 32 * r * 12 - 1
        sweeps = [stage_of(m, m + 7, m - 50, m + 77), stage_of(m - 9, 300, m - 50, m + 77)]
        cut = [c for c in range(2, sms + 1)
               if wf_mod.stage_plan(shape(sweeps), c, per_sm).rows_per_lane == r]
        _check(bool(cut), f"no plan of 2-{sms} SMs takes R = {r} for {m + 1} rows")
        exact(sweeps, f"R = {r} on {cut[0]} SMs", card=(cut[0], per_sm))
    print(f"[kernel] wavefront_stage: each kernel (R in {wf_mod.STAGE_ROWS_PER_LANE}, its chunk "
          f"of 16 or 8 steps) on two sweeps of 12 and 1-2 strips, on the fewest SMs whose plan "
          f"takes that R, 127 steps, exact")
    m = STAGE_DEAD_ROWS
    exact([stage_of(m, m, 2, 60)], f"the first stage of a {m}-row sweep")
    # costs whose diagonal edge gap * d comes within int32 room of overflow:
    # the kernel sets the edge where it lies instead of by the recurrence
    m, d0 = STAGE_NO_ROOM
    exact([stage_of(m, m, d0, d0 + 200)], f"costs {STAGE_NO_ROOM_COSTS}", STAGE_NO_ROOM_COSTS)
    exact([stage_of(300, 200, 500, 501), stage_of(5, 9, 2, 3)], "the last diagonal")
    print(f"[kernel] wavefront_stage: a {STAGE_DEAD_ROWS}-row sweep's first stage (every row "
          f"past d1 - 1 dead, written BIG with no strip), the last diagonal of a matrix, and "
          f"{m} rows from d0 = {d0} under costs {STAGE_NO_ROOM_COSTS} (edges set where they "
          f"lie), exact")
    max_err["wavefront_stage"] = err


def _mim_pairs():
    """DNA of MIM_CHARS bases against a copy with MIM_RATE substitutions,
    insertions and deletions, cut to MIM_CHARS and to MIM_SHORT."""
    rng = np.random.default_rng(SEED + 8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    src = rng.choice(acgt, MIM_CHARS + 1000)
    copy = _mutate(rng, src, acgt, MIM_RATE)
    a = src[:MIM_CHARS]
    return [(a, copy[:MIM_CHARS]), (a, copy[:MIM_SHORT])]


def _stage_fill(jobs, dev, sync, sms=None):
    """Each ladder stage of the sweeps ``jobs`` (unit costs), one launch for
    all of them on the card's plan or on one cut to ``sms`` SMs: (stage,
    steps, plan, the stage's time, its pipeline fill), the fill being the
    kernel's own record of how long after the first strip of a sweep the
    last began its steps (the larger of the two sweeps')."""
    from stringzilla_tpu_torch.ops import wavefront as wf_mod
    from stringzilla_tpu_torch.utils import cuda_build

    card_sms, per_sm = wf_mod._stage_card(cuda_build.load(), dev)
    sms = sms or card_sms
    stage = lambda sweeps, fills=None: wf_mod._stage_launch(sweeps, 0, 1, 1, fills, sms=sms)
    states = [wf_mod.initial_state(a.numel(), 1, dev) for a, _, _ in jobs]
    ladders = [wf_mod.ladder(d_end) for _, _, d_end in jobs]
    rows = []
    for s in range(max(map(len, ladders))):
        live = [k for k in range(len(jobs)) if s < len(ladders[k])]
        sweeps = [(jobs[k][0], jobs[k][1], *states[k], *ladders[k][s]) for k in live]
        plan = wf_mod.stage_plan([(a.numel(), b.numel(), d0, d1)
                                  for a, b, _, _, d0, d1 in sweeps], sms, per_sm)
        t_ms = _time_ms(lambda: stage(sweeps), 1, sync, batches=3)
        fills = []
        for k, state in zip(live, stage(sweeps, fills)):
            states[k] = state
        rows.append((s, max(d1 - d0 for *_, d0, d1 in sweeps), plan, t_ms, max(fills) / 1e6))
    return rows


def _mim_main_path(dev, sync, report):
    """Phase 4g: ``wavefront_score_mim`` with no ``device=`` at full width."""
    import torch
    from stringzilla_tpu_torch.ops import wavefront as wf_mod
    from stringzilla_tpu_torch.ops.similarity import LinearGaps, SimilarityConfig, UniformCosts
    from stringzilla_tpu_torch.ops.wavefront import (BAND_KMAX, levenshtein_long_pair,
                                                     stage_batch, stage_reference,
                                                     wavefront_batch, wavefront_score,
                                                     wavefront_score_mim)

    pairs = _mim_pairs()
    runs = [(a, b, costs) for a, b in pairs for costs in ((0, 1, 1), (0, 3, 2))]
    call_ms = []

    def main_path():
        scores = []
        for a, b, costs in runs:
            t0 = time.perf_counter()
            scores.append(wavefront_score_mim(a, b, *costs))
            call_ms.append((time.perf_counter() - t0) * 1e3)
        return scores

    launches = {}
    scores = _launched("meet-in-the-middle", (wf_mod.KERNEL_LAUNCHES,), ["wavefront_stage"],
                       main_path, launches)
    for (a, b, costs), got, ms in zip(runs, scores, call_ms):
        m, n = len(a), len(b)
        if m == n and costs == (0, 1, 1):
            want, by = levenshtein_long_pair(a, b), "levenshtein_long_pair (the band kernel)"
            _check(want < BAND_KMAX, f"{m} x {n}: distance {want} is past the band")
        else:
            want, by = wavefront_score(a, b, *costs), "wavefront_score (the flat kernel)"
        _check(got == want, f"wavefront_score_mim {m} x {n} {costs}: {got} != {by} {want}")
        print(f"[engine] wavefront_score_mim {m} x {n} DNA, costs {costs}: {got}, equal to "
              f"{by}; call {ms:.3f} ms (host clock: upload, 4 stage launches, pull, combine)")

    up = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)
    for k, (a, b) in enumerate(pairs):
        m, n = len(a), len(b)
        d_star = (m + n) // 2
        jobs = [(up(a), up(b), d_star), (up(a[::-1]), up(b[::-1]), m + n - d_star)]
        sweep = lambda: wf_mod._sweep_stages(jobs, 0, 1, 1, 4)
        if k == 0:  # the kernel against its plain version at full width
            got = sweep()
            sync()
            t0 = time.perf_counter()
            want = wf_mod._sweeps(jobs, 0, 1, 1, 4, stage_reference)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(int((x.long() - y.long()).abs().max())
                      for g, w in zip(got, want) for x, y in zip(g, w))
            _check(err == 0, f"stage kernel != plain version on the {m} x {n} sweeps")
            print(f"[engine] wavefront_stage on the {m} x {n} pair's two sweeps (4 stages, "
                  f"unit costs): all four frontiers equal the plain version on the card")
        kernel_ms = _time_ms(sweep, 1, sync, batches=3)
        # as PR 8 timed its first design: stage_batch, the host waiting on each stage
        waited_ms = _time_ms(lambda: wf_mod._sweeps(jobs, 0, 1, 1, 4, stage_batch), 1, sync,
                             batches=3)
        chars = up(np.concatenate([a, b]))
        flat_ms = _time_ms(lambda: wavefront_batch(chars, [0], [m], [m], [n]), 1, sync,
                           batches=3)
        host_ms = _host_ms(lambda: wavefront_score_mim(a, b), sync, runs=2)
        steps = max(d_star, m + n - d_star)
        unit = SimilarityConfig("min", "global", LinearGaps(1), UniformCosts(0, 1))
        bound_ms, bound_by = _bound(_dp_ops_per_cell(unit) * m * n,
                                    4.0 * (m + n) + 16.0 * (m + 1))
        unfused_ms = _bound(_dp_ops_per_cell_unfused(unit) * m * n,
                            4.0 * (m + n) + 16.0 * (m + 1))[0]
        print(f"[perf] wavefront_score_mim {m} x {n}: call {host_ms:.3f} ms; wavefront_stage "
              f"{kernel_ms:.4f} ms (batches {kernel_ms.lo:.4f}-{kernel_ms.hi:.4f}) for both "
              f"sweeps' 4 launches = {m * n / kernel_ms / 1e6:.3f} GCUPS, "
              f"{kernel_ms / steps * 1e3:.4f} us a step of {steps}; wavefront_flat on the same "
              f"pair {flat_ms:.4f} ms [{flat_ms.lo:.4f}-{flat_ms.hi:.4f}], "
              f"{100 * bound_ms / flat_ms:.1f}% of the bound; bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / kernel_ms:.1f}% of the kernel's time; with the unfused "
              f"count {unfused_ms:.4f} ms, {100 * unfused_ms / kernel_ms:.1f}%"
              + (f"; plain {plain_ms:.3f} ms" if k == 0 else ""))
        print(f"[perf] wavefront_stage {m} x {n}, timed as PR 8 timed its first design "
              f"(stage_batch, the host waiting on each of the 4 stages): {waited_ms:.4f} ms "
              f"(batches {waited_ms.lo:.4f}-{waited_ms.hi:.4f}), against {kernel_ms:.4f} ms "
              f"queued")
        fill_ms = whole_ms = 0.0
        for s, stage_steps, plan, t_ms, fill in _stage_fill(jobs, dev, sync):
            fill_ms, whole_ms = fill_ms + fill, whole_ms + t_ms
            print(f"[perf] wavefront_stage {m} x {n} stage {s}: {stage_steps} steps, R = "
                  f"{plan.rows_per_lane} rows a lane, chunk {plan.chunk}, "
                  f"{[sp.strips for sp in plan.sweeps]} strips in {plan.ctas} CTAs of "
                  f"{plan.warps_per_cta} warps; {t_ms:.4f} ms ({t_ms / stage_steps * 1e3:.4f} us "
                  f"a step), fill {fill:.4f} ms")
        print(f"[perf] wavefront_stage {m} x {n}: pipeline fill {fill_ms:.4f} ms of "
              f"{whole_ms:.4f} ms over the 4 stages ({100 * fill_ms / whole_ms:.1f}%)")
        if k == 0:  # the choice of R: the plan on fewer SMs takes wider strips
            for cut in STAGE_PROBE_SMS:
                stages = _stage_fill(jobs, dev, sync, sms=cut)
                print(f"[perf] wavefront_stage {m} x {n} on a plan cut to {cut} SMs: R = "
                      f"{[x[2].rows_per_lane for x in stages]} by stage, "
                      f"{sum(x[3] for x in stages):.4f} ms over the 4 stages, fill "
                      f"{sum(x[4] for x in stages):.4f} ms")
        if k == 0:
            _profile(f"wavefront_score_mim {m} x {n}", lambda: wavefront_score_mim(a, b), sync,
                     kernel_ms)
            report["wavefront_stage"] = dict(
                launches=launches["wavefront_stage"], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, max_abs_err=err)


# -- phase 4h: the host UTF-8 layer and uncased search --------------------------

CARD = "unknown card"  # nvidia-smi's name and power limit, set by main()


def uncased_text() -> bytes:
    """Phase 4h's "ASCII text 256 MiB": ``log_body``'s lines with
    ASCII_PATHS, and each of UNCASED_WORDS put into the path of the line
    after each of len(UNCASED_WORDS) + 1 equal steps
    (``path=/api/v1/<word>/<path>``)."""
    body = log_body(paths=ASCII_PATHS)
    step = len(body) // (len(UNCASED_WORDS) + 1)
    parts, last = [], 0
    for j, word in enumerate(UNCASED_WORDS):
        at = body.index(b"path=/api/v1/", (j + 1) * step) + len(b"path=/api/v1/")
        parts += [body[last:at], word.encode() + b"/"]
        last = at
    parts.append(body[last:])
    return b"".join(parts)


def _runs(arr: np.ndarray) -> list:
    """(start, end) of each maximal run of bytes >= 0x80."""
    hi = np.flatnonzero(arr >= 0x80)
    if hi.size == 0:
        return []
    cut = np.flatnonzero(np.diff(hi) > 1)
    starts, ends = hi[np.concatenate([[0], cut + 1])], hi[np.concatenate([cut, [-1]])] + 1
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def _uncased_rounds(data: bytes, runs, got) -> int:
    """Rounds of ``ops.utf8._uncased_find_device`` to reach ``got``: a match
    holding a non-ASCII byte is found by the patch of the first run it
    touches; any other answer comes one round after the last run that
    starts before its end (for no match, the buffer's end)."""
    off, length = got
    if off >= 0 and max(data[off: off + length]) >= 0x80:
        return sum(end <= off for _, end in runs) + 1
    end = off + length if off >= 0 else len(data)
    return sum(start < end for start, _ in runs) + 1


@contextlib.contextmanager
def _no_native():
    """The host UTF-8 layer with its native library hidden: its numpy and
    Python paths."""
    from stringzilla_tpu_torch.utils import native

    lib = native.lib
    native.lib = lambda: None
    try:
        yield
    finally:
        native.lib = lib


def _uncased_main_path(dev, sync, report):
    """Phase 4h: the native runtime and UCD tables, ``Str.utf8_uncased_find``
    on the ASCII text and on the log, the host layer's tiers, Arrow."""
    import torch
    import stringzilla_tpu_torch as szt
    from stringzilla_tpu_torch.ops import find_kernel as find_mod
    from stringzilla_tpu_torch.ops import memory as memory_mod
    from stringzilla_tpu_torch.ops import segment, ucd
    from stringzilla_tpu_torch.ops import utf8 as U
    from stringzilla_tpu_torch.ops import utf8_segment as US
    from stringzilla_tpu_torch.ops.find import byteset_mask
    from stringzilla_tpu_torch.ops.find_kernel import search_positions, search_positions_reference
    from stringzilla_tpu_torch.ops.memory import lookup_reference, lookup_transform
    from stringzilla_tpu_torch.ops.tape import Tape
    from stringzilla_tpu_torch.utils import native

    # -- the native runtime and the tables -----------------------------------
    t0 = time.perf_counter()
    native.load()  # raises with g++'s message: no Python loops unnoticed
    print(f"[build] native/tapecraft.cpp -> {os.path.basename(native.lib()._name)} in "
          f"{time.perf_counter() - t0:.3f} s (g++ {' '.join(native._FLAGS)})")
    t0 = time.perf_counter()
    _check(ucd.text_available() and len(ucd.fold1()) == 0x110000 and len(ucd.ccc()) == 0x110000,
           "the UCD text tables did not build")
    text_s = time.perf_counter() - t0
    if ucd.available():
        t0 = time.perf_counter()
        _check(len(ucd.wb_classes()) == 0x110000, "the UCD segment tables did not build")
        segment_group = f"built in {time.perf_counter() - t0:.3f} s (the regex package is here)"
    else:
        segment_group = "absent (no regex package): the segmenters take their unicodedata tier"
    print(f"[build] UCD tables: text group (folding, normalization; the standard library) built "
          f"in {text_s:.3f} s; segment group (wb, gcb, sb, lb, ext_pict) {segment_group}")
    lut = U.ascii_fold_lut()
    hi_ws = byteset_mask(bytes(range(128, 256)))
    counters = (find_mod.KERNEL_LAUNCHES, memory_mod.KERNEL_LAUNCHES)
    launches = {"find_search": 0, "byte_lut": 0}
    errs = {"find_search": 0, "byte_lut": 0}

    def counted(call, lut_launches, search_launches, what):
        _reset(*counters)
        out = call()
        got = {"find_search": find_mod.KERNEL_LAUNCHES["find_search"],
               "byte_lut": memory_mod.KERNEL_LAUNCHES["byte_lut"]}
        want = {"find_search": search_launches, "byte_lut": lut_launches}
        _check(got == want, f"{what}: launches {got} != {want}")
        for k, v in got.items():
            launches[k] += v
        return out

    def held(s, n, starts, what):
        """The folded mirror against the plain LUT, and the tier's two
        searches from each of ``starts`` against the plain search."""
        mirror, folded = s._device(), s._device_folded()
        _check(torch.equal(folded, lookup_reference(mirror, lut)),
               f"byte_lut on the {what} != its plain version")
        for lo in starts:
            for hay, kw in ((folded, {"needle": np.frombuffer(b"out of memory", np.uint8)}),
                            (mirror, {"byteset_words": hi_ws})):
                got = int(search_positions(hay, n, "first", lo=lo, **kw))
                want = int(search_positions_reference(hay, n, "first", lo=lo, **kw))
                errs["find_search"] = max(errs["find_search"], abs(got - want))
                _check(got == want, f"find_search on the {what} from {lo}: {got} != plain {want}")
        print(f"[kernel] byte_lut and find_search on the {what}'s mirrors equal their plain "
              f"versions (searches from {len(starts)} starts)")

    # -- "ASCII text 256 MiB" ---------------------------------------------------
    t0 = time.perf_counter()
    data = uncased_text()
    arr = np.frombuffer(data, np.uint8)
    runs = _runs(arr)
    _check(len(runs) == len(UNCASED_WORDS), f"ASCII text: {len(runs)} non-ASCII runs")
    at = data.index(b" worker-", 3 * len(data) // 4) + 1
    needles = dict(UNCASED_NEEDLES, **{"24 bytes": data[at: at + 24].upper()})
    print(f"[setup] ASCII text: {len(data)} bytes, {len(runs)} non-ASCII runs, in "
          f"{time.perf_counter() - t0:.3f} s")
    want, native_ms = {}, {}
    for name, nd in needles.items():
        t0 = time.perf_counter()
        want[name] = U.utf8_uncased_find(data, nd)
        native_ms[name] = (time.perf_counter() - t0) * 1e3
    _check(want["strasse"][0] >= 0 and data[want["strasse"][0]:][:7] == "STRAßE".encode(),
           f"strasse: the native scan found {want['strasse']}")
    _check(want["absent"] == (-1, 0) and want["near the end"][0] > len(data) - 100,
           f"the native scan: {want}")
    got, first_ms = {}, None
    for i, (name, nd) in enumerate(needles.items()):
        sync()
        t0 = time.perf_counter()
        if i == 0:
            s = szt.Str(data)
        rounds = _uncased_rounds(data, runs, want[name])
        got[name] = counted(lambda: s.utf8_uncased_find(nd), 1 if i == 0 else 0, 1 + rounds,
                            f"ASCII text, needle {name}")
        sync()
        if i == 0:
            first_ms = (time.perf_counter() - t0) * 1e3
        _check(got[name] == want[name], f"ASCII text, {name}: {got[name]} != native {want[name]}")
        print(f"[engine] Str.utf8_uncased_find({nd!r}) on the ASCII text = {got[name]}, equal to "
              f"the native scan; {rounds} rounds, {1 + rounds} find_search launches")
    for name, nd in needles.items():
        tier = U._uncased_find_device(s._buf, U._folded_with_spans(nd)[0], dev, s._device,
                                      s._device_folded)
        _check(tier is not None and tier == want[name],
               f"ASCII text, {name}: the device tier returned {tier}, not {want[name]}")
    print(f"[engine] the device tier itself returned each needle's result on the ASCII text")
    held(s, len(data), [0, runs[10][1], runs[-1][1]], "ASCII text")
    n = len(data)
    mirror, folded = s._device(), s._device_folded()
    absent = np.frombuffer(U.utf8_fold(needles["absent"]), np.uint8)
    lut_ms = _time_ms(lambda: lookup_transform(mirror, lut), 10, sync)
    scan_ms = _time_ms(lambda: search_positions(folded, n, "first", needle=absent), 10, sync)
    set_ms = _time_ms(lambda: search_positions(mirror, n, "first", byteset_words=hi_ws), 10, sync)
    lut_bound, scan_bound = _bound(0, 2.0 * mirror.numel())[0], _bound(FIND_OPS_PER_BYTE * n, n)[0]
    print(f"[perf] uncased search, ASCII text {n} bytes [{CARD}]: first call (mirror H2D, "
          f"byte_lut fold, {1 + _uncased_rounds(data, runs, want['absent'])} searches, "
          f"{len(runs)} patches) {first_ms:.3f} ms")
    for name, nd in needles.items():
        ms = _host_ms(lambda: s.utf8_uncased_find(nd), sync, runs=2)
        print(f"[perf] uncased search, ASCII text, {name} {nd!r} [{CARD}]: Str call, mirrors "
              f"cached {ms:.3f} ms; the native scan of the same buffer {native_ms[name]:.3f} ms "
              f"({native_ms[name] / ms:.2f}x)")
    print(f"[perf] uncased search, ASCII text [{CARD}]: byte_lut over the {mirror.numel()}-byte "
          f"mirror {lut_ms:.4f} ms [{lut_ms.lo:.4f}-{lut_ms.hi:.4f}], bound {lut_bound:.4f} ms "
          f"(bytes), {100 * lut_bound / lut_ms:.1f}% of it; find_search, the absent needle over "
          f"the folded mirror (a full scan) {scan_ms:.4f} ms [{scan_ms.lo:.4f}-{scan_ms.hi:.4f}], "
          f"bound {scan_bound:.4f} ms, {100 * scan_bound / scan_ms:.1f}% of it; the byteset "
          f">= 0x80 from 0 (to the first run at {runs[0][0]}) {set_ms:.4f} ms")
    # is the absent needle's scan slow because its folded prefix "worker-"
    # is in every line, so that most warps keep a candidate past the first
    # needle byte? The same scan with a first byte that never occurs, and
    # one cut to 16 bytes (no compare of byte 16 from memory), split it
    absent_b = bytes(absent)
    probes = {"the absent needle": absent_b, "its first byte made \\x01": b"\x01" + absent_b[1:],
              "its first 16 bytes": absent_b[:16]}
    probe_ms = {name: _time_ms(lambda: search_positions(folded, n, "first", needle=
                                                       np.frombuffer(nd, np.uint8)), 10, sync)
                for name, nd in probes.items()}
    hits = {j: int(search_positions(folded, n, "count", needle=absent[:j])) for j in (1, 7, 16)}
    print(f"[perf] find_search probe, ASCII text, {n} bytes [{CARD}]: full scans of the folded "
          f"mirror: " + "; ".join(f"{name} {nd!r} {ms:.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}]"
                      for (name, nd), ms in zip(probes.items(), probe_ms.values()))
          + f"; start positions where the needle's first j bytes match: "
          + ", ".join(f"j = {j}: {c}" for j, c in hits.items()))
    del s, mirror, folded, data, arr

    # -- the 256 MiB log: dense runs, the tier gives up --------------------------
    body = log_body()
    runs = _runs(np.frombuffer(body, np.uint8))
    t0 = time.perf_counter()
    want = U.utf8_uncased_find(body, LOG_NEEDLE)
    log_native_ms = (time.perf_counter() - t0) * 1e3
    _check(want[0] > len(body) - 100, f"the log: the native scan found {want}")
    sync()
    t0 = time.perf_counter()
    s = szt.Str(body)
    got = counted(lambda: s.utf8_uncased_find(LOG_NEEDLE), 1, 1 + 64, "the log")
    sync()
    log_first_ms = (time.perf_counter() - t0) * 1e3
    _check(got == want, f"the log: {got} != native {want}")
    log_nd = U._folded_with_spans(LOG_NEEDLE)[0]
    tier = U._uncased_find_device(s._buf, log_nd, dev, s._device, s._device_folded)
    _check(tier is None, f"the log: the device tier returned {tier} over {len(runs)} runs")
    held(s, len(body), [0, runs[63][1]], "log")
    log_ms = _host_ms(lambda: s.utf8_uncased_find(LOG_NEEDLE), sync, runs=2)
    print(f"[engine] Str.utf8_uncased_find({LOG_NEEDLE!r}) on the {len(body)}-byte log = {got}, "
          f"equal to the native scan; the tier gave up after 64 of {len(runs)} runs")
    print(f"[perf] uncased search, the log [{CARD}]: first call (mirror H2D, fold, 65 searches, "
          f"64 patches, then the native scan) {log_first_ms:.3f} ms; mirrors cached {log_ms:.3f} ms;"
          f" the native scan alone {log_native_ms:.3f} ms")
    # what the 64 rounds cost: the tier alone, mirrors cached, and one round's
    # parts (each search with its host pull) at the 32nd run
    n, mirror, folded = len(body), s._device(), s._device_folded()
    tier_ms = _host_ms(lambda: U._uncased_find_device(s._buf, log_nd, dev, s._device,
                                                      s._device_folded), sync, runs=2)
    lo, (p_hi, run_end) = runs[31][1], runs[32]
    k = len(log_nd)
    w0, w1 = max(lo, p_hi - 4 * k - 8), min(n, run_end + 4 * k + 8)
    tabs = U._fold_tables()
    nd8 = log_nd.astype(np.uint8)
    round_ms = {
        "needle search": _host_ms(lambda: int(search_positions(folded, n, "first", needle=nd8,
                                                               lo=lo)), sync, runs=5),
        "byteset search": _host_ms(lambda: int(search_positions(mirror, n, "first",
                                                                byteset_words=hi_ws, lo=lo)),
                                   sync, runs=5),
        "native patch": _host_ms(lambda: native.utf8_uncased_find(
            s._buf[w0:w1], log_nd.astype(np.uint32), 0, *tabs), sync, runs=5)}
    print(f"[perf] uncased search, the log [{CARD}]: the tier alone, mirrors cached, 64 rounds "
          f"then None {tier_ms:.3f} ms; one round's parts from byte {lo}: "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in round_ms.items())
          + f" (the needle search runs once a call, the others once a round)")
    # on the card the tier never moves to the host: no native library raises,
    # before the new Str's mirrors are made
    fresh = szt.Str(body)
    with _no_native():
        try:
            fresh.utf8_uncased_find(LOG_NEEDLE)
            raised = None
        except RuntimeError as exc:
            raised = str(exc)
    _check(raised is not None and "native" in raised and fresh._mirror is None,
           f"the log with the native library hidden: raised {raised!r}, "
           f"mirror made: {fresh._mirror is not None}")
    print(f"[engine] the uncased tier on the card with the native library hidden raises "
          f"({raised[:60]}...) before any mirror is made")
    del fresh, mirror, folded
    del s

    # -- the host layer on the log ------------------------------------------------
    host = body[: body.index(b"\n", HOST_BYTES) + 1]
    for name, fn in (("utf8_fold", U.utf8_fold), ("utf8_norm NFC", lambda b: U.utf8_norm(b, "NFC"))):
        t0 = time.perf_counter()
        with_native = fn(host)
        native_s = time.perf_counter() - t0
        with _no_native():
            t0 = time.perf_counter()
            without = fn(host)
            plain_s = time.perf_counter() - t0
        _check(with_native == without, f"{name} on {len(host)} bytes: native != numpy tier")
        print(f"[engine] {name} on {len(host)} bytes of the log: native and numpy tiers equal "
              f"[{CARD}]: native {native_s * 1e3:.3f} ms, numpy {plain_s * 1e3:.3f} ms")
    if ucd.available():
        for name, fast, plain in (("utf8_words", segment.word_breaks, segment._word_breaks_py),
                                  ("utf8_graphemes", segment.grapheme_breaks,
                                   segment._grapheme_breaks_py)):
            t0 = time.perf_counter()
            a = fast(host)
            mid = time.perf_counter()
            b = plain(host)
            _check(np.array_equal(a, b), f"{name} on {len(host)} bytes: native != vectorized")
            print(f"[engine] {name} on {len(host)} bytes: native automaton and vectorized tier "
                  f"equal [{CARD}]: {1e3 * (mid - t0):.3f} ms, {1e3 * (time.perf_counter() - mid):.3f} ms")
    else:
        part = host[: host.index(b"\n", SEGMENT_BYTES) + 1]
        lines = part.splitlines(keepends=True)
        starts = np.concatenate([[0], np.cumsum([len(x) for x in lines])])
        for name, fn in (("utf8_words", US.utf8_words), ("utf8_graphemes", U.utf8_graphemes)):
            t0 = time.perf_counter()
            whole = fn(part)
            ms = (time.perf_counter() - t0) * 1e3
            by_line = [(int(o) + a, b) for o, line in zip(starts, lines) for a, b in fn(line)]
            _check(whole == by_line, f"{name} on {len(part)} bytes: whole != line by line")
            print(f"[engine] {name} on {len(part)} bytes of the log, unicodedata tier (no segment "
                  f"tables): {len(whole)} spans, equal line by line [{CARD}]: {ms:.3f} ms")

    # -- Arrow ------------------------------------------------------------------------
    strs = szt.Str(host).splitlines()[:ARROW_LINES]
    t0 = time.perf_counter()
    back = Tape.from_arrow(strs)
    ms = (time.perf_counter() - t0) * 1e3
    _check(back.to_list() == strs.to_list() and szt.Strs(back).to_list() == strs.to_list(),
           "Arrow round trip")
    print(f"[engine] Arrow: {len(strs)} lines through __arrow_c_array__ capsules and "
          f"Tape.from_arrow, equal [{CARD}]: {ms:.3f} ms")
    for k in ("find_search", "byte_lut"):
        report[k]["launches"] += launches[k]
        report[k]["max_abs_err"] = max(report[k].get("max_abs_err", 0), errs[k])
    print(f"[engine] launches on the uncased search's main path: {launches}")


def run(dev) -> list:
    """Phases 3-4h on ``dev``; returns each kernel's report entry."""
    import torch

    sync = torch.cuda.synchronize
    max_err, report = {}, {}
    phases = [("3", _check_myers_kernel), ("3b", _check_dp_kernel), ("3b", _check_lut_kernel),
              ("3c", _check_wavefront_kernel), ("3c", _check_band_kernel),
              ("3d", _check_fingerprint_kernel), ("3d", _check_rune_myers_kernel),
              ("3e", _check_find_kernel), ("3e", _check_utf8_kernel),
              ("3f", _check_hash_kernels), ("3g", _check_stage_kernel)]
    mains = [("4", _myers_main_path), ("4b", _dp_main_path), ("4c", _wavefront_main_path),
             ("4d", _fingerprint_main_path), ("4d", _utf8_main_path),
             ("4e", _buffer_main_path), ("4f", _hash_main_path), ("4g", _mim_main_path),
             ("4h", _uncased_main_path)]
    for (phase, fn), out in [(p, max_err) for p in phases] + [(m, report) for m in mains]:
        t0 = time.perf_counter()
        fn(dev, sync, out)
        print(f"[phase] {phase} {fn.__name__} in {time.perf_counter() - t0:.3f} s")
    replaces = {
        "myers_tier_a": ("stringzilla_tpu/ops/myers_pallas.py:396", "csrc/myers.cu"),
        "myers_tier_b": ("stringzilla_tpu/ops/myers_pallas.py:89", "csrc/myers.cu"),
        "similarity_dp": ("stringzilla_tpu/ops/similarity_pallas.py:78",
                          "csrc/similarity.cu"),
        "similarity_dp_warp": ("stringzilla_tpu/ops/similarity_pallas.py:78",
                               "csrc/similarity.cu"),
        "byte_lut": ("stringzilla_tpu/ops/memory_pallas.py:34", "csrc/lut.cu"),
        "wavefront_flat": ("stringzilla_tpu/ops/wavefront_pallas.py:60",
                           "csrc/wavefront.cu"),
        "wavefront_band": ("stringzilla_tpu/ops/wavefront_pallas.py:527",
                           "csrc/wavefront.cu"),
        "fingerprint_minhash": ("stringzilla_tpu/ops/fingerprints_pallas.py:70",
                                "csrc/fingerprints.cu"),
        "fingerprint_merge": ("stringzilla_tpu/ops/fingerprints_pallas.py:70",
                              "csrc/fingerprints.cu"),
        "myers_tier_a_runes": ("stringzilla_tpu/ops/myers_pallas.py:89", "csrc/myers.cu"),
        "myers_tier_b_runes": ("stringzilla_tpu/ops/myers_pallas.py:89", "csrc/myers.cu"),
        "find_search": ("stringzilla_tpu/ops/find_pallas.py:84", "csrc/find.cu"),
        "utf8_validate_count": ("stringzilla_tpu/ops/utf8_device.py:68", "csrc/utf8.cu"),
        "hash_short": ("stringzilla_tpu/ops/hash_pallas.py:119", "csrc/hash.cu"),
        "hash_long": ("stringzilla_tpu/ops/hash_pallas.py:224", "csrc/hash.cu"),
        "hash_long_wide": ("stringzilla_tpu/ops/hash_pallas.py:224", "csrc/hash.cu"),
        "fill_random": ("stringzilla_tpu/ops/aes_pallas.py:117", "csrc/hash.cu"),
        "wavefront_stage": ("stringzilla_tpu/ops/wavefront_pallas.py:243",
                            "csrc/wavefront_stage.cu"),
    }
    return [{"name": k, "route": "cuda",
             "source": f"stringzilla_tpu_torch/{src}", "replaces": tpu,
             "launches": report[k]["launches"],
             "max_abs_err": max(report[k].get("max_abs_err", 0), max_err[k]),
             "ms": report[k]["ms"], "plain_ms": report[k]["plain_ms"],
             "ms_spread": [getattr(report[k]["ms"], "lo", report[k]["ms"]),
                           getattr(report[k]["ms"], "hi", report[k]["ms"])],
             "bound_ms": report[k]["bound_ms"], "bound_by": report[k]["bound_by"],
             "library_ms": report[k]["library_ms"]}
            for k, (tpu, src) in replaces.items()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from stringzilla_tpu_torch.utils import cuda_build

    # -- phase 1: device ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    global CARD
    card = CARD = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load()
    print(f"[build] csrc/*.cu -> sm_90a in {time.perf_counter() - t0:.3f} s")
    for line in cuda_build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # -- phases 3-4h: kernels against plain versions, then the main paths ---
    t0 = time.perf_counter()
    kernels = run(torch.device("cuda", 0))
    print(f"[run] phases 3-4h in {time.perf_counter() - t0:.3f} s")

    # -- report ---------------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
