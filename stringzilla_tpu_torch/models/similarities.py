"""Batch similarity engines — the public API mirroring ``szs.*``.

Counterpart of ``stringzilla_tpu/models/similarities.py``. Call convention
matches ``LevenshteinDistances_vectorcall`` (reference
``python/stringzillas.c:581-700``):

    engine(queries, candidates=None, device=None, out=None) -> np.ndarray

``candidates=None`` computes symmetric self-similarity; distances return
``uint64`` (C ABI ``sz_size_t*``, reference ``stringzillas.h:199``), scores
return ``int64`` (``sz_ssize_t*``, ``stringzillas.h:358``).

Host-side scheduling groups strings into dyadic length buckets (the
reference's ``candidate_length_bucket_``, ``serial.hpp:3442-3444``) so every
dense block wastes < 2x on padding; each (query bucket, candidate bucket)
block is scored on the scope's device and scattered into one device result,
pulled to the host once. Unit-cost Levenshtein runs on the Myers kernel;
every other configuration (weighted or affine Levenshtein,
``NeedlemanWunschScores``, ``SmithWatermanScores``) on the column-DP kernel,
with class-cost engines mapping each collection's bytes to classes once
through the byte-LUT kernel. Every pair with a string over 4096 bytes runs
on the wavefront tier instead (``ops/wavefront.py``), all such pairs of a
call in one batch: unit costs on the band kernel, with the flat kernel for
the pairs whose distance is over its widest band, every other
configuration on the flat kernel.

``LevenshteinDistancesUTF8`` scores runes instead of bytes: each
collection is checked and counted in runes on the device
(``ops/utf8_pack_device.py``), the dyadic buckets and the 4096 threshold
are over runes, dense blocks are decoded on the device, unit costs run the
Myers kernel's rune route and other costs the column DP and the wavefront
tier over int32 runes. A collection with any malformed string is decoded
on the host instead, each maximal invalid subpart becoming U+FFFD, as the
reference does.

A scope over several devices splits every dyadic candidate bucket into
one contiguous part a device (``parallel/cross.py``): each device holds the
queries and its own candidates (their bytes gathered into a blob of their
own there, class-mapped there by the byte-LUT kernel; the rune tables built
there), scores its blocks through ``sharded_myers`` or
``sharded_similarity``, and the scores are gathered into one ``(nq, nc)``
tensor on the scope's first device, pulled once. Long pairs run on the
first device, as in the JAX package.

A long pair that reaches the flat kernel may have up to
``MAX_FLAT_CELLS`` diagonal cells (``max(m + 1, n)``); beyond that, on one
device, it raises the ``ValueError`` of the JAX package's single-device
path. In a scope over several devices such a pair is scored alone on the
ring tier (``parallel/ring.py``), its rows cut over the scope's devices,
in every configuration, as the JAX package does; the other long pairs keep
the batch on the first device.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from ..ops import wavefront as _wavefront
from ..ops.memory import lookup_transform
from ..ops.myers import build_rune_tables
from ..ops.pack_device import DeviceTape, device_tape, pack_chars
from ..ops.similarity import (AffineGaps, ClassCosts, LinearGaps,
                              SimilarityConfig, UniformCosts)
from ..ops.tape import Tape, round_up
from ..ops.utf8_pack_device import decode_pack_device, rune_count_validity
from ..ops.wavefront import config_costs, levenshtein_batch, wavefront_batch
from ..parallel.cross import sharded_myers, sharded_similarity, split_bounds
from ..parallel.ring import ring_wavefront_score
from .device_scope import DeviceScope, default_device_scope

__all__ = [
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunschScores",
    "SmithWatermanScores",
    "NeedlemanWunsch",
    "SmithWaterman",
]

_LONG_THRESHOLD = 4096  # a pair with a longer string runs on the wavefront tier


def _reject_integer_like(s) -> None:
    """Integer-like items must raise TypeError like the reference binding —
    ``bytes(n)`` would silently yield an n-byte ZERO-FILLED string."""
    try:
        operator.index(s)
    except TypeError:
        return
    raise TypeError(f"expected a string-like item, got {type(s).__name__}")


def _decode_utf8_runes(data: bytes) -> np.ndarray:
    """Decode to 32-bit runes; invalid bytes become U+FFFD (the reference's
    maximal-subpart resync, ``README.md:888-893``)."""
    return np.array([ord(c) for c in data.decode("utf-8", errors="replace")],
                    dtype=np.int32)


def _as_int_arrays(items, utf8: bool) -> list[np.ndarray]:
    """Each item's chars: an ndarray's values as they are, a string's bytes,
    or its runes when ``utf8``."""
    if isinstance(items, Tape):
        items = items.to_list()
    out = []
    for s in items:
        if isinstance(s, str):
            s = s.encode("utf-8")
        elif not isinstance(s, (bytes, np.ndarray)):
            _reject_integer_like(s)
            s = bytes(s)  # bytearray/memoryview views
        if isinstance(s, np.ndarray):
            out.append(s.astype(np.int32))
        elif utf8:
            out.append(_decode_utf8_runes(s))
        else:
            out.append(np.frombuffer(s, dtype=np.uint8).astype(np.int32))
    return out


def _offsets(lens: np.ndarray) -> np.ndarray:
    """Where each string starts when the strings are laid end to end."""
    offs = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return offs


def _spans(data: torch.Tensor, starts: np.ndarray, lens: np.ndarray) -> torch.Tensor:
    """The bytes ``data[starts[i]: starts[i] + lens[i]]`` end to end, on
    ``data``'s device, in one gather."""
    total = int(lens.sum())
    base = torch.from_numpy(starts - _offsets(lens)).to(data.device)
    pos = (torch.repeat_interleave(base, torch.from_numpy(lens).to(data.device),
                                   output_size=total)
           + torch.arange(total, device=data.device))
    return data[pos]


def _dyadic(lengths: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Smallest power of two >= max(n, minimum), elementwise: frexp's
    exponent is the exact bit length of integers below 2**53."""
    exponent = np.frexp(np.maximum(lengths, minimum) - 1)[1]
    return np.left_shift(1, exponent.astype(np.int64))


def _group_dyadic(lengths: np.ndarray) -> dict[int, np.ndarray]:
    sizes = _dyadic(np.asarray(lengths, dtype=np.int64))
    return {int(b): np.nonzero(sizes == b)[0] for b in np.unique(sizes)}


class _HostFallback(Exception):
    """Raised when a collection can't take the device-tape path:
    pre-decoded ndarray inputs, whose values are chars, not raw bytes, or
    malformed UTF-8, which needs the host's maximal-subpart U+FFFD decode."""


class _HostCollection:
    """Host-packed collection for int-array inputs and malformed UTF-8:
    each block is packed on the host and copied to the scope's device,
    where it is scored. A class-cost engine's ``b2c`` maps the char values
    by numpy indexing, as the JAX package does."""

    def __init__(self, items, device: torch.device, b2c, utf8: bool):
        arrs = _as_int_arrays(items, utf8)
        if b2c is not None:
            arrs = [b2c[a].astype(np.int32) for a in arrs]
        self._arrs = arrs
        self.lens = np.array([len(a) for a in arrs], dtype=np.int64)
        self._device = device

    def __len__(self) -> int:
        return len(self._arrs)

    def pack(self, idx, rows: int, fill: int, shift: bool = False):
        """``(rows, len(idx))`` int32 char block and ``len(idx)`` int32
        lengths, on the device; ``shift`` leaves row 0 zero and starts the
        chars at row 1."""
        block = np.full((rows, len(idx)), fill, dtype=np.int32)
        top = int(shift)
        block[:top] = 0
        for col, i in enumerate(idx):
            block[top: top + self.lens[i], col] = self._arrs[i]
        lens = self.lens[idx].astype(np.int32)
        return (torch.from_numpy(block).to(self._device),
                torch.from_numpy(lens).to(self._device))

    def part(self, idx, device: torch.device) -> "_HostCollection":
        """The strings ``idx`` as a collection of their own on ``device``."""
        col = _HostCollection.__new__(_HostCollection)
        col._arrs = [self._arrs[i] for i in idx]
        col.lens = self.lens[idx]
        col._device = device
        return col

    def chars(self, idx):
        """The int32 chars of strings ``idx``, end to end in one device
        tensor, and where each starts in it."""
        flat = np.concatenate([np.zeros(0, np.int32)] + [self._arrs[i] for i in idx])
        return (torch.from_numpy(flat.astype(np.int32)).to(self._device),
                _offsets(self.lens[idx]))


def _class_mapped_tape(dt: DeviceTape, b2c) -> DeviceTape:
    """Device tape whose blob bytes are mapped through the 256-entry
    byte→class table, by one launch of the byte-LUT kernel over the whole
    blob. Memoised on the device tape per table, so repeated engine calls
    over one collection pay it once (tapes are immutable)."""
    key = bytes(np.asarray(b2c, dtype=np.uint8))
    cache = dt.__dict__.setdefault("_class_mapped", {})
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = DeviceTape(data=lookup_transform(dt.data, b2c),
                                      starts=dt.starts, lengths=dt.lengths)
    return hit


class _DeviceCollection:
    """Device-resident collection: the byte blob rides to the device once
    and every dense block is gathered there (from the class-mapped blob for
    a class-cost engine, decoded to runes for a ``utf8`` one, whose
    ``lens`` then count runes)."""

    def __init__(self, items, device: torch.device, b2c, utf8: bool):
        if isinstance(items, Tape):
            tape = items
        else:
            conv = []
            for s in items:
                if isinstance(s, str):
                    s = s.encode("utf-8")
                elif isinstance(s, np.ndarray):
                    if s.dtype == np.uint8 and s.ndim == 1:
                        s = s.tobytes()  # values == raw bytes
                    else:
                        raise _HostFallback
                elif not isinstance(s, bytes):
                    _reject_integer_like(s)
                    s = bytes(s)  # bytearray/memoryview views
                conv.append(s)
            tape = Tape.from_strings(conv)
        dt = device_tape(tape, device)
        lens = None
        if utf8:
            lens = np.zeros(len(tape), dtype=np.int64)
            for bucket, idx in _group_dyadic(dt.lengths).items():
                counts, violations = rune_count_validity(dt, idx, bucket)
                if violations.any():
                    raise _HostFallback
                lens[idx] = counts
        self._setup(dt, b2c, utf8, lens)

    def _setup(self, dt: DeviceTape, b2c, utf8: bool, lens) -> None:
        """Holds ``dt`` (class-mapped on its device for a class-cost
        engine); ``lens`` are the rune counts of a ``utf8`` collection."""
        self._dt = dt
        self._b2c = b2c
        self._packsrc = dt if b2c is None else _class_mapped_tape(dt, b2c)
        self._utf8 = utf8
        self._byte_lens = dt.lengths
        self.lens = lens if utf8 else self._byte_lens

    def part(self, idx, device: torch.device) -> "_DeviceCollection":
        """The strings ``idx`` as a collection of their own on ``device``:
        their bytes gathered here into a blob of their own, copied there
        and class-mapped there; their rune counts this collection's."""
        lens = self._byte_lens[idx]
        blob = torch.cat([_spans(self._dt.data, self._dt.starts[idx], lens),
                          self._dt.data.new_zeros(1)]).to(device)
        col = _DeviceCollection.__new__(_DeviceCollection)
        col._setup(DeviceTape(data=blob, starts=_offsets(lens), lengths=lens), self._b2c,
                   self._utf8, self.lens[idx])
        return col

    def __len__(self) -> int:
        return len(self.lens)

    def _decode(self, idx, rows: int, fill: int, transpose: bool, shift: bool = False):
        """Dense rune block of strings ``idx``, ``rows`` runes each."""
        byte_len = int(_dyadic(self._byte_lens[idx].max(initial=0)))
        return decode_pack_device(self._dt, idx, byte_len, rows, fill=fill,
                                  transpose=transpose, shift=shift)

    def pack(self, idx, rows: int, fill: int, shift: bool = False):
        if self._utf8:
            lens = torch.from_numpy(self.lens[idx].astype(np.int32)).to(self._dt.device)
            return self._decode(idx, rows - int(shift), fill, True, shift), lens
        offs, lens = self._dt.bucket_arrays(idx)
        return (pack_chars(self._packsrc.data, offs, lens,
                           row_len=rows - int(shift), transpose=True,
                           fill=fill, shift=shift), lens)

    def chars(self, idx):
        """The int32 chars of strings ``idx`` (class ids for a class-cost
        engine, runes for a ``utf8`` one), end to end in one device tensor,
        and where each starts in it."""
        lens = self.lens[idx]
        offs = _offsets(lens)
        if self._utf8:
            return self._runes(idx, lens, offs), offs
        return _spans(self._packsrc.data, self._dt.starts[idx], lens).to(torch.int32), offs

    def _runes(self, idx, lens, offs) -> torch.Tensor:
        """The runes of strings ``idx`` end to end, decoded a byte-length
        bucket at a time."""
        dev = self._dt.device
        out = torch.empty(int(lens.sum()), dtype=torch.int32, device=dev)
        for sub in _group_dyadic(self._byte_lens[idx]).values():
            block = self._decode(idx[sub], max(int(lens[sub].max()), 1), 0, False)
            j = torch.arange(block.shape[1], device=dev)[None, :]
            valid = j < torch.from_numpy(lens[sub]).to(dev)[:, None]
            out[(torch.from_numpy(offs[sub]).to(dev)[:, None] + j)[valid]] = block[valid]
        return out


class _CrossProductEngine:
    """Shared host loop for all-pairs scoring."""

    result_dtype = np.int64
    _utf8 = False  # chars are runes, decoded from UTF-8

    def __init__(self, cfg: SimilarityConfig):
        self._cfg = cfg
        self._b2c = cfg.costs.byte_to_class_np() if cfg.uses_classes else None

    @property
    def _is_unit_cost(self) -> bool:
        """Unit-cost Levenshtein routes to the Myers bit-parallel kernel —
        the same dispatch rule as the reference (``serial.hpp:2620-2720``)."""
        return (
            self._cfg.objective == "min"
            and self._cfg.locality == "global"
            and isinstance(self._cfg.gaps, LinearGaps)
            and self._cfg.gaps.open_or_extend == 1
            and isinstance(self._cfg.costs, UniformCosts)
            and self._cfg.costs.match == 0
            and self._cfg.costs.mismatch == 1
        )

    def _collection(self, items, device: torch.device):
        try:
            return _DeviceCollection(items, device, self._b2c, self._utf8)
        except _HostFallback:
            return _HostCollection(items, device, self._b2c, self._utf8)

    def _score_long_pairs(self, qc, cc, q_long, c_long, result, scope) -> None:
        """Every pair touching a string over ``_LONG_THRESHOLD`` chars,
        scattered into ``result`` (the JAX ``_score_long_pairs``, which runs
        them one launch per pair): in one batch on the scope's first
        device, unit-cost pairs through the band tier and the rest through
        the flat wavefront kernel. Class-cost engines pass the 32x32 table
        over the collections' class-mapped chars. In a scope over several
        devices a pair over ``MAX_FLAT_CELLS`` leaves the batch and is
        scored alone over the scope by ``ring_wavefront_score``, in any
        configuration, as the JAX engine sends it to its ring."""
        cfg = self._cfg
        qi, cj = np.nonzero(q_long[:, None] | c_long[None, :])
        ring = np.zeros(len(qi), bool)
        if scope.device_count > 1:
            ring = np.maximum(qc.lens[qi] + 1, cc.lens[cj]) > _wavefront.MAX_FLAT_CELLS
        q_at = np.zeros(len(qc), np.int64)
        c_at = q_at if cc is qc else np.zeros(len(cc), np.int64)
        if cc is qc:
            used = np.union1d(qi, cj)
            chars, q_at[used] = qc.chars(used)
        else:
            q_used, c_used = np.unique(qi), np.unique(cj)
            q_chars, q_at[q_used] = qc.chars(q_used)
            c_chars, c_at[c_used] = cc.chars(c_used)
            c_at += q_chars.numel()
            chars = torch.cat([q_chars, c_chars])
        table = cfg.costs.table_np() if cfg.uses_classes else None
        dev = result.device
        for p in np.nonzero(ring)[0]:
            i, j = int(qi[p]), int(cj[p])
            q = chars[q_at[i]: q_at[i] + qc.lens[i]]
            c = chars[c_at[j]: c_at[j] + cc.lens[j]]
            result[i, j] = ring_wavefront_score(q, c, scope, **config_costs(cfg, table))
        qi, cj = qi[~ring], cj[~ring]
        if len(qi) == 0:
            return
        pairs = (chars, q_at[qi], qc.lens[qi], c_at[cj], cc.lens[cj])
        if self._is_unit_cost:
            scores = levenshtein_batch(*pairs)
        else:
            scores = wavefront_batch(*pairs, **config_costs(cfg, table))
        result[torch.from_numpy(qi).to(dev), torch.from_numpy(cj).to(dev)] = scores

    @property
    def config(self) -> SimilarityConfig:
        return self._cfg

    def _collections(self, queries, candidates, device: DeviceScope | None):
        scope = device or default_device_scope()
        qc = self._collection(queries, scope.device)
        return scope, qc, qc if candidates is None else self._collection(candidates, scope.device)

    def _cards(self, qc, cc, c_buckets, scope):
        """Each device's query collection and candidate collection, and
        where each candidate of ``cc`` lies in the latter. One device keeps
        the collections as they are; over several, each device holds every
        query and its own part of each candidate bucket (a contiguous cut
        of it), copied there once a device."""
        if scope.device_count == 1:
            return [qc], [cc], [np.arange(len(cc))]
        copies = {scope.device: qc}
        for dev in scope.devices:
            if dev not in copies:
                copies[dev] = qc.part(np.arange(len(qc)), dev)
        qcs = [copies[dev] for dev in scope.devices]
        if cc is qc:
            return qcs, qcs, [np.arange(len(cc))] * scope.device_count
        ccs, where = [], []
        for i, dev in enumerate(scope.devices):
            mine = np.concatenate([parts[i] for _, _, parts in c_buckets])
            at = np.zeros(len(cc), np.int64)
            at[mine] = np.arange(len(mine))
            ccs.append(cc.part(mine, dev))
            where.append(at)
        return qcs, ccs, where

    def _scores(self, qc, cc, scope: DeviceScope) -> torch.Tensor:
        """Every pair's score as one ``(nq, nc)`` int32 tensor on the scope's
        first device."""
        dev = scope.device
        nq, nc = len(qc), len(cc)
        result = torch.empty((nq, nc), dtype=torch.int32, device=dev)
        if nq == 0 or nc == 0:
            return result
        q_long, c_long = qc.lens > _LONG_THRESHOLD, cc.lens > _LONG_THRESHOLD
        if q_long.any() or c_long.any():
            self._score_long_pairs(qc, cc, q_long, c_long, result, scope)
        # The rest in dense blocks of short strings: a long string's dyadic
        # bucket is above the threshold. Each candidate bucket is cut into
        # one contiguous part a device.
        q_buckets = [(b, idx) for b, idx in _group_dyadic(qc.lens).items()
                     if b <= _LONG_THRESHOLD]
        c_buckets = []
        for b, idx in _group_dyadic(cc.lens).items():
            if b <= _LONG_THRESHOLD:
                cuts = split_bounds(len(idx), scope.device_count)
                c_buckets.append((b, idx, [idx[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])]))
        if not q_buckets or not c_buckets:
            return result
        qcs, ccs, where = self._cards(qc, cc, c_buckets, scope)
        # Myers reads plain query chars padded with -1 (never a byte); the
        # column DP reads the +1-shifted layout, row 0 and padding zero.
        # Myers over runes: each query block's rune tables once, for every
        # candidate block (None on the CPU, whose plain version reads none).
        unit = self._is_unit_cost
        runes = unit and self._utf8
        classes = not unit and self._cfg.uses_classes
        tables, q_blocks = {}, {}  # each device's cost table and query blocks, made there once
        for d, col in zip(scope.devices, qcs):
            if d in q_blocks:
                continue
            tables[d] = torch.from_numpy(self._cfg.costs.table_np()).to(d) if classes else None
            q_blocks[d] = []
            for q_bucket, q_idx in q_buckets:
                q_t, qlens = (col.pack(q_idx, round_up(q_bucket, 32), fill=-1) if unit
                              else col.pack(q_idx, round_up(q_bucket + 1, 8), fill=0,
                                            shift=True))
                qlens = qlens.view(-1, 1)
                q_blocks[d].append((q_t, qlens, build_rune_tables(q_t, qlens) if runes else None))
        q_rows = [torch.from_numpy(q_idx).to(dev)[:, None] for _, q_idx in q_buckets]
        for c_bucket, c_idx, parts in c_buckets:
            packed = [col.pack(at[part], c_bucket, fill=0) if len(part) else (None, None)
                      for col, at, part in zip(ccs, where, parts)]
            cands = ([c for c, _ in packed], [None if n is None else n.view(1, -1)
                                              for _, n in packed])
            c_rows = torch.from_numpy(c_idx).to(dev)[None, :]
            for j, rows in enumerate(q_rows):
                blocks = [q_blocks[d][j] for d in scope.devices]
                args = ([b[0] for b in blocks], [b[1] for b in blocks], *cands)
                if not unit:
                    result[rows, c_rows] = sharded_similarity(
                        *args, self._cfg, scope, [tables[d] for d in scope.devices])
                elif runes:
                    result[rows, c_rows] = sharded_myers(
                        *args, scope, alphabet=None, rune_tables=[b[2] for b in blocks])
                else:
                    result[rows, c_rows] = sharded_myers(*args, scope)
        return result

    def _device_scores(self, queries, candidates=None,
                       device: DeviceScope | None = None) -> torch.Tensor:
        """The engine call without the host pull: the int32 scores on the
        scope's first device, before the cast to ``result_dtype``."""
        scope, qc, cc = self._collections(queries, candidates, device)
        return self._scores(qc, cc, scope)

    def __call__(self, queries, candidates=None, device: DeviceScope | None = None,
                 out: np.ndarray | None = None) -> np.ndarray:
        scope, qc, cc = self._collections(queries, candidates, device)
        nq, nc = len(qc), len(cc)
        if out is None:
            out = np.zeros((nq, nc), dtype=self.result_dtype)
        elif out.shape != (nq, nc):
            raise ValueError(f"out must have shape {(nq, nc)}, got {out.shape}")
        if nq == 0 or nc == 0:
            return out
        result = self._scores(qc, cc, scope)
        # numpy's assignment casts as .astype(result_dtype) does, with one
        # copy: a negative score wraps in uint64 as in the JAX package.
        out[...] = result.cpu().numpy()
        return out


def _gaps_from(open: int, extend: int):
    # The reference linearizes affine gaps when open == extend
    # (``levenshtein_distance`` dispatch, serial.hpp:2620-2720).
    return LinearGaps(open) if open == extend else AffineGaps(open, extend)


class LevenshteinDistances(_CrossProductEngine):
    """Batched byte-level edit distances (reference engine
    ``szs::levenshtein_distances``, ``serial.hpp:3709-3760``; Python type
    ``python/stringzillas.c:388-470``). Unit costs run on the Myers
    kernel, any other costs on the column DP, and a pair with a string over
    4096 bytes on the wavefront tier (unit costs on its band kernel)."""

    result_dtype = np.uint64

    def __init__(self, match: int = 0, mismatch: int = 1, open: int = 1,
                 extend: int = 1, capabilities=None):
        for name, v in (("match", match), ("mismatch", mismatch), ("open", open), ("extend", extend)):
            if not (-128 <= v <= 127):
                raise ValueError(f"{name} cost must fit in 8-bit signed integer")
        del capabilities  # accepted for API parity; dispatch is automatic
        super().__init__(
            SimilarityConfig("min", "global", _gaps_from(open, extend),
                             UniformCosts(match, mismatch))
        )


class LevenshteinDistancesUTF8(LevenshteinDistances):
    """Edit distances over Unicode codepoints rather than bytes (reference
    ``levenshtein_distance_utf8``, ``serial.hpp:2800``), with any costs:
    unit costs on the Myers kernel's rune route, others on the column DP,
    pairs with a string over 4096 runes on the wavefront tier."""

    _utf8 = True


class _ScoreEngine(_CrossProductEngine):
    result_dtype = np.int64
    _locality = "global"

    def __init__(self, byte_to_class=None, class_substitution_costs=None,
                 open: int = -1, extend: int = -1, capabilities=None,
                 substitution_matrix=None):
        """Signature and defaults mirror the reference binding
        (``python/stringzillas.c:1236-1250``): positional
        ``(byte_to_class, class_substitution_costs, open=-1, extend=-1)``.
        ``substitution_matrix`` additionally accepts a dense 256x256 (or
        32x32) matrix and compresses it to the class form."""
        del capabilities  # accepted for API parity; dispatch is automatic
        if substitution_matrix is not None:
            m = np.asarray(substitution_matrix)
            if m.shape == (256, 256):
                byte_to_class, class_substitution_costs = _compress_256(m)
            elif m.shape == (32, 32):
                byte_to_class = np.arange(256, dtype=np.uint8) % 32
                class_substitution_costs = m
            else:
                raise ValueError("substitution_matrix must be 256x256 or 32x32")
        if byte_to_class is None or class_substitution_costs is None:
            raise ValueError("provide byte_to_class + class_substitution_costs "
                             "or substitution_matrix")
        costs = ClassCosts.from_arrays(byte_to_class, class_substitution_costs)
        super().__init__(
            SimilarityConfig("max", self._locality, _gaps_from(open, extend), costs)
        )


def _compress_256(matrix: np.ndarray):
    """Compress a 256x256 cost matrix into class map + 32x32 table when it has
    <= 32 distinct rows (the reference requires callers to supply the compact
    form; the dense one is accepted for convenience)."""
    rows, inverse = np.unique(matrix, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    if len(rows) > 32:
        raise ValueError("substitution matrix has more than 32 distinct byte classes")
    table = np.zeros((32, 32), dtype=np.int32)
    reps = [int(np.nonzero(inverse == k)[0][0]) for k in range(len(rows))]
    for a, ra in enumerate(reps):
        for b, rb in enumerate(reps):
            table[a, b] = matrix[ra, rb]
    return inverse.astype(np.uint8), table


class NeedlemanWunschScores(_ScoreEngine):
    """Global alignment scores (reference ``needleman_wunsch_scores``,
    ``serial.hpp:3771+``; Python type ``stringzillas.NeedlemanWunschScores``,
    ``python/stringzillas.c:1612``)."""

    _locality = "global"


class SmithWatermanScores(_ScoreEngine):
    """Local alignment scores (reference ``smith_waterman_scores``,
    ``serial.hpp:3123``; Python type ``stringzillas.SmithWatermanScores``,
    ``python/stringzillas.c:2037``)."""

    _locality = "local"


# Convenience aliases
NeedlemanWunsch = NeedlemanWunschScores
SmithWaterman = SmithWatermanScores
