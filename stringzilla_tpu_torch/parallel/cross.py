"""Cross-products, searches, hashes, sorts and fingerprints split over the
devices of a ``DeviceScope``.

Counterpart of ``stringzilla_tpu/parallel/cross.py``, which runs one
``shard_map`` program over a mesh. Here each function takes a scope where
the JAX one takes a mesh, cuts its work into one contiguous part a device,
enqueues every device's part on that device in turn (each kernel's wrapper
sets the current device and its stream around the launch), and gathers the
parts on the scope's first device (``scope.device``). Every device's
launches are enqueued before the first pull, so that cards run side by
side. A scope may list one device several times (``DeviceScope(devices=
["cpu"] * 8)``): its parts then run one after another there, with the same
results. The array arguments follow the port's own ops: ``ops.myers.myers``,
``ops.similarity_dp.similarity``, ``ops.find_kernel.search_positions``,
``ops.hash_kernel.hash_tokens_raw`` and ``ops.fingerprints_kernel.
fingerprint_all``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.find import _host_bytes
from ..ops.find_kernel import search_positions
from ..ops.fingerprints_kernel import fingerprint_all
from ..ops.hash_kernel import hash_long, hash_short, kernel_routes
from ..ops.myers import myers
from ..ops.similarity import SimilarityConfig
from ..ops.similarity_dp import similarity
from ..ops.sort import argsort_rows

__all__ = [
    "split_bounds",
    "sharded_similarity",
    "sharded_myers",
    "sharded_find",
    "sharded_rfind",
    "sharded_count",
    "sharded_hashes",
    "sharded_argsort",
    "sharded_fingerprints",
]


def split_bounds(n: int, parts: int) -> np.ndarray:
    """``parts + 1`` offsets that cut ``n`` items into contiguous parts
    whose sizes differ by at most one, the larger parts first."""
    base, extra = divmod(int(n), int(parts))
    sizes = np.full(parts, base, dtype=np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def _gather(outs: list, device: torch.device, dim: int) -> torch.Tensor:
    """The devices' results, in device order, as one tensor on ``device``."""
    if len(outs) == 1:
        return outs[0].to(device)
    return torch.cat([o.to(device) for o in outs], dim=dim)


def _replicated(x, devices) -> list:
    """``x`` on every device: a tensor copied once to each distinct device,
    or a list that already holds one tensor a device."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(devices):
            raise ValueError(f"{len(x)} per-device tensors for {len(devices)} devices")
        for t, dev in zip(x, devices):
            if t is not None and t.device != dev:
                raise ValueError(f"a per-device tensor is on {t.device}, not {dev}")
        return list(x)
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
    return [copies[dev] for dev in devices]


def _column_parts(cands_t, clens, devices) -> tuple[list, list]:
    """Each device's contiguous part of the candidate columns: cut here
    from one tensor each, or given as lists of one part a device (None
    where a device has none)."""
    if isinstance(cands_t, (list, tuple)):
        return _replicated(cands_t, devices), _replicated(clens, devices)
    cuts = split_bounds(cands_t.shape[1], len(devices))
    parts = [(cands_t[:, a:b].contiguous().to(dev), clens[:, a:b].contiguous().to(dev))
             for a, b, dev in zip(cuts[:-1], cuts[1:], devices)]
    return [p[0] for p in parts], [p[1] for p in parts]


def _cross(score, scope, q_t, qlens, cands_t, clens, per_device) -> torch.Tensor:
    """``score(q, qlens, cands, clens, extra)`` on each device's candidate
    part against the replicated queries, gathered into ``(n_queries,
    n_cands)`` on the first device. A device with no candidates launches
    nothing."""
    devs = scope.devices
    qs, qls = _replicated(q_t, devs), _replicated(qlens, devs)
    cs, cls = _column_parts(cands_t, clens, devs)
    outs = [score(qs[i], qls[i], cs[i], cls[i], per_device[i]) for i in range(len(devs))
            if cs[i] is not None and cs[i].shape[1] > 0]
    if not outs:
        return torch.empty((qs[0].shape[1], 0), dtype=torch.int32, device=scope.device)
    return _gather(outs, scope.device, 1)


def sharded_myers(q_t, qlens, cands_t, clens, scope, alphabet=256, *,
                  rune_tables=None) -> torch.Tensor:
    """Candidate-split ``ops.myers.myers``: queries replicated, each
    device scoring its contiguous part of the candidate columns; the
    ``(n_queries, n_cands)`` int32 distances gathered on the scope's first
    device.

    ``q_t`` ``(rows, n_queries)`` and ``qlens`` ``(n_queries, 1)`` are one
    tensor each, copied to every device, or lists of one a device.
    ``cands_t`` ``(cand_len, n_cands)`` and ``clens`` ``(1, n_cands)`` are
    one tensor each, cut here, or lists of each device's part on that
    device (None where it has none), as the engines pack them.
    ``rune_tables`` (runes only) is None or a list of each device's
    ``build_rune_tables`` of its query block."""
    tables = list(rune_tables) if rune_tables is not None else [None] * scope.device_count
    return _cross(lambda q, ql, c, cl, t: myers(q, ql, c, cl, alphabet, rune_tables=t),
                  scope, q_t, qlens, cands_t, clens, tables)


def sharded_similarity(q_ext_t, qlens, cands_t, clens, cfg: SimilarityConfig, scope,
                       table=None) -> torch.Tensor:
    """Candidate-split ``ops.similarity_dp.similarity``, with its arguments
    laid out as ``sharded_myers`` takes them; ``table`` (class costs) is
    replicated like the queries: one tensor, or a list of one a device."""
    tables = (_replicated(table, scope.devices) if table is not None
              else [None] * scope.device_count)
    return _cross(lambda q, ql, c, cl, t: similarity(q, ql, c, cl, cfg, t),
                  scope, q_ext_t, qlens, cands_t, clens, tables)


def _search(haystack, needle, scope, mode: str):
    """``(answer or None, n, k)``: each device searches its shard of
    ``ceil(n / device_count)`` start positions, with the ``k - 1`` bytes
    after it (the halo) so that a match across a shard's end is found by
    the shard it starts in, and only there (``_halo_blocks`` of the JAX
    module); the answers are pulled once and combined on the host as
    ``pmin``, ``pmax`` and ``psum`` combine them there. None when the
    needle is empty or longer than the haystack."""
    nd = _host_bytes(needle)
    k = int(nd.shape[0])
    if isinstance(haystack, torch.Tensor):
        if haystack.dtype != torch.uint8 or haystack.dim() != 1:
            raise TypeError("a tensor haystack must be 1-D uint8")
        hay = haystack.contiguous()
        n = hay.numel()
    else:
        host = _host_bytes(haystack)
        n = int(host.shape[0])
    if k == 0 or n < k:
        return None, n, k
    shard = -(-n // scope.device_count)
    found = []
    for d, dev in enumerate(scope.devices):
        start = d * shard
        if start > n - k:  # no start position here or in a later shard
            break
        end = min(n, start + shard + k - 1)
        block = (hay[start:end].to(dev) if isinstance(haystack, torch.Tensor)
                 else torch.from_numpy(host[start:end].copy()).to(dev))
        found.append((start, search_positions(block, end - start, mode, needle=nd,
                                              hi=shard - 1)))
    got = torch.stack([r.to(scope.device) for _, r in found]).tolist()  # the one pull
    if mode == "count":
        return sum(got), n, k
    hits = [start + p for (start, _), p in zip(found, got) if p >= 0]
    if not hits:
        return -1, n, k
    return (min(hits) if mode == "first" else max(hits)), n, k


def sharded_find(haystack, needle, scope) -> int:
    """``sz_find`` with the haystack split over the scope's devices:
    ``search_positions`` on each shard (the ``find_search`` kernel on a
    card, its plain version on the CPU), exact for any needle length.
    ``haystack`` is a 1-D uint8 tensor (a device's shard is a view of it
    there, or a copy on another device) or byte-like, copied."""
    got, n, k = _search(haystack, needle, scope, "first")
    if k == 0:
        return 0
    return -1 if got is None else int(got)


def sharded_rfind(haystack, needle, scope) -> int:
    """``sz_rfind`` split as ``sharded_find``."""
    got, n, k = _search(haystack, needle, scope, "last")
    if k == 0:
        return n
    return -1 if got is None else int(got)


def sharded_count(haystack, needle, scope) -> int:
    """Overlapping occurrence count, split as ``sharded_find``; the shards'
    counts summed."""
    got, n, k = _search(haystack, needle, scope, "count")
    if k == 0:
        return n + 1
    return 0 if got is None else int(got)


def _spans_part(blob, starts: np.ndarray, lengths: np.ndarray, dev: torch.device):
    """The bytes that the spans ``starts``/``lengths`` cover, with one zero
    byte after them, as a blob on ``dev``, and the spans' starts in it."""
    lo = int(starts.min())
    hi = max(int((starts + lengths).max()), lo)
    if isinstance(blob, torch.Tensor):
        part = torch.cat([blob[lo:hi], blob.new_zeros(1)]).to(dev)
    else:
        host = np.zeros(hi - lo + 1, dtype=np.uint8)
        host[:-1] = np.asarray(blob, dtype=np.uint8).reshape(-1)[lo:hi]
        part = torch.from_numpy(host).to(dev)
    return part, starts - lo


def _host_spans(starts, lengths) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(starts, torch.Tensor):
        starts = starts.cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
    if starts.shape != lengths.shape:
        raise ValueError(f"starts {starts.shape} and lengths {lengths.shape} differ")
    return starts, lengths


def sharded_hashes(blob, starts, lengths, seed: int, scope) -> torch.Tensor:
    """``hash_tokens_raw`` with the tokens split into contiguous parts,
    one a device: each device gets the bytes its tokens span and hashes
    them with the kernels their host lengths need; the int64 digest bits
    are concatenated on the scope's first device. ``blob`` is a 1-D uint8
    tensor on any device or a host byte array; ``starts`` and ``lengths``
    int64 host arrays (tensors are pulled once, before any launch)."""
    starts, lengths = _host_spans(starts, lengths)
    cuts = split_bounds(len(starts), scope.device_count)
    outs = []
    for a, b, dev in zip(cuts[:-1], cuts[1:], scope.devices):
        if a == b:
            continue
        part, s = _spans_part(blob, starts[a:b], lengths[a:b], dev)
        s, lens = torch.from_numpy(s).to(dev), torch.from_numpy(lengths[a:b].copy()).to(dev)
        out = torch.zeros(b - a, dtype=torch.int64, device=dev)
        routes = kernel_routes(lengths[a:b])
        if routes["short"]:
            hash_short(part, s, lens, seed, out)
        if routes["quad"] or routes["wide"]:
            hash_long(part, s, lens, seed, out, quad=routes["quad"], wide=routes["wide"])
        outs.append(out)
    if not outs:
        return torch.zeros(0, dtype=torch.int64, device=scope.device)
    return _gather(outs, scope.device, 0)


def _u32_columns(keys: np.ndarray) -> np.ndarray:
    """An integer key matrix as int64 columns of u32 values in the same
    lexicographic order: signed columns offset by half their range, 64-bit
    columns split into a high and a low word."""
    if keys.dtype == np.bool_ or keys.dtype.kind == "u" and keys.dtype.itemsize <= 4:
        return keys.astype(np.int64)
    if keys.dtype.kind == "i" and keys.dtype.itemsize <= 4:
        return keys.astype(np.int64) + (1 << 31)
    if keys.dtype.kind in "iu":
        u = keys.astype(np.int64).view(np.uint64)
        if keys.dtype.kind == "i":
            u = u ^ np.uint64(1 << 63)
        words = np.stack([u >> np.uint64(32), u & np.uint64(0xFFFFFFFF)], axis=2)
        return words.reshape(keys.shape[0], 2 * keys.shape[1]).astype(np.int64)
    raise TypeError(f"sharded_argsort sorts integer keys, not {keys.dtype}")


def _packed(k: torch.Tensor) -> torch.Tensor:
    """Each pair of u32 columns as one int64 in the same order."""
    if k.shape[1] % 2:
        k = torch.cat([k, torch.zeros_like(k[:, :1])], dim=1)
    return (k[:, 0::2] - (1 << 31)) * (1 << 32) + k[:, 1::2]


def _less(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row by row, whether ``x`` orders before ``y`` lexicographically."""
    lt = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    eq = torch.ones_like(lt)
    for c in range(x.shape[1]):
        lt |= eq & (x[:, c] < y[:, c])
        eq &= x[:, c] == y[:, c]
    return lt


def _rank(rows: torch.Tensor, probes: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """For each probe row, how many of the sorted ``rows`` order before it
    (or are equal, with ``inclusive``): a binary search, all probes at
    once."""
    n = rows.shape[0]
    pos = torch.zeros(probes.shape[0], dtype=torch.int64, device=probes.device)
    step = 1 << (n.bit_length() - 1) if n else 0
    while step:
        nxt = pos + step
        row = rows[(nxt - 1).clamp(max=n - 1)]
        before = ~_less(probes, row) if inclusive else _less(row, probes)
        pos = torch.where((nxt <= n) & before, nxt, pos)
        step >>= 1
    return pos


def _merge(a: tuple, b: tuple) -> tuple:
    """Two sorted runs ``(rows, positions)``, ``a`` before ``b`` in the
    input, as one: a row of ``a`` goes after the rows of ``b`` that order
    before it, a row of ``b`` after those of ``a`` that order before it or
    equal it, so that equal keys keep their input order."""
    (ra, ia), (rb, ib) = a, b
    if ra.shape[0] == 0 or rb.shape[0] == 0:
        return b if ra.shape[0] == 0 else a
    dev = ra.device
    at_a = torch.arange(ra.shape[0], device=dev) + _rank(rb, ra, inclusive=False)
    at_b = torch.arange(rb.shape[0], device=dev) + _rank(ra, rb, inclusive=True)
    rows = torch.empty((ra.shape[0] + rb.shape[0], ra.shape[1]), dtype=ra.dtype, device=dev)
    idx = torch.empty(rows.shape[0], dtype=torch.int64, device=dev)
    rows[at_a], rows[at_b] = ra, rb
    idx[at_a], idx[at_b] = ia, ib
    return rows, idx


def sharded_argsort(keys, scope, num_keys: int | None = None) -> torch.Tensor:
    """Stable lexicographic argsort of the rows of an integer ``(n, w)``
    key matrix (a numpy array, or a tensor, pulled once), its first
    ``num_keys`` columns the keys (all when None): the order of the JAX
    ``lax.sort`` over the columns and an index column, and of
    ``np.lexsort`` over the reversed key columns. int64 positions on the
    scope's first device.

    The rows are cut into contiguous parts, one a device; each device
    sorts its part with ``ops.sort.argsort_rows`` (stable ``torch.sort``
    passes over pairs of u32 columns). The sorted parts go to the first
    device and are merged there two at a time, neighbours in input order,
    up a tree: a row's place in a merge is its place in its own run plus
    the rows of the other run that go before it, counted by a binary
    search over the other run (rows of the earlier run that equal it go
    first). So equal keys keep their input order across parts as well."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    keys = np.asarray(keys)
    if keys.ndim != 2:
        raise ValueError(f"keys must be (n, w), got shape {keys.shape}")
    nk = keys.shape[1] if num_keys is None else int(num_keys)
    cols = _u32_columns(keys[:, :nk])
    cuts = split_bounds(keys.shape[0], scope.device_count)
    runs = []
    for a, b, dev in zip(cuts[:-1], cuts[1:], scope.devices):
        if a == b:
            continue
        part = torch.from_numpy(np.ascontiguousarray(cols[a:b])).to(dev)
        order = argsort_rows(part)
        runs.append((_packed(part[order]), order + int(a)))
    runs = [(r.to(scope.device), i.to(scope.device)) for r, i in runs]
    if not runs:
        return torch.zeros(0, dtype=torch.int64, device=scope.device)
    while len(runs) > 1:
        runs = [_merge(*runs[j:j + 2]) if j + 1 < len(runs) else runs[j]
                for j in range(0, len(runs), 2)]
    return runs[0][1]


def sharded_fingerprints(blob, starts, lengths, params_on, scope):
    """``fingerprint_all`` with the documents split into contiguous parts,
    one a device: each device gets the bytes its documents span and plans
    its own part; ``params_on(device)`` gives the kernel parameters there
    (``Fingerprints._params_on``, made once a device). ``blob`` is a host
    byte array or a 1-D uint8 tensor, ``starts`` and ``lengths`` int64 host
    arrays. The two ``(n, ndim)`` int32 results are concatenated on the
    scope's first device."""
    starts, lengths = _host_spans(starts, lengths)
    cuts = split_bounds(len(starts), scope.device_count)
    outs = []
    for a, b, dev in zip(cuts[:-1], cuts[1:], scope.devices):
        if a == b:
            continue
        part, s = _spans_part(blob, starts[a:b], lengths[a:b], dev)
        # starts and lengths stay on the host, where each device's plan is made
        outs.append(fingerprint_all(part, torch.from_numpy(s),
                                    torch.from_numpy(lengths[a:b].copy()), params_on(dev)))
    if not outs:
        ndim = params_on(scope.device)["width"].numel()
        empty = torch.zeros((0, ndim), dtype=torch.int32, device=scope.device)
        return empty, empty.clone()
    return (_gather([h for h, _ in outs], scope.device, 0),
            _gather([c for _, c in outs], scope.device, 0))
