"""The column DP's launch plan (``ops.similarity_dp.dp_plan``) as exact
arithmetic, and a plain PyTorch emulation of the warp route's order of work
(``csrc/similarity.cu`` ``similarity_dp_warp``: lane l owns rows 32l + 1 ..
32l + 32 of a pass of 1,024, the lanes run one column apart, lane 0 takes
the row above from row 0 or from the scratch row the previous pass's lane 31
wrote) held against ``similarity_reference`` and the JAX package's
``score_block`` in all 16 configurations, at the strip and pass edges:
query rows 32/33, 1024/1025, 2048/2049 and 4103 (a block of 4104 rows).
Tolerance: exact equality of every integer score."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops import similarity as jsim  # noqa: E402
from stringzilla_tpu_torch.ops import similarity_dp as dp_mod  # noqa: E402
from stringzilla_tpu_torch.ops.similarity import (  # noqa: E402
    BIG, MAX_ROWS, config_from, similarity_reference)
from stringzilla_tpu_torch.ops.similarity_dp import (  # noqa: E402
    PASS_ROWS, SCRATCH_CAP_BYTES, STRIP, DpPlan, dp_plan)

SMS = 132  # an H100 SXM's SMs


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("rows,nq,cand_len,nc,affine,route", [
    (1032, 16, 1024, 512, False, "warp"),    # the proteins: 8,192 pairs
    (1032, 16, 1024, 512, True, "warp"),
    (136, 64, 128, 4096, True, "thread"),    # the weighted lines: 262,144 pairs
    (112, 2, 111, 2, True, "warp"),          # phase 4c's short reads: 4 pairs
    (8, 4, 40, 300, False, "thread"),        # one strip, 1,200 pairs
    (4104, 2, 40, 64, True, "warp"),
    (2056, 1024, 2048, 1024, False, "thread"),  # a million pairs fill the card
    # the measured crossover (m x m weighted Levenshtein, 132 SMs)
    (72, 16, 64, 64, True, "thread"),        # m = 64: the thread route from 1,024 pairs
    (136, 16, 128, 64, True, "warp"),        # m = 128: 1,024 pairs, a tie
    (136, 16, 128, 256, True, "thread"),     # 4,096 pairs
    (264, 16, 256, 256, True, "warp"),       # m = 256: 4,096 pairs
    (264, 16, 256, 1024, True, "thread"),    # 16,384 pairs
    (520, 16, 512, 1024, True, "warp"),      # m = 512: 16,384 pairs
    (520, 64, 512, 1024, True, "thread"),    # 65,536 pairs
    (1032, 16, 1024, 4096, True, "warp"),    # the proteins x 8: 65,536 pairs
])
def test_plan_route(rows, nq, cand_len, nc, affine, route):
    assert dp_plan(rows, nq, cand_len, nc, affine, SMS).route == route


@pytest.mark.parametrize("rows,lanes", [(1, 1), (2, 1), (33, 1), (34, 2), (136, 5),
                                        (1025, 32), (1026, 32), (MAX_ROWS, 32)])
def test_plan_route_follows_the_crossover(rows, lanes):
    """The warp route below sms * lanes**2 * WARP_CROSSOVER pairs, the lanes
    a pass gives rows (at most 32); the thread route from there on, on any
    card."""
    assert dp_mod.warp_lanes(rows) == lanes
    for sms in (1, 8, SMS):
        edge = sms * lanes ** 2 * dp_mod.WARP_CROSSOVER
        below, at = max(1, int(np.ceil(edge)) - 1), int(np.ceil(edge))
        if below < edge:
            assert dp_plan(rows, 1, 7, below, False, sms).route == "warp"
        assert dp_plan(rows, 1, 7, at, False, sms).route == "thread"
        assert dp_plan(rows, at, 7, 1, False, sms).route == "thread"


# Query rows m (the block's rows - 1) at the strip and pass edges: the thread
# route's strips of 32, the warp route's passes of 1,024.
EDGES = [(1, 1, 1), (31, 1, 1), (32, 1, 1), (33, 2, 1), (1023, 32, 1), (1024, 32, 1),
         (1025, 33, 2), (2048, 64, 2), (2049, 65, 3), (3000, 94, 3), (4103, 129, 5)]


@pytest.mark.parametrize("m,strips,passes", EDGES)
def test_plan_passes_at_the_edges(m, strips, passes):
    """A hand-off row a pair, (D, Dd) for every candidate column or D alone
    on the linear thread route, exactly where a second strip (thread route)
    or pass (warp route) exists."""
    assert strips == -(-m // STRIP) and passes == -(-m // PASS_ROWS)
    thread = dp_plan(m + 1, 3, 50, 7, True, SMS, route="thread")
    warp = dp_plan(m + 1, 3, 50, 7, True, SMS, route="warp")
    linear = dp_plan(m + 1, 3, 50, 7, False, SMS, route="thread")
    assert (thread.route, warp.route) == ("thread", "warp")
    assert thread.scratch_bytes == 3 * 7 * (50 * 8 if strips > 1 else 0)
    assert warp.scratch_bytes == 3 * 7 * (50 * 8 if passes > 1 else 0)
    assert linear.scratch_bytes == 3 * 7 * (50 * 4 if strips > 1 else 0)
    for plan in (thread, warp, linear):
        assert (plan.q_size, plan.c_size, plan.launches) == (3, 7, 1)


@pytest.mark.parametrize("rows", [33, 1025, 2049, MAX_ROWS])
@pytest.mark.parametrize("route", ["thread", "warp"])
def test_plan_scratch_within_the_cap(rows, route):
    """Every launch's hand-off buffer fits SCRATCH_CAP_BYTES, and the
    launches cover every (query, candidate) pair exactly once."""
    for nq, cand_len, nc, cap in [(16, 4096, 512, SCRATCH_CAP_BYTES),
                                  (2048, 4096, 2048, SCRATCH_CAP_BYTES),
                                  (2, 40, 64, 40 * 8), (2, 40, 64, 40 * 8 * 2 * 9),
                                  (5, 4096, 3, 3 * 4096 * 8)]:
        try:
            dp_mod.SCRATCH_CAP_BYTES = cap
            plan = dp_plan(rows, nq, cand_len, nc, True, SMS, route=route)
        finally:
            dp_mod.SCRATCH_CAP_BYTES = SCRATCH_CAP_BYTES
        per_pair = cand_len * 8 if rows - 1 > (STRIP if route == "thread" else PASS_ROWS) else 0
        assert plan.scratch_bytes <= cap
        assert plan.scratch_bytes == plan.q_size * plan.c_size * per_pair
        assert plan.launches == -(-nq // plan.q_size) * -(-nc // plan.c_size)
        if per_pair:  # the fewest launches: one more pair would not fit
            assert (plan.q_size == nq and plan.c_size == nc) or \
                (plan.q_size * (plan.c_size + 1) * per_pair > cap) or \
                plan.c_size == nc and (plan.q_size + 1) * nc * per_pair > cap
        else:
            assert (plan.q_size, plan.c_size, plan.launches) == (nq, nc, 1)


def test_plan_raises_on_what_it_cannot_place():
    with pytest.raises(ValueError, match="route"):
        dp_plan(40, 2, 10, 2, False, SMS, route="block")
    try:
        dp_mod.SCRATCH_CAP_BYTES = 40 * 8 - 1  # less than one pair's hand-off row
        for route in ("thread", "warp"):
            with pytest.raises(ValueError, match="SCRATCH_CAP_BYTES"):
                dp_plan(2049, 2, 40, 2, True, SMS, route=route)
    finally:
        dp_mod.SCRATCH_CAP_BYTES = SCRATCH_CAP_BYTES
    with pytest.raises(ValueError, match="grid"):
        dp_plan(40, 1 << 20, 10, 1 << 20, False, SMS, route="warp")
    with pytest.raises(ValueError):
        dp_plan(0, 2, 10, 2, False, SMS)
    assert isinstance(dp_plan(1, 0, 0, 0, False, SMS), DpPlan)


def test_launch_counts_name_both_routes():
    assert set(dp_mod.KERNEL_LAUNCHES) == {"similarity_dp", "similarity_dp_warp"}
    assert dp_mod.ROUTES == {"thread": "similarity_dp", "warp": "similarity_dp_warp"}


# -- the warp route's order of work ----------------------------------------------

def warp_route_emulation(q_ext_t, qlens, cands_t, clens, cfg, table=None):
    """``similarity_dp_warp``'s order of work in plain PyTorch, every pair
    at once: per pass of 1,024 rows, per step t, lane l computes column
    t - l + 1 of its 32 rows, cell by cell, from lane l - 1's bottom row of
    step t - 1 (lane 0: row 0's boundary in the first pass, else the
    scratch row lane 31 of the pass before wrote); a global score is read
    by the lane holding row qlen, a local one reduced over the lanes."""
    rows, nq = q_ext_t.shape
    cand_len, nc = cands_t.shape
    mx = cfg.objective == "max"
    opt = torch.maximum if mx else torch.minimum
    m = qlens.view(-1).long().clamp(0, rows - 1)
    n = clens.view(-1).long().clamp(0, cand_len)
    if cfg.is_affine:
        gap, ext = cfg.gaps.open, cfg.gaps.extend
    else:
        gap, ext = cfg.gaps.open_or_extend, 0

    def boundary(k):
        if cfg.is_local:
            return k * 0
        if cfg.is_affine:
            return torch.where(k > 0, gap + ext * (k - 1), 0)
        return gap * k

    def gap_boundary(k):
        return boundary(k) + gap + ext

    def row0(j):
        b = boundary(j)
        return torch.where(j > 0, opt(b, gap_boundary(j)), b) if cfg.is_affine else b

    if cfg.uses_classes:
        padded = torch.zeros(33, 33, dtype=torch.long)
        padded[:32, :32] = table.long()
        cls = lambda x: torch.where((x >= 0) & (x < 32), x, 32)
        cost = lambda q, c: padded[cls(q), cls(c)]
    else:
        cost = lambda q, c: torch.where(q == c, cfg.costs.match, cfg.costs.mismatch)

    lane = torch.arange(32)
    k32 = torch.arange(STRIP)
    shape = (nq, nc, 32)
    best = torch.zeros(shape, dtype=torch.long)
    score = row0(n)[None, :].expand(nq, nc).clone()  # a query of no rows
    scratch = torch.zeros(nq, nc, max(cand_len, 1), 2, dtype=torch.long)
    passes = -(-m // PASS_ROWS)
    q_long = q_ext_t.long()
    for p in range(int(passes.max()) if nq else 0):
        base = p * PASS_ROWS
        live = (passes > p)[:, None, None]
        last = (passes == p + 1)[:, None, None]
        lanes = ((m - base + STRIP - 1) // STRIP).clamp(0, 32)
        top = base + STRIP * lane + 1
        valid = (m[:, None] - top[None, :] + 1).clamp(0, STRIP)  # (nq, 32)
        rows_of = top[:, None] + k32[None, :]  # (32 lanes, 32 rows)
        D = boundary(rows_of).expand(nq, nc, 32, STRIP).clone()
        I = gap_boundary(rows_of).expand(nq, nc, 32, STRIP).clone()
        qv = q_long[rows_of.clamp(max=rows - 1)].permute(2, 0, 1)  # (nq, 32, 32)
        qv = torch.where(k32[None, None, :] < valid[:, :, None], qv, 0)[:, None]
        up_prev = boundary(top - 1).expand(shape).clone()
        bot_d = torch.zeros(shape, dtype=torch.long)
        bot_dd = torch.zeros(shape, dtype=torch.long)
        for t in range(int(n.max()) + 31 if nc else 0):
            j = t - lane + 1
            active = ((j >= 1)[None, None, :] & (j[None, None, :] <= n[None, :, None])
                      & (lane[None, None, :] < lanes[:, None, None]) & live)
            jc = j.clamp(1, max(cand_len, 1))
            c = cands_t.long()[jc - 1].T[None, :, :] if cand_len else torch.zeros(1, nc, 32)
            # the shuffle: lane l takes lane l - 1's bottom row of step t - 1
            up = torch.cat([bot_d[..., :1], bot_d[..., :-1]], dim=-1)
            dd = torch.cat([bot_dd[..., :1], bot_dd[..., :-1]], dim=-1)
            if p == 0:
                up0, dd0 = row0(jc[0]).expand(nq, nc), gap_boundary(jc[0]).expand(nq, nc)
            else:
                up0, dd0 = scratch[:, :, jc[0] - 1, 0], scratch[:, :, jc[0] - 1, 1]
            up = torch.cat([up0[..., None], up[..., 1:]], dim=-1)
            dd = torch.cat([dd0[..., None], dd[..., 1:]], dim=-1)
            diag = up_prev.clone()
            new_prev = up.clone()
            D_new, I_new = D.clone(), I.clone()
            step_best = best.clone()
            for k in range(STRIP):
                sub = cost(qv[..., k], c)
                old = D[..., k]
                if cfg.is_affine:
                    I_new[..., k] = opt(old + gap, I[..., k] + ext)
                    a = opt(diag + sub, I_new[..., k])
                else:
                    a = opt(old + gap, diag + sub)
                if cfg.is_local:
                    a = opt(a, torch.zeros_like(a))
                if cfg.is_affine:
                    dd = opt(up + gap, dd + ext)
                    d = opt(a, dd)
                else:
                    d = opt(a, up + gap)
                D_new[..., k] = d
                diag, up = old, d
                if cfg.is_local:
                    row_ok = (k < valid)[:, None, :]
                    step_best = torch.where(row_ok, opt(step_best, d), step_best)
            act = active[..., None]
            D, I = torch.where(act, D_new, D), torch.where(act, I_new, I)
            up_prev = torch.where(active, new_prev, up_prev)
            bot_d = torch.where(active, up, bot_d)
            bot_dd = torch.where(active, dd, bot_dd)
            best = torch.where(active, step_best, best)
            # lane 31 hands its bottom row of column t - 30 to the next pass
            j_out = t - 30
            if 1 <= j_out <= cand_len:
                put = active[..., 31] & ~last[..., 0]
                scratch[:, :, j_out - 1, 0] = torch.where(put, bot_d[..., 31],
                                                          scratch[:, :, j_out - 1, 0])
                scratch[:, :, j_out - 1, 1] = torch.where(put, bot_dd[..., 31],
                                                          scratch[:, :, j_out - 1, 1])
        # the lane whose strip ends on row m holds D[m][n]
        holder = (last[:, :, 0] & (valid > 0)
                  & (top[None, :] + valid - 1 == m[:, None]))  # (nq, 32)
        at = (valid - 1).clamp(min=0)[:, None, :, None].expand(nq, nc, 32, 1)
        held = D.gather(-1, at)[..., 0]
        for lane_i in range(32):
            score = torch.where(holder[:, None, lane_i], held[..., lane_i], score)
    if cfg.is_local:
        red = best.amax(-1) if mx else best.amin(-1)
        return opt(red, torch.zeros_like(red)).int()
    bad = (qlens.view(-1) < 0) | (qlens.view(-1) >= rows)
    return torch.where(bad[:, None], -BIG if mx else BIG, score).int()


# Queries of 32/33, 1024/1025, 2048/2049 and 4103 rows (and 0) in one block of
# 4104 rows, against candidates of 0-24 chars (0, 1 and 24 among them).
EDGE_QLENS = [0, 32, 33, 1024, 1025, 2048, 2049, 4103]
CONFIGS = list(itertools.product(("min", "max"), ("global", "local"),
                                 (False, True), (False, True)))
_GAPS = {("min", False): 2, ("max", False): -3, ("min", True): (3, 1), ("max", True): (-5, -1)}


def _edge_block(classes):
    rng = np.random.default_rng(1025)
    lo, hi = (0, 40) if classes else (-1, 4)  # class ids >= 32 cost 0
    rows, cand_len, nc = MAX_ROWS, 24, 6
    q_t = np.zeros((rows, len(EDGE_QLENS)), np.int32)
    for i, m in enumerate(EDGE_QLENS):
        q_t[1: m + 1, i] = rng.integers(lo, hi, m)
    c_lens = np.array([0, 1, 24, 17, 24, 9], np.int32)
    c_t = np.zeros((cand_len, nc), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(lo, hi, n)
    c_t[:24, 4] = q_t[1025 - 23: 1025 + 1, 4]  # a copy of rows across a pass edge
    return (q_t, np.array(EDGE_QLENS, np.int32).reshape(-1, 1), c_t, c_lens.reshape(1, -1))


@pytest.mark.parametrize(
    "objective,locality,affine,classes", CONFIGS,
    ids=["-".join([o, l, "affine" if a else "linear", "classes" if c else "uniform"])
         for o, l, a, c in CONFIGS])
def test_warp_route_order_matches_reference_and_jax(objective, locality, affine, classes):
    table = np.random.default_rng(7).integers(-6, 7, (32, 32)).astype(np.int32)
    g = _GAPS[objective, affine]
    gaps = jsim.AffineGaps(*g) if affine else jsim.LinearGaps(g)
    costs = (jsim.ClassCosts.from_arrays(np.arange(256) % 64, table) if classes
             else jsim.UniformCosts(-1, 2) if objective == "min" else jsim.UniformCosts(3, -2))
    jcfg = jsim.SimilarityConfig(objective, locality, gaps, costs)
    cfg = config_from(jcfg)
    arrays = _edge_block(classes)
    q_t, qlens, c_t, clens = (torch.from_numpy(a) for a in arrays)
    t_table = torch.from_numpy(table) if classes else None

    got = warp_route_emulation(q_t, qlens, c_t, clens, cfg, t_table)
    plain = similarity_reference(q_t, qlens, c_t, clens, cfg, t_table)
    jax_table = jnp.asarray(table) if classes else None
    want = np.stack([np.asarray(jsim.score_block(
        jnp.asarray(arrays[0][:, i: i + 1]), jnp.int32(arrays[1][i, 0]), jnp.asarray(arrays[2]),
        jnp.asarray(arrays[3]), jcfg, table=jax_table))[0] for i in range(len(EDGE_QLENS))])
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_route_emulation_on_a_global_pair_with_no_row_qlen():
    """A global pair whose qlen is not a row of the block scores the discard
    sentinel on the warp route too (the JAX masked reduce)."""
    cfg = config_from(jsim.SimilarityConfig("max", "global", jsim.LinearGaps(-1),
                                            jsim.UniformCosts(1, -1)))
    q_t = torch.zeros((40, 3), dtype=torch.int32)
    qlens = torch.tensor([[40], [-1], [5]], dtype=torch.int32)
    c_t = torch.ones((3, 2), dtype=torch.int32)
    clens = torch.tensor([[3, 0]], dtype=torch.int32)
    got = warp_route_emulation(q_t, qlens, c_t, clens, cfg)
    want = similarity_reference(q_t, qlens, c_t, clens, cfg)
    assert torch.equal(got, want)
    assert got[0].tolist() == got[1].tolist() == [-BIG, -BIG]
