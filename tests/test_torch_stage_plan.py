"""The stage kernel's strip plan (``ops/wavefront.py`` ``stage_plan``), on
the CPU: where each sweep's rows go (strips of ``32 * R`` rows a warp,
CTAs, waves), what the plan assumes of the card, and the hand-off
buffer's size, over shapes from one row to ``m = 2**28 - 1``, one and two
sweeps, ``m > n`` and ``m < n``, and rows at strip, CTA and wave edges.
The plan is pure arithmetic: every check is exact."""

import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu_torch.ops import wavefront as wf  # noqa: E402
from stringzilla_tpu_torch.ops.wavefront import (  # noqa: E402
    STAGE_RING, STAGE_ROWS_PER_LANE, STAGE_WARPS, ladder, stage_chunk, stage_plan)

H100 = (132, 8)  # SMs, warps an SM holds at R = 32
TOP = (1 << 28) - 1  # the largest m and n the kernel takes


def _check(sweeps, sms, warps_per_sm):
    """Every property the kernel relies on, for ``sweeps`` [(m, n, d0, d1)]."""
    plan = stage_plan(sweeps, sms, warps_per_sm)
    R, W = plan.rows_per_lane, plan.warps_per_cta
    h = 32 * R
    assert R in STAGE_ROWS_PER_LANE and W == STAGE_WARPS
    assert plan.chunk == stage_chunk(R) == (16 if R <= 16 else 8)
    # the card holds every CTA at once: no more warps an SM than it has
    assert plan.ctas <= sms * plan.ctas_per_sm
    assert plan.ctas_per_sm * W <= warps_per_sm
    first_cta, off = 0, 8
    for (m, n, d0, d1), sp in zip(sweeps, plan.sweeps):
        lo, hi = max(d0 - n, 0), min(d1 - 1, m)
        assert sp.first_cta == first_cta and sp.ring_offset == off
        first_cta += sp.ctas
        off += 24 + sp.ctas * (STAGE_RING + 1) * 8
        if d1 == d0:  # a stage of no steps copies its input: no strip
            assert sp.strips == sp.ctas == sp.waves == 0
            continue
        assert lo <= hi and (sp.lo, sp.hi) == (lo, hi)
        # every live row lies in exactly one strip: the strips tile
        # [first_strip * h, (first_strip + strips) * h) and that holds [lo, hi]
        assert sp.strips >= 1 and sp.ctas >= 1  # at least one warp
        assert sp.first_strip * h <= lo < (sp.first_strip + 1) * h
        assert (sp.first_strip + sp.strips - 1) * h <= hi < (sp.first_strip + sp.strips) * h
        # every other row of 0..m is dead at every step of the stage
        assert all(i < d0 - n or i > d1 - 1 for i in (sp.first_strip * h - 1,
                                                      (sp.first_strip + sp.strips) * h)
                   if 0 <= i <= m)
        # strip s runs in wave s // G on warp s % G of the sweep's G warps:
        # one wave, one warp, each (wave, warp) once
        G = sp.ctas * W
        assert (sp.waves - 1) * G < sp.strips <= sp.waves * G
        # a wave of more than one strip a warp has a column; one wave none
        if sp.waves > 1:
            assert sp.column_offset >= plan.zeroed_bytes
            assert sp.column_offset + 16 * (d1 - d0) <= plan.handoff_bytes
        else:
            assert sp.column_offset == -1
    assert first_cta <= plan.ctas and plan.zeroed_bytes == off
    # the buffer: what the card's CTAs need, plus two columns a sweep in waves
    budget = sms * (warps_per_sm // W)
    steps = [d1 - d0 for _, _, d0, d1 in sweeps]
    bound = 8 + 24 * len(sweeps) + max(budget, len(sweeps)) * (STAGE_RING + 1) * 8
    assert plan.zeroed_bytes <= bound
    assert plan.handoff_bytes <= bound + 16 * sum(steps)
    if all(sp.waves <= 1 for sp in plan.sweeps):
        assert plan.handoff_bytes == plan.zeroed_bytes
    assert plan.shared_bytes == W * (STAGE_RING + 1) * 8
    return plan


def _mim(m, n):
    """Both sweeps of each ladder stage of a meet-in-the-middle call."""
    d = (m + n) // 2
    return [[(m, n, d0, d1), (m, n, e0, e1)]
            for (d0, d1), (e0, e1) in zip(ladder(d), ladder(m + n - d))]


_SHAPES = [(1, 1), (1, 7), (7, 1), (31, 40), (300, 280), (280, 300), (4001, 7919),
           (7919, 4001), (180_000, 180_000), (180_000, 150_000), (150_000, 180_000),
           (1_000_000, 999_000), (1 << 22, 3 << 20), (TOP, TOP), (TOP, 12_345), (12_345, TOP)]


@pytest.mark.parametrize("m,n", _SHAPES, ids=[f"{m}x{n}" for m, n in _SHAPES])
def test_ladder_stages_of_both_sweeps(m, n):
    for sweeps in _mim(m, n):
        _check(sweeps, *H100)
        _check(sweeps[:1], *H100)


_CARDS = [(1, 8), (2, 4), (8, 8), (66, 8), (132, 16)]


@pytest.mark.parametrize("sms,per_sm", _CARDS, ids=[f"{s}x{w}" for s, w in _CARDS])
def test_every_card(sms, per_sm):
    """The ladders of meet-in-the-middle calls on cards cut to fewer SMs
    or holding more warps an SM, as the wave checks on the chip cut them."""
    for m, n in [(1, 1), (300, 280), (180_000, 150_000), (TOP, TOP)]:
        for sweeps in _mim(m, n):
            if sms * (per_sm // STAGE_WARPS) >= 2:
                _check(sweeps, sms, per_sm)
            _check(sweeps[:1], sms, per_sm)


# rows at the edges of a strip (32 R k + e), for each R the kernel is built for
_EDGES = [(r, e) for r in STAGE_ROWS_PER_LANE for e in (-1, 0, 1)]


@pytest.mark.parametrize("r,e", _EDGES, ids=[f"R{r}{e:+d}" for r, e in _EDGES])
def test_strip_edges(r, e):
    """m + 1 = 32 R k + e rows, every row live (d0 = m of an m x (m + 9)
    matrix), on a card of k / 4 SMs: k strips of R rows a lane fill it,
    and one row more takes wider strips (past R = 32, more CTAs than SMs);
    one and two sweeps, m > n in the second."""
    for k in (4, 8, 20, 160):
        m = 32 * r * k + e - 1
        card = (k // STAGE_WARPS, 8)
        plan = _check([(m, m + 9, m, m + 40)], *card)
        h = 32 * plan.rows_per_lane
        assert plan.sweeps[0].strips == -(-(m + 1) // h)
        if e <= 0:  # no narrower strips fit the card
            assert plan.rows_per_lane == r and plan.sweeps[0].strips == k
        else:
            assert plan.rows_per_lane > r or plan.ctas > card[0]
        _check([(m, m + 9, m, m + 40), (m + 3, max(m - 5, 1), m, m + 4)], *card)
        _check([(m, m + 9, m, m + 40), (m + 3, max(m - 5, 1), m, m + 4)], *H100)


@pytest.mark.parametrize("sms,per_sm", [(1, 8), (2, 8), (132, 8), (132, 24)])
def test_cta_and_wave_edges(sms, per_sm):
    """Rows at the edges of a CTA's strips, of what one CTA an SM holds
    (where R widens) and of a wave (where the strips run in waves), and the
    most rows a plan of this card can get."""
    W = wf.STAGE_WARPS
    one_wave = sms * (per_sm // W) * W * 32 * STAGE_ROWS_PER_LANE[-1]
    rows = [W * 32 * k + e for k in (1, 3) for e in (-1, 0, 1)]
    rows += [sms * W * 32 * r + e for r in (1, 2, 4) for e in (0, 1)]
    rows += [one_wave + e for e in (-1, 0, 1)] + [2 * one_wave, 2 * one_wave + 1, TOP + 1]
    for r in rows:
        m = min(r - 1, TOP)
        plan = _check([(m, TOP, m, m + 64)], sms, per_sm)
        waves = plan.sweeps[0].waves
        assert (waves > 1) == (m + 1 > one_wave)
        if m + 1 == 2 * one_wave:
            assert waves == 2
        if sms * (per_sm // W) >= 2:  # else the plan refuses two sweeps (below)
            _check([(m, TOP, m, m + 64), (TOP - 3, 7, TOP - 3, TOP + 4)], sms, per_sm)


def test_dead_rows_get_no_strip():
    """A sweep's first stage: only rows below d1 are live. The last
    diagonal: only row m. A stage of no steps: no strip at all."""
    plan = _check([(TOP, TOP, 2, 60)], *H100)
    assert (plan.sweeps[0].lo, plan.sweeps[0].hi) == (0, 59)
    assert plan.sweeps[0].strips == -(-60 // (32 * plan.rows_per_lane))
    plan = _check([(300, 200, 500, 501), (5, 9, 2, 3)], *H100)
    assert (plan.sweeps[0].lo, plan.sweeps[0].hi) == (300, 300)
    plan = _check([(30, 20, 2, 2), (20, 30, 2, 2)], *H100)
    assert plan.ctas == 1 and all(sp.strips == 0 for sp in plan.sweeps)


def test_strips_spread_over_the_sms():
    """R is the fewest rows a lane that fits one CTA an SM: one row fewer
    would need more CTAs than SMs."""
    for m in (1000, 16_895, 16_896, 90_000, 180_000):
        sweeps = [(m, m, m, m + 100)] * 2
        plan = _check(sweeps, *H100)
        k = STAGE_ROWS_PER_LANE.index(plan.rows_per_lane)
        assert plan.ctas <= 132
        if k:
            h = 32 * STAGE_ROWS_PER_LANE[k - 1]
            strips = [sp.hi // h - sp.lo // h + 1 for sp in plan.sweeps]
            assert sum(-(-s // STAGE_WARPS) for s in strips) > 132


def test_bad_plans_raise():
    with pytest.raises(ValueError, match="hold a CTA"):
        stage_plan([(10, 10, 2, 5)], 132, 2)
    with pytest.raises(ValueError, match="hold a CTA"):
        stage_plan([(10, 10, 2, 5)], 0, 8)
    with pytest.raises(ValueError, match="sweeps need a CTA"):
        stage_plan([(TOP, TOP, TOP, TOP + 9)] * 2, 1, 4)
