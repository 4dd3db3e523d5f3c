#!/usr/bin/env python
"""Times the flat wavefront kernel under other grids and claim orders than
its plan's, on one NVIDIA GPU: the measurement behind
``ops.wavefront.FLAT_SHARE``.

    python3 tools/flat_grid_probe.py

Workloads, built by ``chip_smoke.py``'s helpers: phase 4c's long reads (NW,
affine gaps -7/-2, a 32 x 32 class table, 96 pairs), its band batch (64
pairs of 20,000 chars, unit costs) and long pair (100,000 chars), and phase
4g's 180,000 x 180,000 DNA pair (unit costs), each through
``wavefront_batch``. For each, the plan's grid is replaced by one of 1, 2,
3 or 4 CTAs an SM or the most the card holds, with the plan's strip-major
claims or with the strips claimed longest remaining chain first; then the
1, 4 and 16 biggest long-read pairs run alone on the plan's grid. Every
result is checked: the reads against the plain version, the long pair
against its 500 flips, the rest against the plan's own result. Times are
CUDA-event medians of 3 batches with their spread. Prints the card's name
and power limit first.
"""

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402


def _workloads(dev):
    """(name, packed pairs, costs, expected scores or None) of the four."""
    import torch
    from stringzilla_tpu_torch import NeedlemanWunschScores
    from stringzilla_tpu_torch.ops.wavefront import config_costs, wavefront_reference

    def pack(strings, qi, cj, nq):
        offs = np.concatenate([[0], np.cumsum([len(x) for x in strings])[:-1]])
        lens = np.array([len(x) for x in strings])
        chars = torch.from_numpy(np.concatenate(strings).astype(np.int32)).to(dev)
        return chars, offs[qi], lens[qi], offs[nq + cj], lens[nq + cj]

    qs, cs = chip_smoke._long_reads(np.random.default_rng(chip_smoke.SEED + 2))
    b2c = np.zeros(256, np.uint8)
    b2c[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dna = np.full((32, 32), -3, np.int32)
    np.fill_diagonal(dna, 2)
    ql, cl = np.array([len(q) for q in qs]), np.array([len(c) for c in cs])
    qi, cj = np.nonzero((ql[:, None] > 4096) | (cl[None, :] > 4096))
    reads = pack([b2c[np.frombuffer(x, np.uint8)] for x in qs + cs], qi, cj, len(qs))
    kw = config_costs(NeedlemanWunschScores(b2c, dna, open=-7, extend=-2).config,
                      torch.from_numpy(dna).to(dev))
    bq, bc = chip_smoke.band_batch_strings()
    bi, bj = (x.ravel() for x in np.meshgrid(np.arange(len(bq)), np.arange(len(bc)),
                                             indexing="ij"))
    batch = pack([np.frombuffer(x, np.uint8) for x in bq + bc], bi, bj, len(bq))
    rng = np.random.default_rng(chip_smoke.SEED)  # phase 4c's draws of the long pair
    a = rng.integers(97, 123, chip_smoke.LONG_PAIR).astype(np.uint8)
    b = a.copy()
    b[rng.choice(chip_smoke.LONG_PAIR, 500, replace=False)] ^= 1
    pair = pack([a, b], np.array([0]), np.array([0]), 1)
    ma, mb = chip_smoke._mim_pairs()[0]
    mim = pack([np.asarray(ma), np.asarray(mb)], np.array([0]), np.array([0]), 1)
    return [("long reads", reads, kw, wavefront_reference(*reads, **kw)),
            ("band batch", batch, {}, None),
            ("long pair", pair, {}, torch.tensor([500], dtype=torch.int32, device=dev)),
            ("180,000² pair", mim, {}, None)]


def main() -> int:
    import torch
    from stringzilla_tpu_torch.ops import wavefront as wf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    plan_of = wf.flat_plan
    chain = 32 * wf.FLAT_ROWS + 2 * wf.FLAT_CHUNK  # steps a strip trails the one above

    def variant(order, per_sm):
        """flat_plan with the grid at ``per_sm`` CTAs an SM (None: the most
        the card holds) and the claims in ``order``."""
        def plan(pairs, affine, sms, warps):
            p = plan_of(pairs, affine, sms, warps)
            claims = p.claims
            if order == "longest chain":
                parts = []
                for g in p.groups:
                    part = claims[g.first_claim:g.first_claim + g.claims]
                    left = [(p.strips[g.first_pair + q] - s) * chain + max(pairs[g.first_pair + q])
                            for q, s in part]
                    parts.append(part[np.argsort(-np.array(left), kind="stable")])
                claims = np.concatenate(parts)
            cap = p.ctas_per_sm if per_sm is None else per_sm
            groups = tuple(g._replace(ctas=min(-(-g.claims // wf.FLAT_WARPS), sms * cap))
                           for g in p.groups)
            return p._replace(claims=claims, groups=groups)
        return plan

    works = _workloads(dev)
    wants = {}
    for name, args, kw, want in works:
        got = wf.wavefront_batch(*args, **kw)
        if want is not None and not torch.equal(got, want):
            raise RuntimeError(f"{name}: the plan's result != the expected scores")
        wants[name] = got
        ms = chip_smoke._time_ms(lambda: wf.wavefront_batch(*args, **kw), 1, sync, batches=3)
        print(f"[flat grid] {name}: the plan's grid {ms:.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}]",
              flush=True)
    for order in ("strip-major", "longest chain"):
        for per_sm in (None, 4, 3, 2, 1):
            wf.flat_plan = variant(order, per_sm)
            try:
                line = f"[flat grid] {order}, {per_sm or 'the card'} CTAs an SM:"
                for name, args, kw, _ in works:
                    if not torch.equal(wf.wavefront_batch(*args, **kw), wants[name]):
                        raise RuntimeError(f"{name} under {order}, {per_sm}: a wrong score")
                    ms = chip_smoke._time_ms(lambda: wf.wavefront_batch(*args, **kw), 1, sync,
                                             batches=3)
                    line += f" {name} {ms:.4f} [{ms.lo:.4f}-{ms.hi:.4f}];"
                print(line, flush=True)
            finally:
                wf.flat_plan = plan_of
    name, (chars, a_off, a_len, b_off, b_len), kw, _ = works[0]
    biggest = np.argsort(-(a_len + b_len), kind="stable")
    for take in (1, 4, 16):
        sel = biggest[:take]
        sub = (chars, a_off[sel], a_len[sel], b_off[sel], b_len[sel])
        if not torch.equal(wf.wavefront_batch(*sub, **kw), wants[name][torch.from_numpy(sel)]):
            raise RuntimeError(f"the {take} biggest long reads alone: a wrong score")
        ms = chip_smoke._time_ms(lambda: wf.wavefront_batch(*sub, **kw), 1, sync, batches=3)
        print(f"[flat grid] the {take} biggest long-read pairs alone, the plan's grid: "
              f"{ms:.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
