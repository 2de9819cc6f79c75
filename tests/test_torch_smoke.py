"""``chip_smoke.py``'s bound: the bytes and operations one ``spja`` call
needs on its data, held against a row-by-row count in plain Python.
Tolerance: exact (integer counts)."""
import importlib.util
import pathlib

import pytest

from repro_torch import cases

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CASES = [
    dict(n=500, n_preds=2, n_joins=0, measure_op="mul", n_groups=1),
    dict(n=700, n_preds=1, n_joins=2, measure_op="sub", n_groups=30,
         duplicates=True, wrap=True, build_rows=40),
    dict(n=333, n_preds=0, n_joins=3, measure_op="first", n_groups=50,
         empty_join=True),
    dict(n=900, n_preds=3, n_joins=4, measure_op="first", n_groups=200,
         build_rows=60),
]


def _brute(c) -> dict:
    """Walk every row as the kernel does and count what it touches."""
    seg = smoke.SEGMENT // 4
    live = [True] * c.n
    fact = table = ops = 0

    def read():
        return smoke.SEGMENT * len({r // seg for r in range(c.n) if live[r]})

    for col, (lo, hi) in zip(c.pred_cols, c.pred_bounds.reshape(-1, 2)):
        fact += read()
        for r in range(c.n):
            if live[r]:
                ops += 2
                live[r] = bool(lo <= col[r] <= hi)
    group = [0] * c.n
    for j, keys in enumerate(c.join_keys):
        fact += read()
        htk, htv = c.join_tables[2 * j], c.join_tables[2 * j + 1]
        mask = len(htk) - 1
        visited, hits = set(), set()
        for r in range(c.n):
            if not live[r]:
                continue
            key = int(keys[r])
            slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
            found = False
            for _ in range(len(htk)):
                visited.add(slot)
                ops += 4
                if htk[slot] == key:
                    found = True
                    break
                if htk[slot] == -2 ** 31:
                    break
                slot = (slot + 1) & mask
            live[r] = found
            if found:
                hits.add(slot)
                ops += 2
                group[r] += int(htv[slot]) * int(c.group_mults[j])
        table += smoke.SEGMENT * (len({s // seg for s in visited})
                                  + len({s // seg for s in hits}))
    for r in range(c.n):
        live[r] = live[r] and (group[r] & 0xFFFFFFFF) < c.n_groups
    fact += read() * (2 if c.m2 is not None else 1)
    ops += 2 * sum(live)
    return {"fact_bytes": fact, "table_bytes": table,
            "bytes": fact + table + 4 * c.n_groups, "ops": ops}


@pytest.mark.parametrize("i", range(len(CASES)))
def test_must_move_counts_what_the_kernel_touches(i):
    c = cases.spja_case(300 + i, **CASES[i])
    args, _ = c.args("cpu")
    got = smoke.must_move(args, c.n_groups)
    want = _brute(c)
    assert {k: got[k] for k in want} == want
    assert got["bytes_ms"] == want["bytes"] / smoke.HBM_BYTES_PER_S * 1e3
