"""``chip_smoke.py``'s bounds: the bytes and operations one ``spja`` call,
and one call of each opat kernel, needs on its data, held against a
row-by-row count in plain Python.  Tolerance: exact (integer counts)."""
import importlib.util
import pathlib

import pytest

from repro_torch import cases
from repro_torch.kernels import ref

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


def _probe_brute(keys, htk):
    """(found rows, probe steps, 64-byte segments visited + hit) of a
    linear probe walked key by key."""
    seg, mask = smoke.SEGMENT // 4, len(htk) - 1
    found = steps = 0
    visited, hits = set(), set()
    for key in keys.tolist():
        slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
        for _ in range(len(htk)):
            visited.add(slot)
            steps += 1
            if htk[slot] == key:
                found += 1
                hits.add(slot)
                break
            if htk[slot] == -2 ** 31:
                break
            slot = (slot + 1) & mask
    return found, steps, smoke.SEGMENT * (len({s // seg for s in visited})
                                          + len({s // seg for s in hits}))


@pytest.mark.parametrize("fn,case", [
    ("select_scan", cases.select_case(1, 777, "mid")),
    ("select_scan", cases.select_case(2, 333, "none", "float32")),
    ("probe_join", cases.probe_case(3, 900, "duplicate_wrap", 60)),
    ("probe_join", cases.probe_case(4, 100, "empty")),
    ("project", cases.project_case(5, 501) + (1.0, -1.0)),
    ("group_sum", cases.group_case(6, 640, 37, "f32_integers")),
    ("group_sum", cases.group_case(7, 640, 5, "int32_overflow")),
])
def test_opat_need_counts_what_the_function_moves(fn, case):
    args = cases.tensors(case, "cpu")
    n = len(case[0])
    got = smoke.opat_need(fn, args, getattr(ref, fn)(*args))
    if fn == "select_scan":
        x, _, lo, hi = case
        count = int(sum(lo <= v <= hi for v in x.tolist()))
        want = (8 * n + 4 * count, 2 * n, smoke.INT32_OPS_PER_S)
    elif fn == "probe_join":
        found, steps, table = _probe_brute(case[0], case[2])
        want = (8 * n + 8 * found + table, 4 * steps, smoke.INT32_OPS_PER_S)
    elif fn == "project":
        want = (12 * n, 3 * n, smoke.F32_OPS_PER_S)
    else:
        rate = smoke.F32_OPS_PER_S if case[1].dtype.kind == "f" \
            else smoke.INT32_OPS_PER_S
        want = (8 * n + 4 * case[2], n, rate)
    assert (got["bytes"], got["ops"]) == want[:2]
    assert got["bytes_ms"] == want[0] / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == want[1] / want[2] * 1e3
