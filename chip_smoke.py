#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # SF 20, the paper's scale (§5.1)

Phases, each printing what it found; any failure raises, and the script
exits non-zero without printing a result:

1. card:   name and power limit, as nvidia-smi reports them;
2. build:  every CUDA kernel of the port, compiled from the repo's
           sources with nvcc, one process per source, all at once;
3. kernel vs plain: each kernel against its plain version on the card on
           synthetic inputs from a seed — bit-identical, except the
           sigmoid (rtol 1e-6) and sums of non-integer f32 values
           (``group_sum``, ``probe_agg``, ``reduce_sum``: two runs
           identical, within one f32 ulp of the plain version); the
           packed kernels at every packed width, with ragged n,
           frame-of-reference keys and measures and sign-bit words; the
           hash ``build`` (ragged n, duplicate keys, a full table, no
           rows) and ``select_scan_sparse`` (selectivity 0, 1e-5 and 0.5,
           x uniform and sorted, equal to ``select_scan``), each run
           twice with the same bits; the radix kernels (``histogram``,
           ``digit_counts``, the one-sweep ``partition_multi`` pass with
           its counts from either) at every radix case, and
           ``radix_sort`` of keys whose passes all move rows, all but
           the top one, two of four and none, launching only those;
4. main path: ``ssb.generate(sf=20)`` (120 M lineorder rows), resident
           on the card, all 13 SSB queries through
           ``compile_plan(plan, "fused").execute(db, cache=...)``: 13
           kernel launches per pass, every result bit-identical to the
           numpy oracle, to the plain version on the card and to a second
           pass; then per-query times beside the least time the card
           could take for the work this data needs (``must_move``);
5. second path: the same 13 queries through ``compile_plan(plan,
           "opat")`` on the same resident database and hash cache — one
           launch of ``select_scan`` per fact predicate, ``probe_join``
           per join, ``project`` per ``sub`` measure and ``group_sum`` per
           query; every result bit-identical to phase 4's oracle and fused
           results, to a second pass and to the plain versions on the
           card; then per-query times beside fused (the fig17 analogue)
           and each kernel's time over one pass beside its bound
           (``project``, whose calls there are their fixed cost, in
           turns with ``torch.sub``; each ``probe_join`` and
           ``select_scan`` call run twice with the same bits, beside a
           fill of its zero tail), and one ``probe_join`` and one
           ``select_scan`` call of each size profiled: one sweep kernel
           and one memset; one ``group_sum`` call over a grid of blocks
           and one of a single block profiled: one kernel each;
6. packed storage: phase 4's database packed (``storage.pack_database``)
           and resident on the card, the 13 queries ``fused`` (``spja`` on
           packed streams) and ``opat`` (the leading filter through
           ``select_scan_packed``) through the same hash cache — every
           build a hit, every result bit-identical to phase 4's oracle
           and fused results, a second pass and the plain versions on
           the card, launches checked against the plans; per-query
           packed times beside phase 4's plain ones and the packed bound;
           ``select_scan_packed`` over one pass (each call run twice, one
           call profiled as in phase 5) and ``unpack`` of every
           packed column (bit-identical to the resident plain column)
           beside their bounds;
7. partitioned join: the 13 queries through ``compile_plan(plan,
           "part")`` and ``"part_loop"`` on phase 4's database and on
           phase 6's packed one, through the same hash cache — per join,
           ``part`` launches one ``histogram``, one ``partition_multi``
           pass (its bucket counts the histogram's column sums: no digit
           count) and one ``part_probe``, ``part_loop`` one histogram,
           one pass and one ``probe_join`` per non-empty partition;
           every result bit-identical to phase 4's oracle, a second pass
           and the plain versions on the card; per-query times beside
           fused and opat, each new kernel's time over one pass beside
           its bound (``part_probe`` as ``probe_join`` in phase 5, one
           call profiled), and part_loop's ``probe_join`` calls timed
           over one pass; then the Fig. 8 analogue, one FK join of 2^27 fact
           rows against dims of 2^12 to 2^24 rows, through fused, opat,
           part and part_loop (to 2^20: ``FIG8_LOOP_DIMS``), each against
           the oracle;
8. ORDER BY: ``engine.order_by`` of lineorder by ``lo_orderdate`` (one
           digit-count launch, then the two 8-bit passes of four that
           move rows) against numpy's stable argsort, and a filter + join
           + ``OrderBy`` row plan against numpy's stable argsort of its
           survivors, launches held to the pass plan of the plain digit
           counts; ``radix_sort`` of the dates and of random 32-bit keys
           in turns with ``torch.sort(stable=True)``, beside its bound,
           with the digit counts and one pass timed alone and the rate
           over the bytes the design moves;
9. shared waves: the 13 queries as one wave through ``execute_shared(...,
           pad_to=16)``, flight 1, flight 2 and flights 2 + 4, on phase 4's
           database and on phase 6's packed one with a fresh hash cache —
           one ``multi_spja`` launch a wave, cache misses equal to the
           distinct build sides (none new on the packed database), every
           member bit-identical to phase 4's oracle and fused results, a
           second pass and the plain version on the card; ``compile_plan(
           plan, "shared")`` for q1.1 and q2.1; per wave ``query_ms``
           beside the members' solo fused ``query_ms``, the kernel's time
           beside the bound of what the wave's data needs (``wave_need``),
           its shared memory a block and blocks an SM; the 13-query wave
           profiled (the device busy share);
10. join microbenchmark and streaming sum: ``probe_agg`` of 2^28 probe
           rows against tables of 8 KB to 256 MB (across the 50 MB L2;
           each through the table's copy as 8-byte slots),
           ``reduce_sum`` of a 2^28-row int32 column and its f32 copy, each
           bit-identical to its plain version and to numpy, timed beside
           its bound (``agg_need``: past the L2 a sector a probe at the
           share the L2 cannot hold; and ``torch.sum``), one call of the
           256 MB table profiled, and one f32 ``reduce_sum`` call: one
           kernel and at most one memset; the hash ``build`` of those
           tables (50 % fill) from their keys, byte-identical to its plain
           version, its tables probed to the sums of the host build's,
           timed beside the host ``np_build``, one call of the 256 MB
           table profiled (one kernel and the 4-byte read of its flag);
           ``select_scan_sparse`` of 2^28 rows at selectivities 1e-5 to
           0.5, x uniform and sorted, equal to ``select_scan`` and timed
           beside it, with the share of
           32-row tiles that hold a match, beside ``sparse_need``'s bound
           (out written whole), one call profiled: one sweep of its own
           name and one memset; ``project`` of 2^28 rows, with
           and without the sigmoid, in turns with ``torch.sub``, beside
           its bound;
11. morsels: phase 4's database no longer resident, the 13 queries
           through ``fused``, ``opat`` and the 13-query wave (``shared``,
           padded to 16), and ``fused`` on phase 6's packed database,
           each a fold over 256 MiB morsels uploaded from page-locked host
           memory on a side stream (at least 4 morsels a query, 3 on
           packed storage) — every result bit-identical to phase 4's
           oracle and to the resident results; phases 1-10's tensors are
           freed first, and the device memory peak of each run is held to
           the hash tables, two morsels and a morsel's rows at the working
           set a one-morsel run of the query measured (plus 64 MiB of
           allocator slack); per query ``query_ms`` beside the
           resident one, the upload's bound (scanned bytes over the
           measured host-to-device rate, beside a pinned 1 GiB copy),
           the cost model's ``morsel_pipeline_time`` on the calibrated
           card (phase 12) and the resident kernel time; the 13 queries
           ``sharded`` at S = 4 over the host table, each shard folding its
           own morsels (morsels added across the shards, the peak one
           shard's double buffer, by the same rule); one morsel query
           profiled;
12. sharding and the cost model (run before phase 11, on phase 4's and
           phase 6's resident databases): ``calibrate.measure`` on the
           card into a cache of the run's own (read, write, L2 gather,
           launch overhead, pinned host-to-device rate, beside the
           published 3.35 TB/s), read back by ``model.default_hardware``;
           the 13 queries through ``compile_plan(plan, "sharded")`` at S
           = 2, 4 and 8 logical shards, plain and packed (shards of a
           resident table are views of its tensors: the device memory
           over the base at most the re-packed words of packed columns
           cut off a word boundary) — S ``spja`` launches a query, every
           result bit-identical to the oracle, to the fused path and to a
           second pass; ``query_ms`` beside fused with each shard's time;
           the 13-query wave through ``execute_shared_sharded`` at S = 4,
           plain and packed — S ``multi_spja`` launches, bit-identical to
           phase 9's ``execute_shared``; ``compile_plan(plan, "auto")`` on
           the plain database and on its S = 4 shards — bit-identical to
           the oracle, the choice and each candidate's predicted time
           beside the measured ``query_ms`` of phases 4, 5, 7 and 12;
13. the tuner and the serving control plane (run after phase 12, on phase
           4's resident database): ``tune.measure(SMOKE_GRID)`` on the card
           into a cache of the run's own beside phase 12's calibration —
           every swept configuration checked against its oracle, every
           partition depth against the default depth's rows, before it is
           timed — each family's winner (``r``, bits and budget, time,
           speedup, ``select_scan``'s ``eff_bw`` at the streaming size),
           ``default_hardware`` calibrated
           then tuned, ``tuned_r`` and ``part_bits`` read from the store;
           the 13 queries ``part`` under the tuned budget (the oracle's
           bits) and ``auto`` on the calibrated and the tuned ``Hardware``,
           each choice and prediction beside the measured ``query_ms`` of
           phases 4, 5 and 7; then four serving runs, each result the
           oracle's bits (the narrowed variants' oracles computed here):
           a ``QueryServer`` on the card (its default device, mode
           ``auto``) over the 13 queries ``fused``, ``opat``, ``part``,
           ``shared`` and ``auto`` and ``sharded`` at S = 4, twice (the
           second pass every build a hit), each result on its first
           attempt with the strategy it asked for, its ``launch_config``
           the families that ran, no retry and no fallback but ``part``'s
           compile-time ones; a result cache answering the 5 narrowed
           variants by subsumption; a ``ServingLoop`` over the 13 queries
           and the variants (anchored and prewarmed) at ``ARRIVALS``
           Poisson arrivals, asked as ``shared`` (a wave of two or more
           must form) and as ``auto`` (the model decides whether a wave
           shares; its shared and solo terms for the 13-query wave
           printed beside the batch server's) — p50/p99 latency, waves
           and their sizes, cache hits, no retry; and a fault run (an injected OOM, then
           kernel and upload faults): every request the oracle's bits from
           a rung on the card or a typed error (none answered on the
           host), the OOM request's pressure shutting the door (a typed
           shed) until the governor's cooldown, the halved morsels, the
           breakers.
           Every kernel of the path launched at least once
           (``launches_serving``).

14. the LM serving path (plain PyTorch, none of the 15 kernels: every
           launch count stays 0): the 10 smoke configs in float32 from one
           seed, ``forward``, ``loss``, ``prefill`` (every cache leaf) and
           two ``decode`` steps on the card within 1e-4 of the host on the
           same parameters; then qwen2-0.5b at full width (bf16, random
           weights from the seed) on the card: a 4-slot ``BatchServer``
           answering 4 prompts of 128 tokens and 2 of 4,096 (past
           ``attn_chunk_threshold``: chunked attention), 32 new tokens
           each, twice with the same tokens; for one prompt of each
           length ``prefill`` of all but the last token and ``decode`` of
           it against ``forward`` at those positions (``LM_BF16_ATOL``);
           prefill ms per bucket, decode ms a step, tokens/s, peak device
           memory, the decode loop's device busy share and launches a
           step, beside the step's byte bound (every weight read once).
15. the LM training path: the 10 smoke configs in float32 from one seed,
           ``loss_and_grads`` (the loss and every gradient leaf) and one
           ``make_train_step`` (params, moments, step, metrics) on the
           card within 1e-4 of the host on the same parameters and batch;
           then qwen2-0.5b at full width (bf16 params, f32 master and
           moments, remat) on the card, fed by a ``TokenPipeline`` (batch
           8, seq 512): each ``batch_at`` launches ``select_scan`` once
           (its ``(kept, count)`` the plain version's bits on the same
           scores, its tokens the plain filter's; no other kernel
           launched: ``launches_train``), ``TRAIN_WARM`` + ``TRAIN_TIMED``
           steps — step ms, tokens/s, peak device memory over what was
           resident, one step profiled (busy share, launches), beside the
           FLOP bound ``6 N tokens`` at 989 TFLOP/s and the optimizer's
           byte bound; ``FIT_STEPS`` steps on one fixed batch (lr 1e-3, no
           decay): every loss finite, the last below the first; an async
           checkpoint of ``{params, opt}`` while the next step runs,
           restored into a fresh template on the card with the bits of
           the snapshot before that step (GB, save and restore seconds).

16. the mesh paths (run after phase 13, before phase 11 frees the
           resident database): ``mesh.spawn`` worlds of ranks all on
           ``cuda:0``, each generating SF 20 from the seed — S = 1 over
           NCCL, S = 2 and 4 over gloo (NCCL refuses two ranks on one
           device) — running the 13 queries ``sharded`` on
           ``shard_database(db, mesh)``: each rank's shard resident, one
           ``spja`` launch a query and one all-reduce; at S = 2 also 256
           MiB windows of the host table and the packed database.  Every
           rank's answer has phase 4's oracle bits, its ``spja`` launches
           equal its windows and nothing else launches
           (``launches_mesh``); ``query_ms`` of the slowest rank beside
           phase 12's logical shards at the same S (phase 4's fused at S
           = 1), the all-reduce of one grid, each rank's device memory
           (its CUDA context, shard and tables); the interconnect's
           all-reduce rate with its backend at S = 2 and 4; then
           expert-parallel MoE on a world of 4: the two MoE smoke configs
           in f32 on a 2 x 2 mesh (``moe_ffn`` and ``api.forward``)
           within 1e-4 of the host's local path, and one deepseek-moe-16b
           layer at full width in bf16 on a 1 x 4 mesh against
           ``_moe_ffn_local`` on the card (``MOE_BF16_TOL``), each path's
           ms.

The line before the last lists every kernel of every path as JSON; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory, published peak
SEGMENT = 64                    # bytes of one device-memory access
SECTOR = 32                     # bytes of one L2 sector
F32_OPS_PER_S = 67e12           # published float32 rate outside tensor cores
# int32 ALU peak of an H100 SXM: 132 SMs x 64 int32 lanes x 1.98 GHz =
# 16.7 TOP/s, a quarter of the published 67 TFLOP/s float32 rate (128
# float32 lanes, an FMA counted as 2)
INT32_OPS_PER_S = F32_OPS_PER_S / 4
SF = 20                         # the paper's scale factor (§5.1)
SEED = 20
QUERY_REPS = 5                  # end-to-end runs per query (median)
KERNEL_REPS = 10                # back-to-back launches per timing
PLAIN_REPS = 2
CALL_REPS = 3                   # back-to-back launches per opat call
# kernel against library call in turns: rounds of (kernel, library,
# library, kernel), each the mean of TURN_CALLS back-to-back calls
TURN_ROUNDS = 5
TURN_CALLS = 50
KERNEL = {"name": "ssb_fused.spja", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/ssb_fused.cu",
          "replaces": "src/repro/kernels/ssb_fused.py:115"}
# the opat path's kernels: (wrapper module, function, CUDA source,
# the Pallas kernel it replaces)
OPAT = [("select_scan", "select_scan", "select_scan.cu",
         "src/repro/kernels/select_scan.py:52"),
        ("hash_join", "probe_join", "hash_join.cu",
         "src/repro/kernels/hash_join.py:193"),
        ("project", "project", "project.cu",
         "src/repro/kernels/project.py:33"),
        ("agg", "group_sum", "agg.cu", "src/repro/kernels/agg.py:80")]
# the packed kernels: (wrapper module, function, its launch counter, CUDA
# source, the Pallas kernel it replaces)
PACKED = [("select_scan", "select_scan_packed", "PACKED_LAUNCHES",
           "select_scan.cu", "src/repro/kernels/select_scan.py:219"),
          ("unpack", "unpack", "LAUNCHES", "unpack.cu",
           "src/repro/kernels/unpack.py:30")]
# the partitioned join's and ORDER BY's kernels, the same fields
PARTITIONED = [
    ("radix_part", "histogram", "HIST_LAUNCHES", "radix_part.cu",
     "src/repro/kernels/radix_part.py:52"),
    ("radix_part", "partition_multi", "SCATTER_LAUNCHES", "radix_part.cu",
     "src/repro/kernels/radix_part.py:111"),
    ("part_probe", "part_probe", "LAUNCHES", "part_probe.cu",
     "src/repro/kernels/part_probe.py:94")]
# the shared-scan and join-microbenchmark kernels, the same fields
SHARED = [("multi_fused", "multi_spja", "LAUNCHES", "multi_fused.cu",
           "src/repro/kernels/multi_fused.py:142")]
JOIN_BENCH = [("hash_join", "probe_agg", "AGG_LAUNCHES", "hash_join.cu",
               "src/repro/kernels/hash_join.py:136"),
              ("agg", "reduce_sum", "SUM_LAUNCHES", "agg.cu",
               "src/repro/kernels/agg.py:42")]
# the last two kernels, the same fields: each on an entry point of its own
LAST = [("hash_join", "build", "BUILD_LAUNCHES", "hash_join.cu",
         "src/repro/kernels/hash_join.py:85"),
        ("select_scan", "select_scan_sparse", "SPARSE_LAUNCHES",
         "select_scan.cu", "src/repro/kernels/select_scan.py:125")]
# phase 3: (build_case kind, slots) and select_scan_sparse selectivities
BUILD_SYNTHETIC = [("distinct", 1 << 20), ("duplicates", 1 << 16),
                   ("full", 1 << 12), ("empty", 64), ("distinct", 1)]
SPARSE_SYNTHETIC = (0.0, 1e-5, 0.5)
# phase 10: select_scan_sparse's rows and selectivities
SPARSE_ROWS = 1 << 28
SPARSE_SELECTIVITY = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5)
# phase 11: the morsel budget, the morsels each query must make at least
# (plain; packed columns take fewer bytes, q1.1's three morsels), and the
# bytes of the host-to-device copies timed
MORSEL_BYTES = 256 << 20
MIN_MORSELS = 4
MIN_PACKED_MORSELS = 3
H2D_BYTES = 1 << 30
MORSEL_REPS = 3
# phase 12: the shard counts of the 13 queries, of the sharded wave, and
# of phase 11's sharded morsel run
SHARDS = (2, 4, 8)
WAVE_SHARDS = 4
MORSEL_SHARDS = 4
PART_N = 2_000_003              # rows of the synthetic partitioned probes
# the one-sweep compactions (csrc/lookback.cuh): a call is one memset and
# one kernel, each timed call run twice
SWEEPS = ("probe_join", "part_probe", "select_scan", "select_scan_packed")
SMALL_ROWS = 10_000             # a call this small is its fixed cost
# phase 3: radix_sort's keys (cases.sort_case kinds) and the passes of
# four that move rows
SORT_SYNTHETIC = [("negative", [0, 1, 2, 3]), ("top_byte", [0, 1, 2]),
                  ("date", [0, 1]), ("equal", [])]
# the Fig. 8 analogue (benchmarks/run.py::_fig8_db's shape): 2^27 fact
# rows, FK uniform over a dim of 2^12 .. 2^24 rows (the last a 256 MB
# table, past the 50 MB L2)
FIG8_FACT = 1 << 27
FIG8_DIMS = (1 << 12, 1 << 16, 1 << 20, 1 << 24)
# part_loop's dims: its 256 per-partition tables at 2^24 take as long to
# build on the host as part's packed ones (about 50 s), for a row the
# 2^20 one already shows, so the sweep skips it there
FIG8_LOOP_DIMS = (1 << 12, 1 << 16, 1 << 20)
STRATEGIES = ("fused", "opat", "part", "part_loop")
# phase 9's waves (query names; all13 is padded to 16 members)
WAVES = {"all13": None, "flight1": ("q1.1", "q1.2", "q1.3"),
         "flight2": ("q2.1", "q2.2", "q2.3"),
         "flights2_4": ("q2.1", "q2.2", "q2.3", "q4.1", "q4.2", "q4.3")}
# spin kernels before a profiled run, for the profiler to lose in its
# place (on an H100 it lost about one for every 15 s the process had
# run: profiler_check.py), and the longer heads of the profiles taken
# again when one still lost a record of the run (once a profile of one
# fill, after 256 spin kernels, kept no record of the fill)
PROFILE_HEAD = 256
PROFILE_RETRY_HEADS = (2048, 16384)
# phase 9's one-member waves: compile_plan(q, "shared")
SINGLES = ("q1.1", "q2.1")
# phase 10: probe rows and the table sizes of the L2 step (8 bytes a slot,
# half full: benchmarks/run.py::fig13_join's reckoning)
JOIN_ROWS = 1 << 28
JOIN_TABLE_KB = (8, 256, 4096, 32768, 65536, 262144)
SUM_ROWS = 1 << 28
# phase 5: the group_sum calls profiled alone, (rows, groups): flight 2's
# groups over a grid of blocks, and q3.4's call, one block
GROUP_PROFILED = ((1_000_003, 7000), (72, 24))
PROJECT_ROWS = 1 << 28

# (label, cases.spja_case arguments): what SSB data never shows — a
# ragged tail, an empty build side, duplicate and wrapping keys, group ids
# past the grid, n_groups 1, 7000 and 33,750, each measure op
SYNTHETIC = [
    ("ragged n, 3 preds, mul, 1 group",
     dict(n=10_000_019, n_preds=3, n_joins=0, measure_op="mul",
          n_groups=1)),
    ("7000 groups, duplicate + wrapping keys",
     dict(n=4_000_037, n_preds=0, n_joins=3, measure_op="first",
          n_groups=7000, duplicates=True, wrap=True, build_rows=20_000)),
    ("empty build side (all-EMPTY 16 slots), sub",
     dict(n=1_000_003, n_preds=1, n_joins=2, measure_op="sub",
          n_groups=100, empty_join=True)),
    ("3 preds + 4 joins, sub, 800 groups",
     dict(n=2_000_001, n_preds=3, n_joins=4, measure_op="sub",
          n_groups=800, duplicates=True)),
    ("joins into 1 group (ids past the grid dropped)",
     dict(n=999_999, n_preds=0, n_joins=2, measure_op="first",
          n_groups=1)),
    ("n = 37, less than a warp",
     dict(n=37, n_preds=2, n_joins=1, measure_op="mul", n_groups=4)),
    ("6 preds + 5 joins, past SSB, within the kernel's 8 + 8",
     dict(n=3_000_017, n_preds=6, n_joins=5, measure_op="mul",
          n_groups=243, duplicates=True, wrap=True)),
    ("33,750 groups, past a block's shared memory",
     dict(n=2_000_003, n_preds=1, n_joins=3, measure_op="first",
          n_groups=33_750, build_rows=5000)),
]
BIG = 10_000_019                # a ragged n past every tile and grid size
# (label, cases.multi_spja_case arguments): waves of 1, 13 and 16 members,
# 1 / 7000 / 33,750 groups, padding members with random parameters, two
# streams of one build side, an empty build side, packed predicates at
# every width with frame-of-reference keys and measures
MULTI_SYNTHETIC = [
    ("Q 1, 3 preds, 1 group",
     dict(n=BIG, n_members=1, n_preds=3, n_joins=0, n_groups=1)),
    ("Q 13 + 3 padding, 7000 groups, duplicate + wrapping keys, one table "
     "in two streams",
     dict(n=4_000_037, n_members=13, pad=3, n_preds=3, n_joins=6,
          n_groups=7000, duplicates=True, wrap=True, shared_table=True,
          build_rows=20_000)),
    ("Q 16, 33,750 groups",
     dict(n=2_000_003, n_members=16, n_preds=4, n_joins=3, n_groups=33_750,
          build_rows=5000)),
    ("Q 8 + 8 padding, empty build side",
     dict(n=1_000_003, n_members=8, pad=8, n_preds=2, n_joins=3,
          n_groups=100, empty_join=True)),
] + [
    (f"Q 13 + 3 padding, packed preds at {phys} bits, FOR keys and "
     "measures, 800 groups",
     dict(n=BIG if phys == 1 else 2_000_003, n_members=13, pad=3, n_preds=3,
          n_joins=4, n_groups=800, packed=True, pred_phys=phys,
          duplicates=True))
    for phys in (1, 2, 4, 8, 16)] + [
    ("n = 37", dict(n=37, n_members=3, n_preds=2, n_joins=2, n_groups=4)),
] + [
    # one probe a group of streams on one key column (merged tables)
    ("Q 13 + 3 padding, 7000 groups, merged probe groups of 3, duplicate "
     "+ wrapping keys",
     dict(n=4_000_037, n_members=13, pad=3, n_preds=3, n_joins=6,
          n_groups=7000, duplicates=True, wrap=True, merge=3,
          build_rows=20_000)),
    ("Q 64, merged probe groups of 7, 9 groups",
     dict(n=2_000_003, n_members=64, n_preds=1, n_joins=7, n_groups=9,
          merge=7, build_rows=50)),
    ("Q 8 + 8 padding, packed preds at 4 bits, merged groups of 2, empty "
     "build side",
     dict(n=BIG, n_members=8, pad=8, n_preds=2, n_joins=4, n_groups=100,
          merge=2, empty_join=True, packed=True, pred_phys=4)),
]
# (fn, label, cases generator, its arguments): the microbenchmark kernels
SUM_SYNTHETIC = [
    ("probe_agg", f"{kind}, {vals} vals, n={n}", "probe_agg_case",
     (n, n, kind, vals))
    for n, kind in ((BIG, "duplicate_wrap"), (1_000_003, "empty"),
                    (1_000_003, "misses"), (37, "duplicate_wrap"))
    for vals in ("int32", "f32_integers", "f32_random")] + [
    ("reduce_sum", f"{kind}, n={n}", "reduce_case", (n, n, kind))
    for n in (BIG, 37) for kind in ("int32_overflow", "f32_integers",
                                    "f32_random")]
# (label, cases.packed_spja_case arguments): packed predicates at every
# width, frame-of-reference keys and measures (SSB data packs with
# reference 0 only), n not a multiple of a word's values
PACKED_SPJA = [
    (f"packed preds at {phys} bits, 2 joins, sub, 100 groups",
     dict(n=BIG, n_preds=3, n_joins=2, measure_op="sub", n_groups=100,
          pred_phys=phys, duplicates=True, wrap=True))
    for phys in (1, 2, 4, 8, 16)] + [
    ("packed, 7000 groups, small measures at 8 and 4 bits, mul",
     dict(n=4_000_037, n_preds=1, n_joins=3, measure_op="mul",
          n_groups=7000, pred_phys=16, small=True)),
    ("packed, n = 37", dict(n=37, n_preds=2, n_joins=1, measure_op="first",
                            n_groups=4, pred_phys=2)),
]
# fn -> [(label, cases generator, its arguments, extra positional call
# arguments, sigmoid)]
OPAT_SYNTHETIC = {
    "select_scan": [
        (f"{sel} {dtype}, n={n}", "select_case", (n, n, sel, dtype), (),
         False)
        for n, sel, dtype in ((BIG, "mid", "int32"), (BIG, "none", "int32"),
                              (BIG, "all", "int32"),
                              (BIG, "mid", "float32"), (37, "mid", "int32"),
                              (BIG, "nan", "float32"),
                              ((1 << 24) + 5, "first_tile", "int32"),
                              ((1 << 24) + 5, "last_tile", "int32"),
                              (4096, "all", "int32"),
                              (4097, "mid", "float32"))],
    "probe_join": [
        (f"{kind}, n={n}", "probe_case", (n, n, kind), (), False)
        for n, kind in ((BIG, "duplicate_wrap"), (1_000_003, "empty"),
                        (1_000_003, "misses"), (37, "duplicate_wrap"),
                        (BIG, "clustered"), (BIG, "full"),
                        ((1 << 24) + 5, "first_tile"),
                        ((1 << 24) + 5, "last_tile"),
                        (3_000_017, "slots1"), (3_000_017, "slots2"),
                        (3_000_017, "slots4"), (37, "full"))],
    "project": [
        (f"a={a} b={b} sigmoid={sig}, n={n}", "project_case", (n, n),
         (a, b), sig)
        for n in (BIG, 37) for sig in (False, True)
        for a, b in ((1.0, -1.0), (0.75, -1.25))],
    "group_sum": [
        (f"{kind}, {g} groups, n={n}", "group_case",
         (g, n, g, kind, True), (), False)
        for kind in ("int32_overflow", "f32_integers", "f32_random")
        for g in (1, 7000) for n in (BIG, 4095)],
    "select_scan_packed": [
        (f"{sel} at {phys} bits, n={n}", "select_packed_case",
         (n + phys, n, phys, sel), (), False)
        for n, phys, sel in [(BIG, p, "mid") for p in (1, 2, 4, 8, 16)] +
        [(BIG, 4, "none"), (BIG, 16, "all"), (37, 2, "mid")]],
    "unpack": [
        (f"{phys} bits, ref {r}, n={n}", "unpack_case", (n + phys, n, phys, r),
         (), False)
        for n, phys, r in [(BIG, p, r) for p in (1, 2, 4, 8, 16)
                           for r in (0, -5000)] + [(37, 4, 1 << 20)]],
}


def phase(title: str) -> float:
    print(f"== {title}", flush=True)
    return time.perf_counter()


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls after
    one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns(kernel, library, rounds: int = TURN_ROUNDS,
          calls: int = TURN_CALLS) -> dict:
    """``rounds`` rounds of (kernel, library, library, kernel), each the
    mean of ``calls`` back-to-back calls (``event_ms``) -> every round's
    times and the medians of each side."""
    got = {"kernel_ms": [], "library_ms": []}
    for _ in range(rounds):
        for side in ("kernel_ms", "library_ms", "library_ms", "kernel_ms"):
            got[side].append(event_ms(kernel if side == "kernel_ms"
                                      else library, calls))
    return dict(got, kernel_median=statistics.median(got["kernel_ms"]),
                library_median=statistics.median(got["library_ms"]))


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def segment_bytes(touched: torch.Tensor, rows_per_segment: int = 16) -> int:
    """Bytes of the 64-byte segments of a stream that hold at least one
    touched row: 16 rows a segment for an int32 column, 16·c for a column
    packed c values a word."""
    per = rows_per_segment
    pad = torch.nn.functional.pad(touched, (0, (-touched.shape[0]) % per))
    return SEGMENT * int(pad.view(-1, per).any(dim=1).sum())


def probe_walk(keys: torch.Tensor, htk: torch.Tensor):
    """Each key's linear probe as the kernel walks it: (hit slot or -1,
    slots visited, probe steps taken).  ``htk`` is one ``(S,)`` table, or
    the packed ``(P, S)`` tables of a partitioned join, where a key walks
    row ``key & (P - 1)``; slots are then flat indices into them."""
    from repro_torch.core import blocks
    n_parts, n_slots = (1, htk.shape[0]) if htk.dim() == 1 else htk.shape
    flat = htk.reshape(-1)
    hit_slot = torch.full(keys.shape, -1, dtype=torch.int64,
                          device=keys.device)
    visited = torch.zeros(flat.shape[0], dtype=torch.bool,
                          device=keys.device)
    lanes = torch.arange(keys.shape[0], device=keys.device)
    base = (keys.to(torch.int64) & (n_parts - 1)) * n_slots
    want, slot, steps = keys, blocks.hash_fn(keys, n_slots), 0
    for _ in range(n_slots):
        if lanes.numel() == 0:
            break
        at = base + slot
        visited[at] = True
        steps += lanes.numel()
        k_at = flat[at]
        hit = k_at == want
        hit_slot[lanes[hit]] = at[hit]
        walking = ~(hit | (k_at == blocks.EMPTY))
        lanes, want, base = lanes[walking], want[walking], base[walking]
        slot = (slot[walking] + 1) & (n_slots - 1)
    return hit_slot, visited, steps


def mean_probe(htk: torch.Tensor) -> float:
    """Mean slots a hit walks in a linear-probe table, over its keys: each
    occupied slot's distance from its key's home slot, plus one.  ``htk``
    is one ``(S,)`` table or packed ``(P, S)`` tables (a key's home is in
    its own row).  It is the mean probe length of a lookup when every
    build key is probed alike."""
    from repro_torch.core import blocks
    rows = htk.reshape(-1, htk.shape[-1])
    n_slots = rows.shape[1]
    used = rows != blocks.EMPTY
    if not bool(used.any()):
        return 0.0
    at = torch.arange(n_slots, device=rows.device)
    walk = ((at - blocks.hash_fn(rows, n_slots)) & (n_slots - 1)) + 1
    return float(walk[used].double().mean())


def agg_need(keys: torch.Tensor, htk: torch.Tensor, l2_bytes: int) -> dict:
    """What one ``probe_agg`` call needs on this data, for its bound: the
    keys and vals read once (8 bytes a row), the 64-byte segments of the
    table's keys its probes visit and of its payloads they hit, and the
    4-byte result.  For a table whose slots (8 bytes each, key and
    payload) are more than the L2's ``l2_bytes``, those segments count
    only at the share ``l2_bytes / table bytes`` the L2 can hold (read
    once), and one 32-byte sector a probe counts at the share ``1 -
    l2_bytes / table bytes`` it cannot, which any layout of the table
    reads from device memory.  Operations: 4 a probe step, 2 a hit."""
    n = keys.shape[0]
    slot, visited, steps = probe_walk(keys, htk)
    hits = torch.zeros_like(visited)
    hits[slot[slot >= 0]] = True
    found = int((slot >= 0).sum())
    table = 8 * htk.shape[0]
    held = min(1.0, l2_bytes / table)
    table_read = (segment_bytes(visited) + segment_bytes(hits)) * held
    past_l2 = n * SECTOR * (1 - held)
    moved = 8 * n + table_read + 4 + past_l2
    ops = 4 * steps + 2 * found
    return {"bytes": moved, "ops": ops, "table_bytes": table,
            "table_read_bytes": table_read, "past_l2_bytes": past_l2,
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT32_OPS_PER_S * 1e3}


def sparse_need(x: torch.Tensor, lo, hi) -> dict:
    """What one ``select_scan_sparse`` call needs on this data, for its
    bound: x read once (4n), the 64-byte segments of y (16 rows each)
    that hold a selected row, and out written whole (4n: the selected
    entries and the zeros past the count, as the contract asks).
    Operations: 2 compares a row."""
    n = x.shape[0]
    hit = (x >= lo) & (x <= hi)
    y_bytes = segment_bytes(hit)
    moved = 4 * n + y_bytes + 4 * n
    return {"bytes": moved, "ops": 2 * n, "count": int(hit.sum()),
            "y_bytes": y_bytes, "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": 2 * n / INT32_OPS_PER_S * 1e3}


def must_move(spja_args, n_groups: int, pred_widths=None, key_widths=None,
              key_refs=None, m_widths=None, m_refs=None, n_rows=None,
              measure_op=None) -> dict:
    """What one ``spja`` call needs on this data, for its bound.

    Bytes: the kernel loads a row's next column only while the row is
    live (predicates in order, then join keys, then measures), so each
    column costs the 64-byte segments that hold a live row when it is
    first read (the first column in full); a column packed c values a
    word holds 16·c rows a segment.  Each table costs the segments of the
    slots its probes visit (keys) or hit (payloads); the output is
    (n_groups,) f32.  Operations: 2 compares per predicate and live row, 4
    per probe step (multiply, mask, 2 compares), 2 per hit (group
    multiply-add), 2 per summed row (measure op and add), and 2 per value
    decoded from a packed stream (shift, mask)."""
    from repro_torch.kernels import ref
    pred_cols, bounds, join_keys, tables, mults, m1, m2 = spja_args
    n = m1.shape[0] if n_rows is None else int(n_rows)
    n_meas = 1 if m2 is None else 2
    pred_widths = ref.stream_widths(pred_widths, len(pred_cols))
    key_widths = ref.stream_widths(key_widths, len(join_keys))
    m_widths = ref.stream_widths(m_widths, n_meas)
    key_refs = ref.refs_list(key_refs, len(join_keys))
    m_refs = ref.refs_list(m_refs, n_meas)
    live = torch.ones(n, dtype=torch.bool, device=m1.device)
    seen, fact, table, ops = set(), 0, 0, 0

    def read(col, width, r=0):
        """The stream's values; counts its bytes on its first read."""
        nonlocal fact, ops
        if col.data_ptr() not in seen:
            seen.add(col.data_ptr())
            fact += segment_bytes(live, 16 * (32 // width))
            if width != 32:
                ops += 2 * int(live.sum())
        return ref.decode_stream(col, width, r, n)

    for col, w, (lo, hi) in zip(pred_cols, pred_widths,
                                ref.bounds_list(bounds, len(pred_cols))):
        vals = read(col, w)
        ops += 2 * int(live.sum())
        live &= (vals >= lo) & (vals <= hi)
    group = torch.zeros(n, dtype=torch.int64, device=m1.device)
    for j, (col, w, mult) in enumerate(
            zip(join_keys, key_widths, ref.mults_list(mults, len(join_keys)))):
        keys = read(col, w, key_refs[j])
        htk, htv = tables[2 * j], tables[2 * j + 1]
        rows = live.nonzero().squeeze(1)
        slot, visited, steps = probe_walk(keys[rows], htk)
        hit = slot >= 0
        hit_slots = torch.zeros_like(visited)
        hit_slots[slot[hit]] = True
        table += segment_bytes(visited) + segment_bytes(hit_slots)
        ops += 4 * steps + 2 * int(hit.sum())
        live[rows] = hit
        group[rows[hit]] += htv[slot[hit]].to(torch.int64) * mult
    live &= (group & 0xFFFFFFFF) < n_groups     # the kernel's uint32 test
    read(m1, m_widths[0], m_refs[0])
    if m2 is not None:
        read(m2, m_widths[1], m_refs[1])
    ops += 2 * int(live.sum())
    moved = fact + table + 4 * n_groups
    return {"fact_bytes": fact, "table_bytes": table, "bytes": moved,
            "ops": ops, "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT32_OPS_PER_S * 1e3}


def wave_need(wave_args, n_groups: int, pred_widths=None, key_widths=None,
              key_refs=None, m_widths=None, m_refs=None, n_rows=None,
              member_groups=None, probe_groups=None) -> dict:
    """What one ``multi_spja`` call needs on this data, for its bound.

    Bytes: the kernel loads a row's predicate column while a live member
    filters it, a join key while a live member uses the join or takes its
    payload, and a measure while a live member sums it; each distinct
    stream costs the 64-byte segments that hold a row it is loaded for (a
    column named twice, as lo_orderdate is as predicate and key, once; a
    column packed c values a word holds 16·c rows a segment), each
    distinct table the segments its probes visit (keys) or hit
    (payloads), and the output is (Q, n_groups) f32.  Operations: 2
    compares per filtering live member and row, 4 per probe step, 2 per
    join of a live member's group id, 2 per summed row (measure op and
    add), 2 per value decoded from a packed stream.  ``steps``: the probe
    steps (table slots read).  The work is the wave's, whatever tables
    the kernel probes: ``probe_groups`` (its merged tables) changes no
    count, so the bound stays the one the kernel before them had."""
    from repro_torch.kernels import ref
    pred_cols, bounds, join_keys, tables, mults, use, valid, meas, sel = \
        wave_args
    c_n, j_n, m_n = len(pred_cols), len(join_keys), len(meas)
    bounds, mults, use, valid, sel = ref.wave_params(
        bounds, mults, use, valid, sel, c_n, j_n, m_n)
    pred_widths = ref.stream_widths(pred_widths, c_n)
    key_widths = ref.stream_widths(key_widths, j_n)
    m_widths = ref.stream_widths(m_widths, m_n)
    key_refs = ref.refs_list(key_refs, j_n)
    m_refs = ref.refs_list(m_refs, m_n)
    n = meas[0].shape[0] if n_rows is None else int(n_rows)
    dev = meas[0].device
    real = [q for q in range(valid.shape[0]) if valid[q]]
    live = torch.zeros((valid.shape[0], n), dtype=torch.bool, device=dev)
    live[real] = True
    loaded, visited_by, hit_by, payloads = {}, {}, {}, {}
    ops = steps_all = 0

    def load(col, width, rows):
        nonlocal ops
        prev = loaded.get(col.data_ptr())
        loaded[col.data_ptr()] = (rows if prev is None else prev[0] | rows,
                                  width)
        if width != 32:
            ops += 2 * int(rows.sum())

    every = (-(1 << 31), (1 << 31) - 1)
    for c, (col, w) in enumerate(zip(pred_cols, pred_widths)):
        filt = [q for q in real if tuple(bounds[q, c]) != every]
        rows = live[filt].any(0) if filt else None
        if rows is None or not bool(rows.any()):
            continue
        load(col, w, rows)
        vals = ref.decode_stream(col, w, 0, n)
        for q in filt:
            ops += 2 * int(live[q].sum())
            live[q] &= (vals >= int(bounds[q, c, 0])) & \
                (vals <= int(bounds[q, c, 1]))
    for j, (col, w) in enumerate(zip(join_keys, key_widths)):
        need = [q for q in real if use[q, j] or mults[q, j]]
        rows = live[need].any(0) if need else None
        if rows is None or not bool(rows.any()):
            continue
        load(col, w, rows)
        idx = rows.nonzero().squeeze(1)
        htk, htv = tables[2 * j], tables[2 * j + 1]
        slot, visited, steps = probe_walk(
            ref.decode_stream(col, w, key_refs[j], n)[idx], htk)
        hit = slot >= 0
        hits = torch.zeros_like(visited)
        hits[slot[hit]] = True
        k = htk.data_ptr()
        visited_by[k] = visited | visited_by.get(k, False)
        hit_by[k] = hits | hit_by.get(k, False)
        ops += 4 * steps
        steps_all += steps
        if any(mults[q, j] for q in need):
            payload = torch.zeros(n, dtype=torch.int64, device=dev)
            payload[idx[hit]] = htv[slot[hit]].to(torch.int64)
            payloads[j] = payload
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        found[idx[hit]] = True
        for q in need:
            if use[q, j]:
                live[q] &= found
    for m, (col, w) in enumerate(zip(meas, m_widths)):
        users = [q for q in real
                 if sel[q, 0] == m or (sel[q, 2] and sel[q, 1] == m)]
        rows = live[users].any(0) if users else None
        if rows is not None and bool(rows.any()):
            load(col, w, rows)
    for q in real:
        own = [j for j in range(j_n) if mults[q, j]]
        ops += 2 * len(own) * int(live[q].sum())
        group = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in own:           # no payload: the member died before join j
            if j in payloads:
                group += payloads[j] * int(mults[q, j])
        ops += 2 * int((live[q] & ((group & 0xFFFFFFFF) < n_groups)).sum())
    fact = sum(segment_bytes(rows, 16 * (32 // w))
               for rows, w in loaded.values())
    table = sum(segment_bytes(v) for v in visited_by.values()) + \
        sum(segment_bytes(h) for h in hit_by.values())
    moved = fact + table + 4 * valid.shape[0] * n_groups
    return {"fact_bytes": fact, "table_bytes": table, "bytes": moved,
            "ops": ops, "steps": steps_all,
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT32_OPS_PER_S * 1e3}


def spja_launch_info(ssb_fused, plan, dev) -> dict:
    """The block size and blocks an SM of one fused query's ``spja``
    launch (``ssb_fused.launch_shape``)."""
    _, blocks = ssb_fused.launch_shape(ssb_fused.library(), dev.index,
                                       len(plan.preds), len(plan.joins),
                                       plan.n_groups)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"block": ssb_fused.THREADS, "blocks_per_sm": blocks // sms,
            "warps_per_sm": blocks // sms * ssb_fused.THREADS // 32}


def wave_probes(wave_args, n_groups: int, key_widths=None, key_refs=None,
                pred_widths=None, n_rows=None, probe_groups=None,
                **_) -> int:
    """The probes one ``multi_spja`` call makes on this data, modelled on
    the host from the lowering (the kernel counts nothing): for each probe
    group in order (``probe_groups``; without it each stream is a group,
    in stream order, as the kernel before the merged tables probed), the
    rows on which a live member needs one of its streams; then the
    members that use a stream that missed die."""
    from repro_torch.core import blocks as B
    from repro_torch.kernels import ref
    pred_cols, bounds, join_keys, tables, mults, use, valid, meas, sel = \
        wave_args
    c_n, j_n = len(pred_cols), len(join_keys)
    bounds, mults, use, valid, sel = ref.wave_params(
        bounds, mults, use, valid, sel, c_n, j_n, len(meas))
    pred_widths = ref.stream_widths(pred_widths, c_n)
    key_widths = ref.stream_widths(key_widths, j_n)
    key_refs = ref.refs_list(key_refs, j_n)
    n = meas[0].shape[0] if n_rows is None else int(n_rows)
    dev = meas[0].device
    real = [q for q in range(valid.shape[0]) if valid[q]]
    live = torch.zeros((valid.shape[0], n), dtype=torch.bool, device=dev)
    live[real] = True
    for c, (col, w) in enumerate(zip(pred_cols, pred_widths)):
        vals = ref.decode_stream(col, w, 0, n)
        for q in real:
            live[q] &= (vals >= int(bounds[q, c, 0])) & \
                (vals <= int(bounds[q, c, 1]))
    groups = probe_groups or [((j,), None) for j in range(j_n)]
    probes = 0
    for streams, _ in groups:
        need = [q for q in real
                if any(use[q, j] or mults[q, j] for j in streams)]
        if not need:
            continue
        probes += int(live[need].any(0).sum())
        keys = ref.decode_stream(join_keys[streams[0]],
                                 key_widths[streams[0]],
                                 key_refs[streams[0]], n)
        for j in streams:
            users = [q for q in need if use[q, j]]
            if users:
                found = B.block_lookup(keys, tables[2 * j],
                                       tables[2 * j + 1])[1] > 0
                live[users] &= found
    return probes


def call_rows(fn: str, args: tuple) -> int:
    """The rows one call of a kernel other than ``spja`` works on."""
    if fn == "select_scan_packed":
        return args[1].shape[0]
    if fn == "unpack":
        return int(args[1])
    return args[0].shape[0]


def opat_need(fn: str, args: tuple, out) -> dict:
    """What one call of an opat kernel needs on its inputs, for its
    bound: each input read once and each output written once, and the
    operations of the function in the inputs' type.

    select_scan: x and y read (8n), the selected entries written (4 per
    selected row), 2 compares a row.  probe_join: keys and vals read
    (8n), payload and val written per found row (8), the 64-byte table
    segments the probes visit (keys) or hit (payloads), 4 operations per
    probe step.  project: 12n bytes, 3 f32 operations a row.  group_sum:
    ids and vals read (8n), the (n_groups,) sums written in the values'
    type (4 bytes a group), an add a row (in the values' type, f32 on the
    path).  select_scan_packed: the packed words and y read (4 bytes a
    word, 4 a row), the selected entries written, 4 operations a row
    (shift, mask, 2 compares).  unpack: the words read and the n values
    written, 3 operations a value (shift, mask, add).

    histogram: the keys read (4n) and the (tiles, 2^r) counts written, 3
    operations a row (shift, mask, add).  partition_multi: the key and N
    payload columns read and written ((1 + N)·8 bytes a row) and the
    histogram read, 3 operations a row (shift, mask, position add).
    part_probe: the rowid of each row before the runs' end read (4), the
    key and group of each live one (rowid >= 0; 8), the 64-byte table
    segments its probes visit (keys) or hit (payloads), the offs and
    counts, and rowid and group written per match (8); 4 operations per
    probe step and 2 per match (group multiply-add)."""
    n = call_rows(fn, args)
    if fn == "select_scan_packed":
        count = int(out[1])
        moved = 4 * args[0].shape[0] + 4 * n + 4 * count
        ops, rate = 4 * n, INT32_OPS_PER_S
    elif fn == "unpack":
        moved = 4 * -(-n // (32 // args[2])) + 4 * n
        ops, rate = 3 * n, INT32_OPS_PER_S
    elif fn == "select_scan":
        count = int(out[1])
        moved, ops, rate = 8 * n + 4 * count, 2 * n, INT32_OPS_PER_S
    elif fn == "probe_join":
        count = int(out[2])
        slot, visited, steps = probe_walk(args[0], args[2])
        hit = torch.zeros_like(visited)
        hit[slot[slot >= 0]] = True
        moved = 8 * n + 8 * count + segment_bytes(visited) + \
            segment_bytes(hit)
        ops, rate = 4 * steps, INT32_OPS_PER_S
    elif fn == "project":
        moved, ops, rate = 12 * n, 3 * n, F32_OPS_PER_S
    elif fn == "group_sum":
        moved, ops = 8 * n + args[1].element_size() * args[2], n
        rate = F32_OPS_PER_S if args[1].is_floating_point() \
            else INT32_OPS_PER_S
    elif fn == "histogram":
        tiles = -(-n // 2048)
        moved, ops, rate = 4 * n + 4 * tiles * (1 << args[2]), 3 * n, \
            INT32_OPS_PER_S
    elif fn == "partition_multi":
        tiles = -(-n // 2048)
        moved = (1 + len(args[1])) * 8 * n + 4 * tiles * (1 << args[3])
        ops, rate = 3 * n, INT32_OPS_PER_S
    elif fn == "part_probe":
        keys, rowids, _, offs, counts, htk = args[:6]
        end = min(n, int(offs[-1]) + int(counts[-1])) if offs.numel() else 0
        live = (rowids[:end] >= 0).nonzero().squeeze(1)
        count = int(out[2])
        slot, visited, steps = probe_walk(keys[live], htk)
        hit = torch.zeros_like(visited)
        hit[slot[slot >= 0]] = True
        moved = 4 * end + 8 * live.numel() + segment_bytes(visited) + \
            segment_bytes(hit) + 8 * offs.numel() + 8 * count
        ops, rate = 4 * steps + 2 * count, INT32_OPS_PER_S
    else:
        raise ValueError(f"no bound for {fn!r}")
    return {"bytes": moved, "ops": ops,
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / rate * 1e3}


def library_call(fn: str):
    """One PyTorch call computing the same function on the same inputs,
    timed beside the kernel and used nowhere in the port; None where
    there is none."""
    if fn == "group_sum":
        return lambda ids, vals, n_groups: torch.zeros(
            (n_groups,), dtype=vals.dtype, device=vals.device).index_add_(
                0, ids, vals)
    if fn == "project":
        def sub(x1, x2, a, b, sigmoid=False):
            if (a, b, sigmoid) != (1.0, -1.0, False):
                raise ValueError("torch.sub computes only a=1, b=-1")
            return torch.sub(x1, x2)
        return sub
    return None


def outputs(got) -> tuple:
    """A kernel's outputs as one flat tuple of tensors."""
    if not isinstance(got, tuple):
        return (got,)
    return tuple(t for g in got for t in outputs(g))


def check_against_plain(fn: str, label: str, got, want, again=None,
                        sigmoid: bool = False) -> float:
    """Hold a kernel's outputs against its plain version's (``again``: a
    second run, for the f32 group sums); returns the largest absolute
    difference."""
    err = 0.0
    for g, w in zip(outputs(got), outputs(want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{fn} {label}: {g.dtype} {tuple(g.shape)}"
                                 f" vs plain {w.dtype} {tuple(w.shape)}")
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    if sigmoid:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    elif fn == "group_sum" and got.is_floating_point() and again is not None:
        if not torch.equal(again, got):
            raise AssertionError(f"{fn} {label}: two runs differ")
        ulp = (torch.nextafter(want, torch.full_like(want, float("inf")))
               - want).abs()
        if not bool(((got - want).abs() <= ulp).all()):
            raise AssertionError(f"{fn} {label}: more than 1 ulp from plain")
    elif not all(torch.equal(g, w)
                 for g, w in zip(outputs(got), outputs(want))):
        raise AssertionError(f"{fn} {label}: kernel != plain, "
                             f"max |err| {err}")
    return err


# device kernels by name: the port's own (by the wrapper that launches
# them) and PyTorch's glue around them; first match wins
DEVICE_KINDS = [("select_packed_sweep", "select_scan_packed"),
                ("select_sparse_sweep", "select_scan_sparse"),
                ("select_sweep", "select_scan"),
                ("part_probe", "part_probe"), ("probe_join", "probe_join"),
                ("probe_agg_sweep", "probe_agg"), ("pair_slots", "probe_agg"),
                ("group_sum", "group_sum"),
                ("project_kernel", "project"),
                ("multi_spja_kernel", "multi_spja"), ("spja_kernel", "spja"),
                ("build_", "build"), ("radix_histogram", "histogram"),
                ("radix_sweep", "partition_multi"),
                ("radix_counts", "digit_counts"),
                ("reduce_sum", "reduce_sum"),
                ("arange", "torch arange"), ("index", "torch gather"),
                ("copy", "torch copy/cast"), ("Fill", "torch zeros"),
                ("Memcpy HtoD", "copy to device"),
                ("Memcpy", "copy to host"), ("Memset", "memset")]


def device_kind(name: str) -> str:
    """The kind a device record of this name is filed under."""
    return next((k for sub, k in DEVICE_KINDS if sub in name), "other")


def profiled(run, expect=()) -> dict:
    """Device time by kind over one call of ``run`` under torch.profiler,
    the kernels behind each kind (name cut to 96 characters, launches,
    ms; the three longest), and the device's busy share of the wall time
    (a lower bound: the profiler adds host time per operation).

    The profiler can lose device records: on an H100 it dropped the
    first device records of a profile, more of them the longer the
    process had run, whatever they were (``profiler_check.py``).  So
    ``PROFILE_HEAD`` tiny spin kernels run first inside the window, to be
    lost in the run's place, and are left out of the result.  A profile
    that still lacks a device kernel for some other kernel launch the
    host recorded, or a kind in ``expect``, is taken again, ``run`` and
    all, after each longer head of ``PROFILE_RETRY_HEADS``; ``lost``
    gives each profile dropped so (its head, the spin kernels and the
    run's kernels it kept, the run's launches).  Raises if the last one
    lost records too."""
    lost = []
    for head in (PROFILE_HEAD, *PROFILE_RETRY_HEADS):
        prof = profile_once(run, head)
        if prof["kernels_kept"] and prof["kernels_kept"] >= prof["launches"] \
                and set(expect) <= set(prof["device_ms"]):
            return dict(prof, lost=lost)
        lost.append({k: prof[k] for k in ("head", "spins_kept",
                                          "kernels_kept", "launches")})
    raise AssertionError(
        f"the profile lost device records in every try: {lost}, kinds "
        f"{sorted(prof['device_ms'])}, expected {sorted(expect)}")


def profile_once(run, head: int) -> dict:
    """One profile of ``run`` after ``head`` spin kernels, as ``profiled``
    gives it, with the spin kernels and the run's kernels it kept."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(head):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    launches = sum(e.device_type != cuda and ("LaunchKernel" in e.name or
                                              "LaunchCooperativeKernel" in
                                              e.name)
                   for e in events) - head
    kinds, names, kernels, spins = {}, {}, 0, 0
    for e in events:
        if e.device_type != cuda:
            continue
        if "spin_kernel" in e.name:
            spins += 1
            continue
        kernels += not e.name.startswith(("Memcpy", "Memset"))
        kind = device_kind(e.name)
        ms = e.device_time / 1e3
        kinds[kind] = kinds.get(kind, 0.0) + ms
        calls, total = names.setdefault(kind, {}).get(e.name[:96], (0, 0.0))
        names[kind][e.name[:96]] = (calls + 1, total + ms)
    busy = sum(kinds.values())
    return {"device_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "kernels": {kind: sorted(([name, *v] for name, v in by.items()),
                                     key=lambda r: -r[2])[:3]
                        for kind, by in names.items()},
            "busy_ms": busy, "wall_ms": wall_ms, "busy_share": busy / wall_ms,
            "launches": launches, "head": head, "spins_kept": spins,
            "kernels_kept": kernels}


def one_call(fn: str, run, n: int, count: int, lib, columns: int = 2,
             shape: tuple = None) -> dict:
    """The device work of one call of a one-sweep compaction wrapper
    (``probe_join``, ``part_probe``: two output columns; ``select_scan``,
    ``select_scan_packed``: one), from the profile: raises unless it is
    one kernel of the wrapper's kind and one memset (the status words and
    the ticket).  Beside them, the sweep's resident blocks an SM
    (``lib``'s ``shape`` = (function, flag), by default ``<fn>_shape``
    and 0) and the device time of a fill of the columns·(n − count) zeros
    the sweep writes past the count, as one ``torch.zeros`` (what the
    sweep's zero tail would cost alone)."""
    prof = profiled(run, (fn,))
    calls = {kind: sum(c for _, c, _ in rows)
             for kind, rows in prof["kernels"].items()}
    if calls != {fn: 1, "memset": 1}:
        raise AssertionError(f"{fn}: one call launched {calls}, not one "
                             "sweep and one memset")
    fill = profiled(lambda: torch.zeros(
        (columns, n - count), dtype=torch.int32,
        device="cuda")) if count < n else {}
    from repro_torch.kernels import build
    dev = torch.cuda.current_device()
    shape_fn, flag = shape or (f"{fn}_shape", 0)
    blocks = build.resident(lib, shape_fn, dev, flag)
    return {"fn": fn, "n": n, "count": count,
            "blocks_per_sm": blocks / torch.cuda.get_device_properties(
                dev).multi_processor_count,
            "kernel": prof["kernels"][fn][0][0],
            "kernel_ms": prof["device_ms"][fn],
            "memset_ms": prof["device_ms"]["memset"],
            "zero_tail_fill_ms": fill.get("device_ms", {}).get("torch zeros",
                                                               0.0)}


def one_kernel(fn: str, run, also=()) -> dict:
    """The device work of one call of a wrapper that is one kernel a call
    (``group_sum``; ``build``, whose EMPTY flag is also read back, kind
    ``copy to host``), from the profile: raises unless it is one kernel
    of the wrapper's kind and at most one record of each kind in
    ``also``."""
    prof = profiled(run, (fn,))
    calls = {kind: sum(c for _, c, _ in rows)
             for kind, rows in prof["kernels"].items()}
    if calls.get(fn) != 1 or set(calls) - {fn, *also} or \
            any(calls.get(k, 0) > 1 for k in also):
        raise AssertionError(f"{fn}: one call launched {calls}, not one "
                             "kernel")
    return {k: prof[k] for k in ("device_ms", "kernels")}


@contextlib.contextmanager
def acc_budget(mf, budget: int):
    """Within the block, the wave kernel's member grids get ``budget``
    bytes (``multi_fused.ACC_BUDGET_BYTES``)."""
    saved, mf.ACC_BUDGET_BYTES = mf.ACC_BUDGET_BYTES, budget
    try:
        yield
    finally:
        mf.ACC_BUDGET_BYTES = saved


@contextlib.contextmanager
def nonempty_partitions(radix):
    """Within the block, every ``radix.histogram`` call appends to the
    yielded list the number of buckets its rows fill: the partitions
    ``part_loop`` probes."""
    real, seen = radix.histogram, []

    def recorded(keys, start_bit, r):
        hist = real(keys, start_bit, r)
        seen.append(int((hist.sum(0) > 0).sum()))
        return hist
    radix.histogram = recorded
    try:
        yield seen
    finally:
        radix.histogram = real


def fig8_db(ssb, rng: np.random.Generator, n_dim: int,
            revenue: np.ndarray):
    """``benchmarks/run.py::_fig8_db``'s star join: a fact FK uniform over
    a dim of ``n_dim`` rows with payload ``p_group = key % 64``."""
    i32 = np.int32
    fact = ssb.Table("lineorder", {
        "lo_partkey": rng.integers(0, n_dim, revenue.shape[0], dtype=i32),
        "lo_revenue": revenue})
    dim = ssb.Table("part", {"p_partkey": np.arange(n_dim, dtype=i32),
                             "p_group": np.arange(n_dim, dtype=i32) % 64})
    stub = ssb.Table("stub", {"x": np.zeros(1, i32)})
    return ssb.Database(fact, stub, stub, stub, dim, sf=0.0)


def query_ms(q, database, cache) -> list:
    """Host times of QUERY_REPS runs of one compiled query, each from a
    synchronised start to its result on the host."""
    times = []
    for _ in range(QUERY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q.execute(database, cache=cache)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class Timed:
    """Stands in for a kernel wrapper for one timed pass: each call runs
    the wrapper CALL_REPS times back to back between CUDA events (after
    one warm-up call), then the plain version and the library call on the
    same inputs, and keeps the times and the call's bound.  ``project``,
    whose calls on the pass are their fixed cost, is timed in turns with
    its library call instead (``turns``: medians of TURN_ROUNDS rounds of
    TURN_CALLS calls)."""

    def __init__(self, mod, fn: str, plain):
        self.mod, self.fn, self.plain = mod, fn, plain
        self.kernel = getattr(mod, fn)
        self.library = library_call(fn)
        self.rows, self.err = [], 0.0

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        row = {}
        if self.fn == "project":        # a call is its fixed cost: turns
            row["turns"] = turns(lambda: self.kernel(*args, **kw),
                                 lambda: self.library(*args, **kw))
            ms = row["turns"]["kernel_median"]
            lib_ms = row["turns"]["library_median"]
        else:
            ms = event_ms(lambda: self.kernel(*args, **kw), CALL_REPS)
            lib_ms = (None if self.library is None else
                      event_ms(lambda: self.library(*args, **kw), CALL_REPS))
        want = self.plain(*args, **kw)
        plain_ms = event_ms(lambda: self.plain(*args, **kw), 1)
        again = self.kernel(*args, **kw) if self.fn == "group_sum" else None
        if self.fn in SWEEPS:
            if not all(torch.equal(a, b) for a, b in
                       zip(outputs(out), outputs(self.kernel(*args)))):
                raise AssertionError(f"{self.fn}: two runs of a pass's call "
                                     "differ")
            zeros = (len(out) - 1) * (call_rows(self.fn, args) -
                                      int(out[-1]))
            row["zero_tail_ms"] = event_ms(lambda: torch.zeros(
                (zeros,), dtype=torch.int32, device=out[0].device),
                CALL_REPS)
        self.err = max(self.err, check_against_plain(
            self.fn, "opat pass", out, want, again=again,
            sigmoid=kw.get("sigmoid", False)))
        self.rows.append(dict(opat_need(self.fn, args, out), **row,
                              n=call_rows(self.fn, args), ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms))
        return out

    def __enter__(self):
        setattr(self.mod, self.fn, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.fn, self.kernel)


def resident_phases() -> dict:
    """Phases 1-10; returns what phase 11 reads.  Every other tensor they
    made is freed when this returns, so phase 11 starts from the hash
    cache alone."""
    from repro_torch import cases
    from repro_torch.kernels import build, ref, ssb_fused
    from repro_torch.sql import engine, hashtable, ssb, storage
    from repro_torch.sql import compile as TC
    from repro_torch.sql import model as M
    from repro_torch.sql import plan as P
    from repro_torch.sql.compile import compile_plan, fused_inputs
    # ORDER BY's digit width when no tunings file is cached
    from repro_torch.sql.tune import DEFAULT_R as SORT_BITS
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, *_ in OPAT + PACKED + PARTITIONED + SHARED + JOIN_BENCH +
            LAST}

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1 card")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    t = phase("2 build")
    names = build.names()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(build.build, names)))
    for name in names:
        print(build.library_path(name).relative_to(ROOT))
        entry = ""
        for line in logs[name].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {entry[-48:]}: {line.strip()}")
    for mod in (ssb_fused, *mods.values()):
        mod.library()
    print(f"build_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase("3 kernel vs plain (synthetic, bit-identical)")
    max_err = packed_err = 0.0
    spja_cases = [(label, kw, cases.spja_case) for label, kw in SYNTHETIC] + \
        [(label, kw, cases.packed_spja_case) for label, kw in PACKED_SPJA]
    for i, (label, kw, make) in enumerate(spja_cases):
        c = make(1000 + i, **kw)
        a, k = c.args(dev)
        before = ssb_fused.LAUNCHES
        got = ssb_fused.spja(*a, **k)
        if ssb_fused.LAUNCHES != before + 1:
            raise AssertionError(f"{label}: the kernel did not launch")
        want = ref.spja(*a, **k)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if c.packed:
            packed_err = max(packed_err, err)
        else:
            max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain, max |err| {err}")
        nonzero = int((got != 0).sum())
        if kw.get("empty_join") and nonzero:
            raise AssertionError(f"{label}: an empty build side must give 0")
        if not kw.get("empty_join") and not nonzero:
            raise AssertionError(f"{label}: vacuous case, all groups zero")
        print(f"{label}: n={c.n} n_groups={c.n_groups} nonzero={nonzero} "
              f"max_abs_err={err} ok", flush=True)
    opat_err = {}
    for m, fn, counter, *_ in [(m, fn, "LAUNCHES") for m, fn, *_ in OPAT] + \
            PACKED:
        opat_err[fn] = 0.0
        for label, gen, gen_args, extra, sigmoid in OPAT_SYNTHETIC[fn]:
            args = cases.tensors(getattr(cases, gen)(*gen_args), dev) + extra
            kw = {"sigmoid": sigmoid} if fn == "project" else {}
            before = getattr(mods[m], counter)
            got = getattr(mods[m], fn)(*args, **kw)
            if getattr(mods[m], counter) != before + 1:
                raise AssertionError(f"{fn} {label}: the kernel did not "
                                     "launch")
            again = getattr(mods[m], fn)(*args) if fn == "group_sum" \
                else None
            want = getattr(ref, fn)(*args, **kw)
            torch.cuda.synchronize()
            if fn in SWEEPS and not all(
                    torch.equal(a, b) for a, b in
                    zip(outputs(got), outputs(getattr(mods[m], fn)(*args)))):
                raise AssertionError(f"{fn} {label}: two runs differ")
            err = check_against_plain(fn, label, got, want, again, sigmoid)
            opat_err[fn] = max(opat_err[fn], err)
            what = (f"count={int(got[-1])}" if isinstance(got, tuple)
                    else f"nonzero={int((got != 0).sum())}")
            print(f"{fn} {label}: {what} max_abs_err={err} ok", flush=True)
    radix, pprobe = mods["radix_part"], mods["part_probe"]
    part_err = {fn: 0.0 for _, fn, *_ in PARTITIONED}
    part_err["digit_counts"] = 0.0

    def held(fn, label, got, again, want):
        """A radix-slice kernel against its plain version and its own
        second run, bit for bit."""
        if not all(torch.equal(a, b) for a, b in
                   zip(outputs(got), outputs(again))):
            raise AssertionError(f"{fn} {label}: two runs differ")
        part_err[fn] = max(part_err[fn],
                           check_against_plain(fn, label, got, want))

    def radix_counts():
        return (radix.HIST_LAUNCHES, radix.COUNT_LAUNCHES,
                radix.SCATTER_LAUNCHES)

    for i, (start_bit, r, kind, n_vals) in enumerate(cases.RADIX_CASES):
        for n in (BIG, 37):
            keys, vals, _, _ = cases.tensors(cases.radix_case(
                3000 + i, n, start_bit, r, kind, n_vals), dev)
            label = f"{kind}, bits {start_bit}+{r}, {n_vals} payloads, n={n}"
            before = radix_counts()
            hist = radix.histogram(keys, start_bit, r)
            again = radix.histogram(keys, start_bit, r)
            held("histogram", label, hist, again,
                 ref.histogram(keys, start_bit, r))
            # the one-sweep pass: bucket counts from the histogram, then
            # from the digit-count kernel
            got = radix.partition_multi(keys, vals, start_bit, r, hist=hist)
            again = radix.partition_multi(keys, vals, start_bit, r)
            held("partition_multi", label, got, again,
                 ref.partition_multi(keys, vals, start_bit, r))
            if radix_counts() != (before[0] + 2, before[1] + 1,
                                  before[2] + 2):
                raise AssertionError(f"radix {label}: the kernels did not "
                                     "launch as called")
            passes = min((31 - start_bit) // r + 1,
                         radix.MAX_COUNTERS >> r)
            got = radix.digit_counts(keys, start_bit, r, passes)
            held("digit_counts", f"{label}, {passes} passes", got,
                 radix.digit_counts(keys, start_bit, r, passes),
                 ref.digit_counts(keys, start_bit, r, passes))
            print(f"histogram + partition_multi + digit_counts {label}: "
                  f"buckets filled {int((hist.sum(0) > 0).sum())} ok",
                  flush=True)
    for kind, plan in SORT_SYNTHETIC:
        keys, vals = cases.tensors(cases.sort_case(3100, BIG, kind), dev)
        before = radix_counts()
        got = radix.radix_sort(keys, vals)
        if radix_counts() != (before[0], before[1] + 1,
                              before[2] + len(plan)):
            raise AssertionError(f"radix_sort {kind}: launched "
                                 f"{radix_counts()} after {before}, "
                                 f"expected passes {plan}")
        held("partition_multi", f"radix_sort, {kind} keys, n={BIG}", got,
             radix.radix_sort(keys, vals), ref.radix_sort(keys, vals))
        print(f"radix_sort {kind} keys n={BIG}: passes {plan}, unsigned "
              "order ok", flush=True)
    for kind in cases.PART_PROBE_KINDS:
        for bits, n in ((1, PART_N), (4, PART_N), (8, PART_N), (4, 37)):
            args = cases.tensors(cases.part_probe_case(3200 + bits, n, bits,
                                                       kind), dev)
            before = pprobe.LAUNCHES
            got = pprobe.part_probe(*args)
            if pprobe.LAUNCHES != before + 1:
                raise AssertionError(f"part_probe {kind}: the kernel did "
                                     "not launch")
            label = f"{kind}, P={1 << bits}, n={n}"
            held("part_probe", label, got, pprobe.part_probe(*args),
                 ref.part_probe(*args))
            print(f"part_probe {label}: count={int(got[2])} ok", flush=True)
    mf, hj, ag = mods["multi_fused"], mods["hash_join"], mods["agg"]
    new_err = {"multi_spja": 0.0, "probe_agg": 0.0, "reduce_sum": 0.0}
    for i, (label, kw) in enumerate(MULTI_SYNTHETIC):
        c = cases.multi_spja_case(5000 + i, **kw)
        a, k = c.args(dev, merged=kw.get("merge", 1) > 1)
        before = mf.LAUNCHES
        got = mf.multi_spja(*a, **k, member_groups=c.member_groups)
        if mf.LAUNCHES != before + 1:
            raise AssertionError(f"multi_spja {label}: the kernel did not "
                                 "launch")
        # a second run with every sum through L2: the same bits
        with acc_budget(mf, 0):
            again = mf.multi_spja(*a, **k)
        want = ref.multi_spja(*a, **k)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"multi_spja {label}: two runs differ")
        new_err["multi_spja"] = max(new_err["multi_spja"], check_against_plain(
            "multi_spja", label, got, want))
        if got[torch.from_numpy(c.q_valid == 0)].any():
            raise AssertionError(f"multi_spja {label}: padding added")
        if not got.any():
            raise AssertionError(f"multi_spja {label}: vacuous, all zero")
        print(f"multi_spja {label}: n={c.n} Q={len(c.q_valid)} "
              f"nonzero={(got != 0).sum(1).tolist()} ok", flush=True)
    for fn, label, gen, gen_args in SUM_SYNTHETIC:
        mod, counter = (hj, "AGG_LAUNCHES") if fn == "probe_agg" else \
            (ag, "SUM_LAUNCHES")
        args = cases.tensors(getattr(cases, gen)(*gen_args), dev)
        if fn == "reduce_sum" and gen_args[0] == BIG:
            args = (args[0][1:],)       # not 16-byte aligned
        before = getattr(mod, counter)
        got = getattr(mod, fn)(*args)
        again = getattr(mod, fn)(*args)
        if getattr(mod, counter) != before + 2:
            raise AssertionError(f"{fn} {label}: the kernel did not launch")
        want = getattr(ref, fn)(*args)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"{fn} {label}: two runs differ")
        err = float((got.double() - want.double()).abs())
        if "f32_random" in label:       # another f64 order: within an ulp
            if err > float((torch.nextafter(want, want + 1) - want).abs()):
                raise AssertionError(f"{fn} {label}: more than 1 ulp from "
                                     "plain")
        elif not torch.equal(got, want):
            raise AssertionError(f"{fn} {label}: kernel != plain, "
                                 f"|err| {err}")
        new_err[fn] = max(new_err[fn], err)
        print(f"{fn} {label}: {got.item()} max_abs_err={err} ok", flush=True)
    sel = mods["select_scan"]
    new_err.update(build=0.0, select_scan_sparse=0.0)
    for kind, n_slots in BUILD_SYNTHETIC:
        keys, bvals, s = cases.tensors(cases.build_case(7000 + n_slots,
                                                        n_slots, kind), dev)
        before = hj.BUILD_LAUNCHES
        got = hj.build(keys, bvals, s)
        again = hj.build(keys, bvals, s)
        if hj.BUILD_LAUNCHES != before + 2:
            raise AssertionError(f"build {kind}: the kernel did not launch")
        want = ref.build(keys, bvals, s)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) and torch.equal(g, w)
                   for g, a, w in zip(got, again, want)):
            raise AssertionError(f"build {kind} n={keys.numel()}: kernel "
                                 "!= plain or two runs differ")
        print(f"build {kind}, n={keys.numel()}, slots={s}: used "
              f"{int((got[0] != -(1 << 31)).sum())} ok", flush=True)
    for order in cases.SPARSE_ORDERS:
        for selectivity in SPARSE_SYNTHETIC:
            args = cases.tensors(cases.sparse_case(7100, BIG, selectivity,
                                                   order), dev)
            before = sel.SPARSE_LAUNCHES
            got = sel.select_scan_sparse(*args)
            again = sel.select_scan_sparse(*args)
            if sel.SPARSE_LAUNCHES != before + 2:
                raise AssertionError("select_scan_sparse: the kernel did "
                                     "not launch")
            want = ref.select_scan_sparse(*args)
            dense = sel.select_scan(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) and torch.equal(g, w) and
                       torch.equal(g, d) for g, a, w, d in
                       zip(got, again, want, dense)):
                raise AssertionError(f"select_scan_sparse {order} "
                                     f"{selectivity}: differs from plain, "
                                     "select_scan or its second run")
            print(f"select_scan_sparse {order}, selectivity {selectivity}, "
                  f"n={BIG}: count={int(got[1])} = select_scan ok",
                  flush=True)
    print(f"phase3_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase(f"4 main path: 13 SSB queries, fused, SF {SF}")
    t0 = time.perf_counter()
    db = ssb.generate(sf=SF, seed=SEED)
    print(f"generate_s {time.perf_counter() - t0:.3f} "
          f"lineorder_rows {db.lineorder.n_rows} "
          f"columns {len(db.lineorder.columns)}")
    t0 = time.perf_counter()
    db.to(dev)
    torch.cuda.synchronize()
    print(f"upload_s {time.perf_counter() - t0:.3f} resident_GB "
          f"{db.lineorder.resident_bytes(dev) / 1e9:.3f}", flush=True)
    queries = engine.ssb_queries()
    cache = hashtable.HashTableCache()

    def run_pass(mode="auto", database=db):
        out, launches = {}, {}
        for name, plan in queries.items():
            before = ssb_fused.LAUNCHES
            out[name] = compile_plan(plan, "fused").execute(
                database, mode=mode, cache=cache)
            launches[name] = ssb_fused.LAUNCHES - before
        return out, launches

    ssb_fused.LAUNCHES = 0
    first, launches = run_pass()
    main_launches = ssb_fused.LAUNCHES
    if main_launches != len(queries) or set(launches.values()) != {1}:
        raise AssertionError(f"expected one launch per query, got {launches}")
    ssb_fused.LAUNCHES = 0
    second, _ = run_pass()
    if ssb_fused.LAUNCHES != len(queries):
        raise AssertionError(f"second pass launched {ssb_fused.LAUNCHES}")
    plain, plain_launches = run_pass(mode="ref")
    if set(plain_launches.values()) != {0}:
        raise AssertionError("mode='ref' launched the kernel")
    t0 = time.perf_counter()
    oracle = {name: engine.run_query_oracle(db, plan)
              for name, plan in queries.items()}
    oracle_s = time.perf_counter() - t0
    for name in queries:
        for other, what in ((second[name], "second pass"),
                            (plain[name], "plain version on the card"),
                            (oracle[name], "numpy oracle")):
            if not same_bits(first[name], other):
                diff = np.abs(first[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name}: differs from the {what} "
                                     f"(max |diff| {diff})")
        max_err = max(max_err, float(np.abs(
            first[name].astype(np.float64) - plain[name]).max()))
    print(f"launches_per_pass {main_launches} bit-identical: second pass, "
          f"plain on card, oracle (oracle_s {oracle_s:.3f}) "
          f"cache hits {cache.hits} misses {cache.misses}", flush=True)

    def fused_row(name, plan, database, launched, result):
        """One query's fused times, on this database, beside its bound."""
        times = query_ms(compile_plan(plan, "fused"), database, cache)
        a, k = fused_inputs(plan, database, cache, dev)
        kernel_ms = event_ms(functools.partial(ssb_fused.spja, *a, **k),
                             KERNEL_REPS)
        plain_ms = event_ms(functools.partial(ref.spja, *a, **k),
                            PLAIN_REPS)
        streams = {s.data_ptr(): s for s in [*a[0], *a[2], a[5]] + (
            [a[6]] if a[6] is not None else [])}
        n_cols = len(streams)
        fact_bytes = sum(4 * s.numel() for s in streams.values())
        table_bytes = sum(t.numel() * t.element_size() for t in a[3])
        stream_ms = (fact_bytes + table_bytes + 4 * plan.n_groups) \
            / HBM_BYTES_PER_S * 1e3
        need = must_move(a, **k)
        bound_ms = max(need["bytes_ms"], need["ops_ms"])
        return {"query": name, "n_groups": plan.n_groups,
                **spja_launch_info(ssb_fused, plan, dev),
                "launches": launched,
                "groups_nonzero": int(np.count_nonzero(result)),
                "result_sum": float(result.astype(np.float64).sum()),
                "query_ms": statistics.median(times),
                "query_ms_max": max(times), "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "fact_columns": n_cols,
                "fact_GB": fact_bytes / 1e9, "table_MB": table_bytes / 1e6,
                "GBps": fact_bytes / kernel_ms / 1e6,
                "stream_bound_ms": stream_ms,
                "stream_share": stream_ms / kernel_ms,
                "need_fact_GB": need["fact_bytes"] / 1e9,
                "need_table_MB": need["table_bytes"] / 1e6,
                "need_Gops": need["ops"] / 1e9,
                "bytes_ms": need["bytes_ms"], "ops_ms": need["ops_ms"],
                "bound_ms": bound_ms,
                "bound_by": "bytes" if need["bytes_ms"] >= need["ops_ms"]
                else "operations",
                "bound_share": bound_ms / kernel_ms}

    rows = []
    for name, plan in queries.items():
        rows.append(fused_row(name, plan, db, launches[name], first[name]))
        print(json.dumps(rows[-1]), flush=True)
    totals = ("query_ms", "kernel_ms", "plain_ms", "stream_bound_ms",
              "bytes_ms", "ops_ms", "bound_ms")
    tot = {k: sum(r[k] for r in rows) for k in totals}
    print(f"totals {json.dumps(tot)}")
    print("profile fused " + json.dumps(profiled(run_pass, ("spja",))),
          flush=True)
    print(f"phase4_s {time.perf_counter() - t:.3f}", flush=True)
    kernels = [dict(
        KERNEL, launches=main_launches, max_abs_err=max_err,
        ms=tot["kernel_ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        library_ms=None)]

    t = phase(f"5 second path: 13 SSB queries, opat, SF {SF}")
    kernel_mods = [mods[m] for m, *_ in OPAT]

    def counts():
        return [mod.LAUNCHES for mod in kernel_mods]

    def run_opat(mode="auto", database=db, count=counts):
        out, per = {}, {}
        for name, plan in queries.items():
            before = count()
            out[name] = compile_plan(plan, "opat").execute(
                database, mode=mode, cache=cache)
            per[name] = [a - b for a, b in zip(count(), before)]
        return out, per

    for mod in kernel_mods:
        mod.LAUNCHES = 0
    opat, per_query = run_opat()
    opat_launches = counts()
    for mod in kernel_mods:
        mod.LAUNCHES = 0
    opat_second, _ = run_opat()
    if counts() != opat_launches:
        raise AssertionError(f"second opat pass launched {counts()}, "
                             f"the first {opat_launches}")
    opat_plain, plain_per = run_opat(mode="ref")
    if any(any(v) for v in plain_per.values()):
        raise AssertionError("mode='ref' launched a kernel")
    for name, plan in queries.items():
        shape = [len(plan.filters), len(plan.joins),
                 int(plan.measure_op == "sub"), 1]
        if per_query[name] != shape:
            if opat[name].any() or any(
                    a > b for a, b in zip(per_query[name], shape)):
                raise AssertionError(f"{name}: launches {per_query[name]},"
                                     f" the plan's shape {shape}")
            print(f"{name}: rows ran out, launches {per_query[name]} of "
                  f"{shape}")
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "fused path"),
                            (opat_second[name], "second opat pass"),
                            (opat_plain[name], "plain versions on the card")):
            if not same_bits(opat[name], other):
                diff = np.abs(opat[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} opat: differs from the {what} "
                                     f"(max |diff| {diff})")
    print("launches_per_pass " + " ".join(
        f"{fn}={n}" for (_, fn, *_), n in zip(OPAT, opat_launches)) +
        " bit-identical: oracle, fused, second pass, plain on card",
        flush=True)

    fused_ms = {r["query"]: r["query_ms"] for r in rows}
    opat_ms, opat_rows = {}, []
    for name, plan in queries.items():
        times = query_ms(compile_plan(plan, "opat"), db, cache)
        opat_ms[name] = statistics.median(times)
        row = {"query": name, "launches": per_query[name],
               "opat_query_ms": statistics.median(times),
               "opat_query_ms_max": max(times),
               "fused_query_ms": fused_ms[name],
               "opat_over_fused": statistics.median(times) / fused_ms[name]}
        opat_rows.append(row)
        print(json.dumps(row), flush=True)
    print("totals " + json.dumps({k: sum(r[k] for r in opat_rows) for k in (
        "opat_query_ms", "fused_query_ms")}), flush=True)

    print("profile opat " + json.dumps(profiled(
        run_opat, ("select_scan", "probe_join", "group_sum"))), flush=True)
    ag = mods["agg"]
    for n_pin, g in GROUP_PROFILED:     # a grid of blocks, and one block
        args = cases.tensors(cases.group_case(3302, n_pin, g), dev)
        resident, warps, _ = ag._shape(dev.index, g, True)
        print("group_sum one call " + json.dumps(dict(one_kernel(
            "group_sum", lambda: ag.group_sum(*args)), n=n_pin, n_groups=g,
            blocks=ag.group_grid(n_pin, g, resident, 8), warps=warps)),
            flush=True)
    hj = mods["hash_join"]
    for n_pin in (BIG, 37):
        args = cases.tensors(cases.probe_case(3300, n_pin), dev)
        count = int(hj.probe_join(*args)[2])
        print("one call " + json.dumps(one_call(
            "probe_join", lambda: hj.probe_join(*args), n_pin, count,
            hj.library())), flush=True)
    sel = mods["select_scan"]
    for n_pin in (BIG, 37):
        args = cases.tensors(cases.select_case(3301, n_pin), dev)
        count = int(sel.select_scan(*args)[1])
        print("one call " + json.dumps(one_call(
            "select_scan", lambda: sel.select_scan(*args), n_pin, count,
            sel.library(), columns=1, shape=("select_scan_shape", 32))),
            flush=True)
    n = db.lineorder.n_rows     # the chain's first positions vector, alone
    arange_ms = event_ms(lambda: torch.arange(n, dtype=torch.int32,
                                              device=dev), KERNEL_REPS)
    print(f"arange int32 n={n} ms {arange_ms} "
          f"GBps {4 * n / arange_ms / 1e6}", flush=True)

    with contextlib.ExitStack() as stack:
        timers = {fn: stack.enter_context(Timed(mods[m], fn, getattr(ref, fn)))
                  for m, fn, *_ in OPAT}
        timed, _ = run_opat()
    for name in queries:
        if not same_bits(timed[name], opat[name]):
            raise AssertionError(f"{name}: the timed opat pass differs")
    def kernel_entry(fn, src, replaces, launched, err, calls):
        """The kernels line's entry for one kernel from its timed calls
        (each printed on its own line)."""
        for r in calls:
            print(json.dumps({"call": fn, "n": r["n"], "ms": r["ms"],
                              "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
                              "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"],
                              **{k: r[k] for k in ("turns", "zero_tail_ms")
                                 if k in r}}))
        tot = {k: sum(r[k] for r in calls)
               for k in ("ms", "plain_ms", "bytes", "ops", "bytes_ms",
                         "ops_ms")}
        bound_ms = sum(max(r["bytes_ms"], r["ops_ms"]) for r in calls)
        lib = [r["library_ms"] for r in calls if r["library_ms"] is not None]
        entry = {"name": fn, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}",
                 "replaces": replaces, "launches": launched,
                 "max_abs_err": err, "ms": tot["ms"],
                 "plain_ms": tot["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                 else "operations",
                 "library_ms": sum(lib) if lib else None}
        tail = [r["zero_tail_ms"] for r in calls if "zero_tail_ms" in r]
        print(json.dumps(dict(entry, calls=len(calls), GB=tot["bytes"] / 1e9,
                              Gops=tot["ops"] / 1e9,
                              bound_share=bound_ms / tot["ms"],
                              **({"zero_tail_ms": sum(tail)} if tail
                                 else {}))), flush=True)
        return entry

    for (m, fn, src, replaces), launched in zip(OPAT, opat_launches):
        kernels.append(kernel_entry(fn, src, replaces, launched,
                                    max(opat_err[fn], timers[fn].err),
                                    timers[fn].rows))
    print(f"phase5_s {time.perf_counter() - t:.3f}")

    t = phase(f"6 packed storage: 13 SSB queries, fused and opat, SF {SF}")
    t0 = time.perf_counter()
    pdb = storage.pack_database(db)
    print(f"pack_s {time.perf_counter() - t0:.3f}")
    for col, pc in pdb.lineorder.columns.items():
        e = pc.encoding
        print(f"{col}: {e.kind} width {e.width} phys {e.phys} ref {e.ref}")
    pdb.to(dev)
    torch.cuda.synchronize()
    print(f"resident_GB {pdb.lineorder.resident_bytes(dev) / 1e9:.3f} "
          f"(plain {db.lineorder.resident_bytes(dev) / 1e9:.3f})", flush=True)
    hits, misses = cache.hits, cache.misses

    ssb_fused.LAUNCHES = 0
    pfirst, plaunched = run_pass(database=pdb)
    packed_launches = ssb_fused.LAUNCHES
    if packed_launches != len(queries) or set(plaunched.values()) != {1}:
        raise AssertionError(f"expected one launch per query, got "
                             f"{plaunched}")
    ssb_fused.LAUNCHES = 0
    psecond, _ = run_pass(database=pdb)
    if ssb_fused.LAUNCHES != len(queries):
        raise AssertionError(f"second pass launched {ssb_fused.LAUNCHES}")
    pplain, pl = run_pass(mode="ref", database=pdb)
    if set(pl.values()) != {0}:
        raise AssertionError("mode='ref' launched the kernel")
    for name in queries:
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "plain fused path"),
                            (psecond[name], "second pass"),
                            (pplain[name], "plain version on the card")):
            if not same_bits(pfirst[name], other):
                diff = np.abs(pfirst[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} packed fused: differs from the "
                                     f"{what} (max |diff| {diff})")
        packed_err = max(packed_err, float(np.abs(
            pfirst[name].astype(np.float64) - pplain[name]).max()))

    sel_mod = mods["select_scan"]

    def counts6():
        return [sel_mod.PACKED_LAUNCHES] + counts()

    def reset6():
        sel_mod.PACKED_LAUNCHES = 0
        for mod in kernel_mods:
            mod.LAUNCHES = 0

    reset6()
    popat, pper = run_opat(database=pdb, count=counts6)
    popat_launches = counts6()
    reset6()
    popat_second, _ = run_opat(database=pdb, count=counts6)
    if counts6() != popat_launches:
        raise AssertionError(f"second packed opat pass launched {counts6()}, "
                             f"the first {popat_launches}")
    popat_plain, pp = run_opat(mode="ref", database=pdb, count=counts6)
    if any(any(v) for v in pp.values()):
        raise AssertionError("mode='ref' launched a kernel")
    for name, plan in queries.items():
        lead = int(bool(plan.filters) and isinstance(plan.chain[1], P.Filter))
        shape = [lead, len(plan.filters) - lead, len(plan.joins),
                 int(plan.measure_op == "sub"), 1]
        if pper[name] != shape:
            if popat[name].any() or any(
                    a > b for a, b in zip(pper[name], shape)):
                raise AssertionError(f"{name}: packed opat launches "
                                     f"{pper[name]}, the plan's {shape}")
            print(f"{name}: rows ran out, launches {pper[name]} of {shape}")
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "plain fused path"),
                            (popat_second[name], "second pass"),
                            (popat_plain[name], "plain versions on the card")):
            if not same_bits(popat[name], other):
                diff = np.abs(popat[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} packed opat: differs from the "
                                     f"{what} (max |diff| {diff})")
    if cache.misses != misses:
        raise AssertionError(f"{cache.misses - misses} hash-table builds "
                             "missed the cache warmed on the plain database")
    print(f"launches_per_pass spja={packed_launches} " + " ".join(
        f"{fn}={n}" for fn, n in zip(
            ["select_scan_packed"] + [fn for _, fn, *_ in OPAT],
            popat_launches)) +
        " bit-identical: oracle, plain fused, second pass, plain on card; "
        f"cache hits {cache.hits - hits} misses {cache.misses - misses}",
        flush=True)

    prows = []
    for (name, plan), plain_row in zip(queries.items(), rows):
        row = fused_row(name, plan, pdb, plaunched[name], pfirst[name])
        times = query_ms(compile_plan(plan, "opat"), pdb, cache)
        row.update({"opat_launches": pper[name],
                    "opat_query_ms": statistics.median(times),
                    "plain_kernel_ms": plain_row["kernel_ms"],
                    "plain_query_ms": plain_row["query_ms"],
                    "plain_bound_ms": plain_row["bound_ms"],
                    "plain_need_fact_GB": plain_row["need_fact_GB"]})
        prows.append(row)
        print(json.dumps(row), flush=True)
    ptot = {k: sum(r[k] for r in prows)
            for k in totals + ("opat_query_ms", "plain_kernel_ms",
                               "plain_query_ms", "plain_bound_ms")}
    print(f"totals {json.dumps(ptot)}", flush=True)
    kernels[0]["packed"] = {
        "launches": packed_launches, "max_abs_err": packed_err,
        "ms": ptot["kernel_ms"], "plain_ms": ptot["plain_ms"],
        "bound_ms": ptot["bound_ms"],
        "bound_by": "bytes" if ptot["bytes_ms"] >= ptot["ops_ms"]
        else "operations"}

    (m, fn, _, src, replaces), (um, ufn, _, usrc, ureplaces) = PACKED
    with Timed(mods[m], fn, getattr(ref, fn)) as timer:
        timed, _ = run_opat(database=pdb, count=counts6)
    for name in queries:
        if not same_bits(timed[name], popat[name]):
            raise AssertionError(f"{name}: the timed packed opat pass "
                                 "differs")
    kernels.append(kernel_entry(fn, src, replaces, popat_launches[0],
                                max(opat_err[fn], timer.err), timer.rows))
    pargs = cases.tensors(cases.select_packed_case(3302, BIG, 4), dev)
    count = int(sel_mod.select_scan_packed(*pargs)[1])
    print("one call " + json.dumps(one_call(
        fn, lambda: sel_mod.select_scan_packed(*pargs), BIG, count,
        sel_mod.library(), columns=1, shape=("select_scan_shape", 4))),
        flush=True)

    unp = mods[um]
    packed_cols = [(col, pc.encoding)
                   for col, pc in pdb.lineorder.columns.items()
                   if pc.encoding.kind != "plain"]
    unp.LAUNCHES = 0
    for col, e in packed_cols:
        words = pdb.lineorder.on_device(col, dev)
        got = unp.unpack(words, e.n_rows, e.phys, e.ref)
        for other, what in ((ref.unpack(words, e.n_rows, e.phys, e.ref),
                             "plain version"),
                            (db.lineorder.on_device(col, dev),
                             "resident plain column")):
            if not torch.equal(got, other):
                raise AssertionError(f"unpack {col}: differs from the {what}")
    unpack_launches = unp.LAUNCHES
    if unpack_launches != len(packed_cols):
        raise AssertionError(f"unpack launched {unpack_launches} times for "
                             f"{len(packed_cols)} columns")
    print(f"unpack: {unpack_launches} packed columns bit-identical to the "
          "plain version and the resident plain column", flush=True)
    calls = []
    for col, e in packed_cols:
        a = (pdb.lineorder.on_device(col, dev), e.n_rows, e.phys, e.ref)
        out = unp.unpack(*a)
        calls.append(dict(opat_need(ufn, a, out), n=e.n_rows,
                          ms=event_ms(functools.partial(unp.unpack, *a),
                                      KERNEL_REPS),
                          plain_ms=event_ms(functools.partial(ref.unpack, *a),
                                            1),
                          library_ms=None))
    kernels.append(kernel_entry(ufn, usrc, ureplaces, unpack_launches,
                                opat_err[ufn], calls))
    print(f"phase6_s {time.perf_counter() - t:.3f}")

    t = phase(f"7 partitioned join: 13 SSB queries, part and part_loop, "
              f"SF {SF}; the Fig. 8 analogue")
    hj = mods["hash_join"]

    def counts7():
        return [radix.HIST_LAUNCHES, radix.SCATTER_LAUNCHES, pprobe.LAUNCHES,
                hj.LAUNCHES]

    def reset7():
        radix.HIST_LAUNCHES = radix.SCATTER_LAUNCHES = pprobe.LAUNCHES = \
            hj.LAUNCHES = 0

    def run_part(strategy, mode="auto", database=db, seen=None):
        """The 13 queries through one partitioned strategy -> (results,
        launches per query, non-empty partitions per query)."""
        out, per, probes = {}, {}, {}
        for name, plan in queries.items():
            before, k = counts7(), len(seen) if seen is not None else 0
            out[name] = compile_plan(plan, strategy).execute(
                database, mode=mode, cache=cache)
            per[name] = [a - b for a, b in zip(counts7(), before)]
            probes[name] = sum(seen[k:]) if seen is not None else None
        return out, per, probes

    part_launches, part_per = {}, {}
    hits, misses = cache.hits, cache.misses
    radix.COUNT_LAUNCHES = 0
    for label, database in (("plain", db), ("packed", pdb)):
        for strategy in ("part", "part_loop"):
            reset7()
            with nonempty_partitions(radix) as seen:
                res, per, probes = run_part(strategy, database=database,
                                            seen=seen)
            launched = counts7()
            reset7()
            second, _, _ = run_part(strategy, database=database)
            if counts7() != launched:
                raise AssertionError(f"{label} {strategy}: second pass "
                                     f"launched {counts7()}, the first "
                                     f"{launched}")
            plain_res, pp, _ = run_part(strategy, mode="ref",
                                        database=database)
            if any(any(v) for v in pp.values()):
                raise AssertionError("mode='ref' launched a kernel")
            for name, plan in queries.items():
                j = len(plan.joins)
                shape = [j, j, j, 0] if strategy == "part" else \
                    [j, j, 0, probes[name]]
                if per[name] != shape:
                    if res[name].any() or any(
                            a > b for a, b in zip(per[name], shape)):
                        raise AssertionError(
                            f"{name} {label} {strategy}: launches "
                            f"{per[name]}, the plan's {shape}")
                    print(f"{name} {label} {strategy}: rows ran out, "
                          f"launches {per[name]} of {shape}")
                for other, what in ((oracle[name], "numpy oracle"),
                                    (second[name], "second pass"),
                                    (plain_res[name],
                                     "plain versions on the card")):
                    if not same_bits(res[name], other):
                        diff = np.abs(res[name].astype(np.float64)
                                      - other).max()
                        raise AssertionError(
                            f"{name} {label} {strategy}: differs from the "
                            f"{what} (max |diff| {diff})")
            part_launches[label, strategy] = launched
            part_per[label, strategy] = per
            print(f"{label} {strategy}: launches histogram={launched[0]} "
                  f"partition_multi={launched[1]} part_probe={launched[2]} "
                  f"probe_join={launched[3]} bit-identical: oracle, second "
                  "pass, plain on card", flush=True)
    if radix.COUNT_LAUNCHES:
        raise AssertionError(f"the partitioned join launched the digit "
                             f"counts {radix.COUNT_LAUNCHES} times: its "
                             "pass takes its histogram's column sums")
    print(f"cache hits {cache.hits - hits} misses {cache.misses - misses}",
          flush=True)

    part_rows = []
    for name, plan in queries.items():
        bits = [M.part_bits(cache.get_build_count(db, j))
                for j in plan.joins]
        row = {"query": name, "part_bits": bits,
               "probe_whole": [mean_probe(cache.get_or_build(db, j, dev)[0])
                               for j in plan.joins],
               "probe_part": [mean_probe(cache.get_or_build_parts(
                   db, j, b, packed=True, device=dev).htk)
                   for j, b in zip(plan.joins, bits)],
               "fused_query_ms": fused_ms[name],
               "opat_query_ms": opat_ms[name]}
        for label, database in (("plain", db), ("packed", pdb)):
            for strategy in ("part", "part_loop"):
                times = query_ms(compile_plan(plan, strategy), database,
                                 cache)
                key = strategy if label == "plain" else f"{strategy}_packed"
                row[f"{key}_query_ms"] = statistics.median(times)
                row[f"{key}_launches"] = part_per[label, strategy][name]
        part_rows.append(row)
        print(json.dumps(row), flush=True)
    print("totals " + json.dumps({k: sum(r[k] for r in part_rows) for k in (
        "fused_query_ms", "opat_query_ms", "part_query_ms",
        "part_loop_query_ms", "part_packed_query_ms",
        "part_loop_packed_query_ms")}), flush=True)

    plains = {"histogram": ref.histogram,
              "partition_multi": lambda keys, vals, start_bit, r, hist=None:
              ref.partition_multi(keys, vals, start_bit, r),
              "part_probe": ref.part_probe}
    with contextlib.ExitStack() as stack:
        timers = {fn: stack.enter_context(Timed(mods[m], fn, plains[fn]))
                  for m, fn, *_ in PARTITIONED}
        timed, _, _ = run_part("part")
    for name in queries:
        if not same_bits(timed[name], oracle[name]):
            raise AssertionError(f"{name}: the timed part pass differs")
    loop_launches = part_launches["plain", "part_loop"]
    for i, (m, fn, _, src, replaces) in enumerate(PARTITIONED):
        kernels.append(dict(
            kernel_entry(fn, src, replaces, part_launches["plain", "part"][i],
                         max(part_err[fn], timers[fn].err), timers[fn].rows),
            launches_part_loop=loop_launches[i] if i < 2 else 0))
    args = cases.tensors(cases.part_probe_case(3300, PART_N, 4), dev)
    count = int(pprobe.part_probe(*args)[2])
    print("one call " + json.dumps(one_call(
        "part_probe", lambda: pprobe.part_probe(*args), PART_N, count,
        pprobe.library())), flush=True)

    # part_loop's probe_join calls, one per non-empty partition, timed
    # as the opat pass's are
    with Timed(mods["hash_join"], "probe_join", ref.probe_join) as loop:
        timed, _, _ = run_part("part_loop")
    for name in queries:
        if not same_bits(timed[name], oracle[name]):
            raise AssertionError(f"{name}: the timed part_loop pass differs")
    calls = loop.rows
    small = [r["ms"] for r in calls if r["n"] < SMALL_ROWS]
    loop_row = {"calls": len(calls), "ms": sum(r["ms"] for r in calls),
                "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"])
                                for r in calls),
                "zero_tail_ms": sum(r["zero_tail_ms"] for r in calls),
                "plain_ms": sum(r["plain_ms"] for r in calls),
                "small_calls": len(small), "small_ms": sum(small),
                "largest_ms": max((r["ms"] for r in calls), default=0.0)}
    print("part_loop probe_join " + json.dumps(loop_row), flush=True)
    entry = next(k for k in kernels if k["name"] == "probe_join")
    entry.update(launches_part_loop=loop_launches[3],
                 part_loop_ms=loop_row["ms"],
                 part_loop_bound_ms=loop_row["bound_ms"])
    entry["max_abs_err"] = max(entry["max_abs_err"], loop.err)

    fig8_plan = (engine.QueryBuilder("fig8").scan("lineorder")
                 .hash_join("lo_partkey", "part", "p_partkey",
                            payload=P.ColExpr("p_group"), mult=1)
                 .measure("lo_revenue").group_by(64).build())
    rng = np.random.default_rng(SEED)
    revenue = rng.integers(1, 1000, FIG8_FACT, dtype=np.int32)
    for n_dim in FIG8_DIMS:
        t0 = time.perf_counter()
        fdb = fig8_db(ssb, rng, n_dim, revenue).to(dev)
        fcache = hashtable.HashTableCache()
        want = engine.run_query_oracle(fdb, fig8_plan)
        row = {"n_fact": FIG8_FACT, "n_dim": n_dim,
               "table_MB": M.ht_bytes(n_dim) / 1e6,
               "part_bits": M.part_bits(n_dim),
               "setup_s": time.perf_counter() - t0}
        for strategy in STRATEGIES:
            if strategy == "part_loop" and n_dim not in FIG8_LOOP_DIMS:
                continue
            q = compile_plan(fig8_plan, strategy)
            t0 = time.perf_counter()
            got = q.execute(fdb, cache=fcache)      # builds its tables
            row[f"{strategy}_first_s"] = time.perf_counter() - t0
            if not same_bits(got, want):
                raise AssertionError(f"fig8 n_dim={n_dim} {strategy}: "
                                     "differs from the numpy oracle")
            before = counts7()
            times = query_ms(q, fdb, fcache)
            row[f"{strategy}_query_ms"] = statistics.median(times)
            row[f"{strategy}_launches"] = [
                (a - b) // QUERY_REPS for a, b in zip(counts7(), before)]
        join = fig8_plan.joins[0]
        row["probe_whole"] = mean_probe(fcache.get_or_build(fdb, join,
                                                            dev)[0])
        row["probe_part"] = mean_probe(fcache.get_or_build_parts(
            fdb, join, row["part_bits"], packed=True, device=dev).htk)
        print("fig8 " + json.dumps(row), flush=True)
        del fdb, fcache
        torch.cuda.empty_cache()
    print(f"phase7_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase(f"8 ORDER BY: LSB radix sort, SF {SF}")
    lo = db.lineorder
    n = lo.n_rows
    passes = radix.sort_passes(32, SORT_BITS)

    def counts8():
        return [sel.LAUNCHES, hj.LAUNCHES, radix.HIST_LAUNCHES,
                radix.COUNT_LAUNCHES, radix.SCATTER_LAUNCHES]

    def plan_of(keys: np.ndarray) -> list:
        """The passes radix_sort must launch on these keys: the plan of
        the plain digit counts (on the card)."""
        return radix.pass_plan(ref.digit_counts(
            torch.from_numpy(keys).to(dev), 0, SORT_BITS, passes).cpu(),
            keys.shape[0])

    sel = mods["select_scan"]
    date_plan = plan_of(lo["lo_orderdate"])
    radix.HIST_LAUNCHES = radix.COUNT_LAUNCHES = radix.SCATTER_LAUNCHES = 0
    t0 = time.perf_counter()
    ordered = engine.order_by(lo, "lo_orderdate")
    order_by_s = time.perf_counter() - t0
    ob_launches = [radix.HIST_LAUNCHES, radix.COUNT_LAUNCHES,
                   radix.SCATTER_LAUNCHES]
    if ob_launches != [0, 1, len(date_plan)]:
        raise AssertionError(f"order_by launched {ob_launches} (histogram, "
                             f"digit counts, passes), expected 0, 1 and "
                             f"the passes {date_plan} of {passes}")
    perm = np.argsort(lo["lo_orderdate"], kind="stable")
    for c in lo.columns:
        if not np.array_equal(ordered[c], lo[c][perm]):
            raise AssertionError(f"order_by: column {c} is not in numpy's "
                                 "stable argsort order")
    print(f"order_by lineorder by lo_orderdate: {lo.n_rows} rows, "
          f"launches histogram={ob_launches[0]} "
          f"digit_counts={ob_launches[1]} partition_multi={ob_launches[2]}"
          f" (passes run {date_plan}, skipped "
          f"{sorted(set(range(passes)) - set(date_plan))}), order_by_s "
          f"{order_by_s:.3f}, equal to numpy's stable argsort", flush=True)

    row_plan = (engine.QueryBuilder("ordered").scan("lineorder")
                .where_range("lo_discount", 1, 3)
                .hash_join("lo_orderdate", "date", "d_datekey",
                           dim_filter=P.EqPred("d_year", 1993))
                .order_by("lo_revenue").build())
    disc = lo["lo_discount"]
    year = db.date["d_datekey"][db.date["d_year"] == 1993]
    survivors = np.flatnonzero((disc >= 1) & (disc <= 3) &
                               np.isin(lo["lo_orderdate"], year))
    revenue_plan = plan_of(lo["lo_revenue"][survivors])
    before = counts8()
    got = compile_plan(row_plan, "opat").execute(db, cache=cache)
    row_launches = [a - b for a, b in zip(counts8(), before)]
    if row_launches != [1, 1, 0, 1, len(revenue_plan)]:
        raise AssertionError(f"row plan launched {row_launches}, expected "
                             f"[1, 1, 0, 1, {len(revenue_plan)}]")
    want = survivors[np.argsort(lo["lo_revenue"][survivors], kind="stable")]
    for other, what in ((want, "numpy's stable argsort"),
                        (compile_plan(row_plan, "opat").execute(
                            db, cache=cache), "second pass"),
                        (compile_plan(row_plan, "opat").execute(
                            db, mode="ref", cache=cache),
                         "plain versions on the card")):
        if not np.array_equal(got, other):
            raise AssertionError(f"row plan: differs from the {what}")
    print(f"row plan filter + join + OrderBy(lo_revenue): {len(got)} rows, "
          f"launches select_scan/probe_join/histogram/digit_counts/"
          f"partition_multi {row_launches} (passes run {revenue_plan}), "
          "equal to numpy's stable argsort, a second pass and the plain "
          "versions on the card", flush=True)

    # radix_sort of 120 M keys + int32 row ids: SSB's dates (two passes
    # skipped) and uniform random 32-bit keys (none skipped), in turns
    # with torch.sort; the design moves 4n bytes for the digit counts and
    # 16n a pass, the function itself 16n (its bound)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sort_keys = {"lo_orderdate": lo.on_device("lo_orderdate", dev),
                 "random32": torch.randint(-(1 << 31), 1 << 31, (n,),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)}
    sort_rows = {}
    for name, keys in sort_keys.items():
        counts = radix.digit_counts(keys, 0, SORT_BITS, passes)
        plan = radix.pass_plan(counts.cpu(), n)
        got = radix.radix_sort(keys, vals)
        order = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF,
                           stable=True).indices.to(torch.int32)
        if not (torch.equal(got[1], order) and
                torch.equal(got[0], keys[order])):
            raise AssertionError(f"radix_sort {name}: not a stable sort by "
                                 "the keys as unsigned words")
        del got, order
        row = {"n": n, "passes": passes, "passes_run": plan,
               "turns": turns(lambda: radix.radix_sort(keys, vals),
                              lambda: torch.sort(keys, stable=True),
                              calls=1),
               "plain_ms": event_ms(lambda: ref.radix_sort(keys, vals), 1),
               "counts_ms": event_ms(lambda: radix.digit_counts(
                   keys, 0, SORT_BITS, passes), KERNEL_REPS),
               "pass_ms": event_ms(lambda: radix.sweep(
                   keys, (vals,), 0, SORT_BITS, counts[0]), KERNEL_REPS),
               "bound_ms": 16 * n / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "design_bytes": 4 * n + 16 * n * len(plan)}
        row["ms"] = row["turns"]["kernel_median"]
        row["library_ms"] = row["turns"]["library_median"]
        row["design_GBps"] = row["design_bytes"] / row["ms"] / 1e6
        row["bound_share"] = row["bound_ms"] / row["ms"]
        sort_rows[name] = row
        print(f"radix_sort {name} " + json.dumps(row), flush=True)
    counts_row = {"n": n, "passes": passes,
                  "ms": sort_rows["lo_orderdate"]["counts_ms"],
                  "plain_ms": event_ms(lambda: ref.digit_counts(
                      sort_keys["lo_orderdate"], 0, SORT_BITS, passes), 1),
                  "bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3}
    del sort_keys, vals
    kernels.append({
        "name": "digit_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/radix_part.cu",
        "replaces": "src/repro/kernels/radix_part.py:111",
        "launches": ob_launches[1],
        "max_abs_err": part_err["digit_counts"], "ms": counts_row["ms"],
        "plain_ms": counts_row["plain_ms"],
        "bound_ms": counts_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    for entry, launched in zip(kernels[-4:-2], ob_launches[::2]):
        entry["launches_order_by"] = launched
    kernels[-3]["radix_sort"] = {
        k: {x: sort_rows[k][x] for x in ("ms", "library_ms", "plain_ms",
                                         "bound_ms", "passes_run")}
        for k in sort_rows}
    print(f"phase8_s {time.perf_counter() - t:.3f}")

    t = phase(f"9 shared waves: the 13 queries, flight 1, flight 2, "
              f"flights 2 + 4; "
              f"plain and packed, SF {SF}")
    waves = {w: [queries[q] for q in (names or queries)]
             for w, names in WAVES.items()}
    pads = {w: 16 if w == "all13" else None for w in waves}
    solo = {"plain": first, "packed": pfirst}
    solo_ms = {"plain": {r["query"]: r["query_ms"] for r in rows},
               "packed": {r["query"]: r["query_ms"] for r in prows}}
    wcache = hashtable.HashTableCache()
    databases = (("plain", db), ("packed", pdb))

    def run_waves(mode="auto"):
        return {(label, w): TC.execute_shared(
                    plans, database, mode=mode, cache=wcache, pad_to=pads[w])
                for label, database in databases
                for w, plans in waves.items()}

    mf.LAUNCHES = 0
    wave_out, per_wave = {}, {}
    for label, database in databases:
        for w, plans in waves.items():
            before = mf.LAUNCHES
            wave_out[label, w] = TC.execute_shared(
                plans, database, cache=wcache, pad_to=pads[w])
            per_wave[label, w] = mf.LAUNCHES - before
        if label == "plain":
            distinct = len({TC.shared_join_key(j) for p in queries.values()
                            for j in p.joins})
            if wcache.misses != distinct:
                raise AssertionError(f"{wcache.misses} builds for "
                                     f"{distinct} distinct build sides")
    single, single_launches = {}, {}
    for name in SINGLES:
        before = mf.LAUNCHES
        single[name] = compile_plan(queries[name], "shared").execute(
            db, cache=wcache)
        single_launches[name] = mf.LAUNCHES - before
    shared_launches = mf.LAUNCHES
    if set(per_wave.values()) != {1} or \
            set(single_launches.values()) != {1}:
        raise AssertionError(f"expected one launch a wave: {per_wave}, "
                             f"compile_plan {single_launches}")
    if wcache.misses != distinct:
        raise AssertionError(f"the packed waves built "
                             f"{wcache.misses - distinct} tables")
    mf.LAUNCHES = 0
    wave_again = run_waves()
    wave_plain = run_waves(mode="ref")
    if mf.LAUNCHES != len(wave_out):
        raise AssertionError(f"second pass launched {mf.LAUNCHES}")
    for (label, w), outs in wave_out.items():
        for plan, got, again, plain_got in zip(
                waves[w], outs, wave_again[label, w], wave_plain[label, w]):
            for other, what in ((oracle[plan.name], "numpy oracle"),
                                (first[plan.name], "fused path"),
                                (solo[label][plan.name], f"{label} fused"),
                                (again, "second pass"),
                                (plain_got, "plain version on the card")):
                if not same_bits(got, other):
                    raise AssertionError(f"{label} {w} {plan.name}: differs "
                                         f"from the {what}")
    for name, got in single.items():
        if not same_bits(got, first[name]):
            raise AssertionError(f"compile_plan({name}, 'shared') differs")
    print(f"launches {shared_launches}: one a wave ({len(wave_out)}) and "
          f"one for compile_plan(q, 'shared') of each of {SINGLES}; "
          f"cache misses "
          f"{wcache.misses} = distinct build sides {distinct}, hits "
          f"{wcache.hits}; bit-identical: oracle, fused, second pass, "
          "plain on card", flush=True)

    wave_rows, main_wave = [], None
    for label, database in databases:
        for w, plans in waves.items():
            _, a, k, n_groups = TC.shared_params(
                plans, database, cache=wcache, pad_to=pads[w])
            call = functools.partial(mf.multi_spja, *a, n_groups=n_groups,
                                     **k)
            times = []
            for _ in range(QUERY_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                TC.execute_shared(plans, database, cache=wcache,
                                  pad_to=pads[w])
                times.append((time.perf_counter() - t0) * 1e3)
            need = wave_need(a, n_groups, **k)
            bound_ms = max(need["bytes_ms"], need["ops_ms"])
            row = {"wave": w, "database": label, "members": len(plans),
                   "Q": len(a[6]), "columns": len({s.data_ptr() for s in (
                       *a[0], *a[2], *a[7])}),
                   "probe_streams": len(a[2]), "n_groups": n_groups,
                   "launches": per_wave[label, w],
                   "query_ms": statistics.median(times),
                   "query_ms_max": max(times),
                   "solo_fused_query_ms": sum(solo_ms[label][p.name]
                                              for p in plans),
                   "kernel_ms": event_ms(call, KERNEL_REPS),
                   "need_fact_GB": need["fact_bytes"] / 1e9,
                   "need_table_MB": need["table_bytes"] / 1e6,
                   "need_Gops": need["ops"] / 1e9,
                   "probe_Gsteps": need["steps"] / 1e9,
                   "bytes_ms": need["bytes_ms"], "ops_ms": need["ops_ms"],
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if need["bytes_ms"] >= need["ops_ms"]
                   else "operations"}
            row["bound_share"] = bound_ms / row["kernel_ms"]
            row["Gsteps_per_s"] = need["steps"] / row["kernel_ms"] / 1e6
            row["solo_over_wave"] = row["solo_fused_query_ms"] / \
                row["query_ms"]
            # the kernel's share of the host's wall time (CUDA events
            # over host clock)
            row["kernel_share"] = row["kernel_ms"] / row["query_ms"]
            row["smem_bytes"] = mf.block_smem(*a, n_groups=n_groups, **k)
            row["blocks_per_sm"] = mf.blocks_per_sm(row["smem_bytes"], dev)
            row["probe_groups"] = [len(g) for g, _ in k["probe_groups"]]
            if label == "plain":
                n_fact = database.lineorder.n_rows
                # modelled on the host from the lowering, not counted on
                # the card
                row["model_probes_per_row"] = wave_probes(
                    a, n_groups, **k) / n_fact
                row["model_stream_probes_per_row"] = wave_probes(
                    a, n_groups, **{x: v for x, v in k.items()
                                    if x != "probe_groups"}) / n_fact
            if (label, w) == ("plain", "all13"):
                row["plain_ms"] = event_ms(functools.partial(
                    ref.multi_spja, *a, n_groups=n_groups,
                    **{x: v for x, v in k.items() if x != "member_groups"}), 1)
                main_wave = row
            wave_rows.append(row)
            print("wave " + json.dumps(row), flush=True)
    print("profile wave " + json.dumps(profiled(lambda: TC.execute_shared(
        waves["all13"], db, cache=wcache, pad_to=pads["all13"]),
        ("multi_spja",))), flush=True)
    kernels.append({
        "name": "multi_fused.multi_spja", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/multi_fused.cu",
        "replaces": SHARED[0][4], "launches": shared_launches,
        "max_abs_err": new_err["multi_spja"], "ms": main_wave["kernel_ms"],
        "plain_ms": main_wave["plain_ms"], "bound_ms": main_wave["bound_ms"],
        "bound_by": main_wave["bound_by"], "library_ms": None})
    print(f"phase9_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase(f"10 join microbenchmark: probe_agg of {JOIN_ROWS} rows "
              f"against 8 KB .. 256 MB tables; reduce_sum of {SUM_ROWS} "
              "rows")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    base = torch.randint(0, 1 << 30, (JOIN_ROWS,), generator=gen,
                         device=dev, dtype=torch.int32)
    vals = torch.randint(0, 100, (JOIN_ROWS,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals_sum = int(vals.cpu().numpy().astype(np.int64).sum())
    hj.AGG_LAUNCHES = ag.SUM_LAUNCHES = 0

    def wrap32(v: int) -> int:
        return (v + (1 << 31)) % (1 << 32) - (1 << 31)

    tables, np_build_ms = [], {}
    for kb in JOIN_TABLE_KB:            # cases.join_bench_table, timed
        bkeys, n_slots = cases.join_bench_keys(SEED, kb * 1024)
        t0 = time.perf_counter()
        htk, htv = hashtable.np_build(bkeys, bkeys, n_slots)
        np_build_ms[kb] = (time.perf_counter() - t0) * 1e3
        tables.append((kb, htk, htv, len(bkeys)))
    sum_inputs = (vals, vals.to(torch.float32))
    for kb, htk, htv, n_build in tables:     # the main run, checked
        htk, htv = (torch.from_numpy(x).to(dev) for x in (htk, htv))
        keys = torch.remainder(base, n_build)
        got = hj.probe_agg(keys, vals, htk, htv)
        want = ref.probe_agg(keys, vals, htk, htv)
        # numpy: every key is in the table with payload = key
        exact = wrap32(int(keys.cpu().numpy().astype(np.int64).sum())
                       + vals_sum)
        if not torch.equal(got, want) or int(got) != exact:
            raise AssertionError(f"probe_agg {kb} KB: {int(got)}, plain "
                                 f"{int(want)}, numpy {exact}")
        del keys, want
    for x in sum_inputs:
        got = ag.reduce_sum(x)
        want = ref.reduce_sum(x)
        host = x.cpu().numpy()
        exact = (np.float32(host.astype(np.float64).sum())
                 if x.is_floating_point()
                 else wrap32(int(host.astype(np.int64).sum())))
        if not torch.equal(got, want) or got.item() != exact:
            raise AssertionError(f"reduce_sum {x.dtype}: {got.item()}, "
                                 f"plain {want.item()}, numpy {exact}")
    bench_launches = {"probe_agg": hj.AGG_LAUNCHES,
                      "reduce_sum": ag.SUM_LAUNCHES}
    if bench_launches != {"probe_agg": len(tables),
                          "reduce_sum": len(sum_inputs)}:
        raise AssertionError(f"launches {bench_launches}")
    print(f"launches probe_agg={hj.AGG_LAUNCHES} "
          f"reduce_sum={ag.SUM_LAUNCHES}: each result bit-identical to its "
          "plain version on the card and to numpy", flush=True)

    join_calls = []
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    for kb, htk, htv, n_build in tables:
        htk, htv = (torch.from_numpy(x).to(dev) for x in (htk, htv))
        keys = torch.remainder(base, n_build)
        need = agg_need(keys, htk, l2_bytes)
        row = {"table_KB": kb, "table_MB": (htk.numel() * 8) / 1e6,
               "n_build": n_build, "rows": JOIN_ROWS,
               "mean_probe": mean_probe(htk),
               "ms": event_ms(lambda: hj.probe_agg(keys, vals, htk, htv),
                              KERNEL_REPS),
               "plain_ms": event_ms(lambda: ref.probe_agg(keys, vals, htk,
                                                          htv), 1),
               "l2_bytes": l2_bytes, **need, "library_ms": None}
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["Gprobes_per_s"] = JOIN_ROWS / row["ms"] / 1e6
        join_calls.append(row)
        print("probe_agg " + json.dumps(row), flush=True)
        if kb == JOIN_TABLE_KB[-1]:
            # one call is its kernels and nothing else: the copy as 8-byte
            # slots, the sweep and the partials' sum
            prof = profiled(lambda: hj.probe_agg(keys, vals, htk, htv),
                            ("probe_agg",))
            print("probe_agg one call " + json.dumps(
                {k: prof[k] for k in ("device_ms", "kernels")}), flush=True)
        del keys, htk, htv
    sum_calls = []
    for x in sum_inputs:
        moved = 4 * x.numel()
        rate = F32_OPS_PER_S if x.is_floating_point() else INT32_OPS_PER_S
        row = {"dtype": str(x.dtype).replace("torch.", ""),
               "rows": x.numel(), "sum": ag.reduce_sum(x).item(),
               "ms": event_ms(lambda: ag.reduce_sum(x), KERNEL_REPS),
               "plain_ms": event_ms(lambda: ref.reduce_sum(x), 1),
               "library_ms": event_ms(lambda: torch.sum(x), KERNEL_REPS),
               "bytes": moved, "ops": x.numel(),
               "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
               "ops_ms": x.numel() / rate * 1e3}
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["GBps"] = moved / row["ms"] / 1e6
        sum_calls.append(row)
        print("reduce_sum " + json.dumps(row), flush=True)
    # one call is one kernel and at most one memset (its ticket), and each
    # profile taken counted one launch
    before = ag.SUM_LAUNCHES
    prof = profiled(lambda: ag.reduce_sum(sum_inputs[1]), ("reduce_sum",))
    launched = {kind: sum(c for _, c, _ in rows)
                for kind, rows in prof["kernels"].items()}
    tries = len(prof["lost"]) + 1
    if launched.get("reduce_sum") != 1 or launched.get("memset", 0) > 1 or \
            set(launched) - {"reduce_sum", "memset"} or \
            ag.SUM_LAUNCHES - before != tries:
        raise AssertionError(f"reduce_sum: one call launched {launched}, "
                             f"counted {ag.SUM_LAUNCHES - before} in "
                             f"{tries} profiles")
    print("reduce_sum one call " + json.dumps(
        {k: prof[k] for k in ("device_ms", "kernels")}), flush=True)
    for (m, fn, _, src, replaces), calls in zip(
            JOIN_BENCH, (join_calls, sum_calls)):
        lib = [r["library_ms"] for r in calls if r["library_ms"] is not None]
        tot = {x: sum(r[x] for r in calls)
               for x in ("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")}
        kernels.append({
            "name": f"{m}.{fn}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": bench_launches[fn],
            "max_abs_err": new_err[fn], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations", "library_ms": sum(lib) if lib else None})

    # the hash build of the same tables, from their keys (the main run,
    # checked, then timed); the payloads equal the keys, as the host
    # build's, but lie in an array of their own, so that the build reads
    # both inputs, as its bound counts
    hj.BUILD_LAUNCHES = 0
    for kb, htk, htv, n_build in tables:
        bkeys, n_slots = cases.join_bench_keys(SEED, kb * 1024)
        bkeys = torch.from_numpy(bkeys).to(dev)
        bvals = bkeys.clone()
        got = hj.build(bkeys, bvals, n_slots)
        want = ref.build(bkeys, bvals, n_slots)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"build {kb} KB: kernel != plain")
        keys = torch.remainder(base, n_build)
        sums = [int(hj.probe_agg(keys, vals, *tab)) for tab in
                (got, want, tuple(torch.from_numpy(x).to(dev)
                                  for x in (htk, htv)))]
        if len(set(sums)) != 1:
            raise AssertionError(f"build {kb} KB: probe_agg sums {sums} "
                                 "(kernel's, plain's, host build's table)")
        del keys, got, want
    last_launches = {"build": hj.BUILD_LAUNCHES}
    if last_launches["build"] != len(tables):
        raise AssertionError(f"build launches {last_launches}")
    print(f"launches build={hj.BUILD_LAUNCHES}: each table byte-identical "
          "to its plain version, probe_agg sums equal to the host build's",
          flush=True)
    # one call of the largest table: one kernel and its flag's read
    bkeys, n_slots = cases.join_bench_keys(SEED, JOIN_TABLE_KB[-1] * 1024)
    bkeys = torch.from_numpy(bkeys).to(dev)
    bvals = bkeys.clone()
    print("build one call " + json.dumps(one_kernel(
        "build", lambda: hj.build(bkeys, bvals, n_slots),
        also=("copy to host",))), flush=True)
    build_calls = []
    for kb, _, _, n_build in tables:
        bkeys, n_slots = cases.join_bench_keys(SEED, kb * 1024)
        bkeys = torch.from_numpy(bkeys).to(dev)
        bvals = bkeys.clone()
        # keys and payloads read once, the (S,) key and payload slots
        # written once
        moved = 8 * n_build + 8 * n_slots
        row = {"table_KB": kb, "n_build": n_build, "n_slots": n_slots,
               "ms": event_ms(lambda: hj.build(bkeys, bvals, n_slots),
                              KERNEL_REPS),
               "plain_ms": event_ms(lambda: ref.build(bkeys, bvals, n_slots),
                                    1),
               "np_build_ms": np_build_ms[kb], "bytes": moved, "ops": 0,
               "bytes_ms": moved / HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0,
               "library_ms": None}
        row["bound_ms"] = row["bytes_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        build_calls.append(row)
        print("build " + json.dumps(row), flush=True)

    # the selective load: x read alone, y only in tiles holding a match
    x_uniform = torch.randint(0, 1 << 30, (SPARSE_ROWS,), generator=gen,
                              device=dev, dtype=torch.int32)
    xs = {"uniform": x_uniform, "sorted": torch.sort(x_uniform).values}
    y = base[:SPARSE_ROWS]
    sel.SPARSE_LAUNCHES = 0
    for order, x in xs.items():
        for selectivity in SPARSE_SELECTIVITY:
            hi = int(selectivity * (1 << 30)) - 1
            got = sel.select_scan_sparse(x, y, 0, hi)
            dense = sel.select_scan(x, y, 0, hi)
            want = ref.select_scan_sparse(x, y, 0, hi)
            if not all(torch.equal(g, d) and torch.equal(g, w)
                       for g, d, w in zip(got, dense, want)):
                raise AssertionError(f"select_scan_sparse {order} "
                                     f"{selectivity}: != select_scan/plain")
            del got, dense, want
    last_launches["select_scan_sparse"] = sel.SPARSE_LAUNCHES
    if sel.SPARSE_LAUNCHES != 2 * len(SPARSE_SELECTIVITY):
        raise AssertionError(f"select_scan_sparse launches "
                             f"{sel.SPARSE_LAUNCHES}")
    print(f"launches select_scan_sparse={sel.SPARSE_LAUNCHES}: each equal "
          "to select_scan and to its plain version", flush=True)
    sparse_calls = []
    for order, x in xs.items():
        for selectivity in SPARSE_SELECTIVITY:
            hi = int(selectivity * (1 << 30)) - 1
            need = sparse_need(x, 0, hi)
            row = {"order": order, "selectivity": selectivity,
                   "rows": SPARSE_ROWS,
                   "y_share": need["y_bytes"] / (4 * SPARSE_ROWS),
                   "ms": event_ms(lambda: sel.select_scan_sparse(x, y, 0, hi),
                                  KERNEL_REPS),
                   "select_scan_ms": event_ms(
                       lambda: sel.select_scan(x, y, 0, hi), KERNEL_REPS),
                   "plain_ms": event_ms(
                       lambda: ref.select_scan_sparse(x, y, 0, hi), 1),
                   **need, "library_ms": None}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["sparse_over_dense"] = row["select_scan_ms"] / row["ms"]
            sparse_calls.append(row)
            print("select_scan_sparse " + json.dumps(row), flush=True)
    hi = int(SPARSE_SELECTIVITY[2] * (1 << 30)) - 1
    print("one call " + json.dumps(one_call(
        "select_scan_sparse",
        lambda: sel.select_scan_sparse(x_uniform, y, 0, hi), SPARSE_ROWS,
        int(sel.select_scan_sparse(x_uniform, y, 0, hi)[1]), sel.library(),
        columns=1, shape=("select_scan_shape", 32 | 128))), flush=True)
    del xs, x_uniform, y
    for (m, fn, _, src, replaces), calls in zip(
            LAST, (build_calls, sparse_calls)):
        tot = {x: sum(r[x] for r in calls)
               for x in ("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")}
        kernels.append({
            "name": f"{m}.{fn}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": last_launches[fn],
            "max_abs_err": new_err[fn], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations", "library_ms": None})
    # project of 2^28 rows, the paper's Q1 (§4.1) at a size the memory
    # bounds: with and without the sigmoid, each in turns with torch.sub,
    # beside the 12n-byte bound
    pj = mods["project"]
    x1 = torch.randn(PROJECT_ROWS, generator=gen, device=dev)
    x2 = torch.randn(PROJECT_ROWS, generator=gen, device=dev)
    got = pj.project(x1, x2, 1.0, -1.0)
    if not (torch.equal(got, ref.project(x1, x2, 1.0, -1.0)) and
            torch.equal(got, torch.sub(x1, x2))):
        raise AssertionError("project of 2^28 rows differs from its plain "
                             "version or torch.sub")
    torch.testing.assert_close(
        pj.project(x1, x2, 0.75, -1.25, sigmoid=True),
        ref.project(x1, x2, 0.75, -1.25, sigmoid=True), rtol=1e-6, atol=0)
    del got
    big = {"n": PROJECT_ROWS,
           "bound_ms": 12 * PROJECT_ROWS / HBM_BYTES_PER_S * 1e3,
           "plain": turns(lambda: pj.project(x1, x2, 1.0, -1.0),
                          lambda: torch.sub(x1, x2), calls=KERNEL_REPS),
           "sigmoid": turns(
               lambda: pj.project(x1, x2, 1.0, -1.0, sigmoid=True),
               lambda: torch.sub(x1, x2), calls=KERNEL_REPS)}
    big["bound_share"] = big["bound_ms"] / big["plain"]["kernel_median"]
    big["sigmoid_bound_share"] = \
        big["bound_ms"] / big["sigmoid"]["kernel_median"]
    print("project 2^28 " + json.dumps(big), flush=True)
    next(e for e in kernels if e["name"] == "project")["rows_2e28"] = {
        "ms": big["plain"]["kernel_median"],
        "sigmoid_ms": big["sigmoid"]["kernel_median"],
        "library_ms": big["plain"]["library_median"],
        "bound_ms": big["bound_ms"]}
    del x1, x2
    print(f"phase10_s {time.perf_counter() - t:.3f}")
    del base, vals, sum_inputs, tables

    measured = {"fused": fused_ms, "opat": opat_ms,
                "part": {r["query"]: r["part_query_ms"] for r in part_rows},
                "shared": {"all13": main_wave["query_ms"]}}
    sharded = shard_phase(
        dev, card, db, pdb, cache, queries, oracle, kernels, mods,
        first=first, all13=waves["all13"], pad_to=pads["all13"],
        waves={label: wave_out[label, "all13"]
               for label in ("plain", "packed")},
        measured=measured)
    serving_phase(dev, card, db, cache, queries, oracle, kernels,
                  sharded.pop("calib"), measured)
    mesh_phase(card, oracle, kernels, fused_ms, sharded.pop("logical_ms"))
    launch = ("block", "blocks_per_sm", "warps_per_sm")
    shapes = {(label, r["query"]): {k: r[k] for k in launch}
              for label, rs in (("fused", rows), ("packed_fused", prows))
              for r in rs}
    shapes["shared", "all13"] = {k: main_wave[k] for k in (
        "blocks_per_sm", "probe_groups", "model_probes_per_row")}
    return dict(t_all=t_all, card=card, dev=dev, kernels=kernels, db=db,
                pdb=pdb, cache=cache, queries=queries, oracle=oracle,
                mods=mods, all13=waves["all13"], pad_to=pads["all13"],
                shapes=shapes,
                fused=(first, {r["query"]: r["query_ms"] for r in rows},
                       {r["query"]: r["kernel_ms"] for r in rows}),
                opat=(opat, opat_ms, {}),
                packed_fused=(pfirst,
                              {r["query"]: r["query_ms"] for r in prows},
                              {r["query"]: r["kernel_ms"] for r in prows}),
                shared=({"all13": wave_out["plain", "all13"]},
                        {"all13": main_wave["query_ms"]},
                        {"all13": main_wave["kernel_ms"]}),
                **sharded)


def shard_phase(dev, card, db, pdb, cache, queries, oracle, kernels, mods,
                first, all13, pad_to, waves, measured) -> dict:
    """Phase 12, on the resident databases of phases 4 and 6; returns what
    phase 11 reads (the calibrated hardware, and the 13 queries sharded
    at ``MORSEL_SHARDS`` with their ``query_ms``)."""
    import os
    import shutil
    import tempfile
    from repro_torch.cost.model import H100
    from repro_torch.kernels import ssb_fused
    from repro_torch.sql import calibrate, shard
    from repro_torch.sql import compile as TC
    from repro_torch.sql import model as M
    from repro_torch.sql.compile import compile_plan
    mf = mods["multi_fused"]
    t = phase(f"12 sharding and the cost model: calibration; the 13 queries "
              f"sharded at S = {SHARDS}, plain and packed; the 13-query wave "
              f"sharded at S = {WAVE_SHARDS}; auto, SF {SF}")

    # calibration on the card, into a cache of this run's own
    saved = os.environ.get("REPRO_CALIB_CACHE")
    tmp = tempfile.mkdtemp(prefix="calib-")
    os.environ["REPRO_CALIB_CACHE"] = tmp
    t0 = time.perf_counter()
    calib = calibrate.measure(dev)
    calibrate.save(calib)
    calib_s = time.perf_counter() - t0
    hw = M.default_hardware(dev)
    if hw != calibrate.apply(calib, H100):
        raise AssertionError(f"default_hardware did not read the "
                             f"calibration: {hw}")
    print("calibration " + json.dumps({
        "card": card, "seconds": calib_s,
        "read_GBps": calib.read_bw / 1e9, "write_GBps": calib.write_bw / 1e9,
        "cache_GBps": calib.cache_bw / 1e9,
        "launch_overhead_us": calib.launch_overhead_s * 1e6,
        "h2d_GBps": calib.interconnect_bw / 1e9,
        "published_read_GBps": HBM_BYTES_PER_S / 1e9,
        "read_over_published": calib.read_bw / HBM_BYTES_PER_S,
        "sizes": {"stream_bytes": calibrate.STREAM_BYTES["cuda"],
                  "gather_table_bytes": calibrate.GATHER_TABLE_BYTES["cuda"],
                  "gather_probes": calibrate.GATHER_PROBES["cuda"],
                  "h2d_bytes": calibrate.H2D_BYTES}}), flush=True)

    def own_bytes(sdb, database):
        """Device bytes the shards hold of their own (the re-packed words
        of a packed column cut off a word boundary), in allocator
        blocks."""
        base = database.lineorder
        total = 0
        for x in sdb.shards:
            fact = x.lineorder
            for col in fact.columns:
                d = fact.on_device(col, dev)
                if d.untyped_storage().data_ptr() != \
                        base.on_device(col, dev).untyped_storage().data_ptr():
                    total += -(-d.numel() * 4 // 512) * 512
        return total

    def run_sharded(sdb, s):
        out, launched, shard_ms = {}, {}, {}
        for name, plan in queries.items():
            before = ssb_fused.LAUNCHES
            q = compile_plan(plan, "sharded")
            out[name] = q.execute(sdb, cache=cache)
            launched[name] = ssb_fused.LAUNCHES - before
            if q.device_count != s or len(q.shard_times_s) != s:
                raise AssertionError(f"{name}: {q.device_count} shards, "
                                     f"{len(q.shard_times_s)} times")
            shard_ms[name] = [x * 1e3 for x in q.shard_times_s]
        return out, launched, shard_ms

    databases = (("plain", db), ("packed", pdb))
    shard_rows, at_morsel = [], {}
    sharded_launches = 0            # the first pass of each S and database
    for label, database in databases:
        fused = measured["fused"] if label == "plain" else None
        for s in SHARDS:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            sdb = shard.shard_database(database, s)
            torch.cuda.synchronize()
            over = torch.cuda.memory_allocated() - before
            repacked = own_bytes(sdb, database)
            if over > repacked:
                raise AssertionError(f"{label} S={s}: {over} B over the base, "
                                     f"re-packed words {repacked} B")
            ssb_fused.LAUNCHES = 0
            got, launched, _ = run_sharded(sdb, s)
            sharded_launches += ssb_fused.LAUNCHES
            again, _, shard_ms = run_sharded(sdb, s)
            if set(launched.values()) != {s}:
                raise AssertionError(f"{label} S={s}: spja launches "
                                     f"{launched}, expected {s} a query")
            for name in queries:
                for other, what in ((oracle[name], "numpy oracle"),
                                    (first[name], "fused path"),
                                    (again[name], "second pass")):
                    if not same_bits(got[name], other):
                        raise AssertionError(f"{label} S={s} {name}: "
                                             f"differs from the {what}")
            for name, plan in queries.items():
                times = query_ms(compile_plan(plan, "sharded"), sdb, cache)
                row = {"database": label, "S": s, "query": name,
                       "query_ms": statistics.median(times),
                       "query_ms_max": max(times),
                       "shard_ms": shard_ms[name],
                       "launches": launched[name]}
                if fused is not None:
                    row["fused_query_ms"] = fused[name]
                    row["over_fused"] = row["query_ms"] / fused[name]
                shard_rows.append(row)
                print("sharded " + json.dumps(row), flush=True)
            if (label, s) == ("plain", MORSEL_SHARDS):
                at_morsel = (got, {r["query"]: r["query_ms"] for r in
                                   shard_rows[-len(queries):]}, {})
            print(f"{label} S={s}: allocated over the base {over} B, "
                  f"re-packed words {repacked} B; bit-identical: oracle, "
                  f"fused, second pass", flush=True)
            del sdb
    totals = {f"{label} S={s}": sum(r["query_ms"] for r in shard_rows
                                    if (r["database"], r["S"]) == (label, s))
              for label, _ in databases for s in SHARDS}
    totals["plain fused"] = sum(measured["fused"].values())
    print("sharded totals " + json.dumps(totals), flush=True)

    wave_launches = 0
    for label, database in databases:
        sdb = shard.shard_database(database, WAVE_SHARDS)
        mf.LAUNCHES = 0
        got, shard_s, report = TC.execute_shared_sharded(
            all13, sdb, cache=cache, pad_to=pad_to)
        launched = mf.LAUNCHES
        wave_launches += launched
        if launched != WAVE_SHARDS or len(shard_s) != WAVE_SHARDS:
            raise AssertionError(f"sharded wave {label}: {launched} "
                                 f"launches, {len(shard_s)} shard times")
        for plan, g, w in zip(all13, got, waves[label]):
            if not (same_bits(g, w) and same_bits(g, oracle[plan.name])):
                raise AssertionError(f"sharded wave {label} {plan.name}: "
                                     "differs from execute_shared or the "
                                     "oracle")
        times = []
        for _ in range(QUERY_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, shard_s, _ = TC.execute_shared_sharded(
                all13, sdb, cache=cache, pad_to=pad_to)
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"database": label, "S": WAVE_SHARDS, "launches": launched,
               "morsels": report.n_morsels,
               "query_ms": statistics.median(times),
               "query_ms_max": max(times),
               "shard_ms": [x * 1e3 for x in shard_s]}
        if label == "plain":
            row["wave_query_ms"] = measured["shared"]["all13"]
        print("sharded wave " + json.dumps(row), flush=True)
        del sdb

    # auto: the cost model's pick on the calibrated card, run and timed
    sdb = shard.shard_database(db, MORSEL_SHARDS)
    sharded_ms = at_morsel[1]
    auto_rows = []
    for label, database in (("plain", db), (f"S={MORSEL_SHARDS}", sdb)):
        for name, plan in queries.items():
            q = compile_plan(plan, "auto")
            got = q.execute(database, cache=cache)
            if not same_bits(got, oracle[name]):
                raise AssertionError(f"auto {label} {name}: differs from the "
                                     f"oracle ({q.decided})")
            times = query_ms(compile_plan(plan, "auto"), database, cache)
            have = {k: v.get(name) for k, v in measured.items()
                    if k != "shared"}
            have["sharded"] = sharded_ms[name] if label != "plain" else None
            row = {"database": label, "query": name, "decided": q.decided,
                   "predicted_ms": {k: v * 1e3 for k, v in
                                    q.predictions.items()},
                   "query_ms": statistics.median(times),
                   "measured_ms": have}
            auto_rows.append(row)
            print("auto " + json.dumps(row), flush=True)
    del sdb
    if saved is None:
        del os.environ["REPRO_CALIB_CACHE"]
    else:
        os.environ["REPRO_CALIB_CACHE"] = saved
    shutil.rmtree(tmp)
    for entry, launched in ((kernels[0], sharded_launches),
                            (next(k for k in kernels
                                  if k["name"] == "multi_fused.multi_spja"),
                             wave_launches)):
        entry["launches_sharded"] = launched
    print(f"phase12_s {time.perf_counter() - t:.3f}", flush=True)
    logical_ms = {s: {r["query"]: r["query_ms"] for r in shard_rows
                      if (r["database"], r["S"]) == ("plain", s)}
                  for s in SHARDS}
    return dict(hw=hw, sharded=at_morsel, calib=calib, logical_ms=logical_ms)


# phase 13: the launch counter of each kernel entry's function (the name's
# last part): (wrapper module, counter)
COUNTERS = {"spja": ("ssb_fused", "LAUNCHES"),
            "multi_spja": ("multi_fused", "LAUNCHES"),
            "select_scan": ("select_scan", "LAUNCHES"),
            "select_scan_packed": ("select_scan", "PACKED_LAUNCHES"),
            "select_scan_sparse": ("select_scan", "SPARSE_LAUNCHES"),
            "unpack": ("unpack", "LAUNCHES"),
            "probe_join": ("hash_join", "LAUNCHES"),
            "probe_agg": ("hash_join", "AGG_LAUNCHES"),
            "build": ("hash_join", "BUILD_LAUNCHES"),
            "group_sum": ("agg", "LAUNCHES"),
            "reduce_sum": ("agg", "SUM_LAUNCHES"),
            "project": ("project", "LAUNCHES"),
            "histogram": ("radix_part", "HIST_LAUNCHES"),
            "digit_counts": ("radix_part", "COUNT_LAUNCHES"),
            "partition_multi": ("radix_part", "SCATTER_LAUNCHES"),
            "part_probe": ("part_probe", "LAUNCHES")}
# the kernels phase 13's path launches (PERF.md rows 1-3, 8, 10-14,
# radix_sort's digit counts with row 13), each at least once
SERVING_PATH = ("spja", "multi_spja", "select_scan", "probe_join",
                "group_sum", "project", "histogram", "digit_counts",
                "partition_multi", "part_probe")
# phase 13: the batch server's strategies; the serving loop's arrivals,
# their seed, its result cache's grids and wave size; the fault run
SERVER_STRATEGIES = ("fused", "opat", "part", "shared", "auto")
ARRIVALS = 300
ARRIVAL_SEED = 20
LOOP_CACHE_ENTRIES = 4
LOOP_BATCH = 8
LOOP_SLOW = 1 / 8
# (the first request's every kernel visit an injected OOM, four of them
# down its ladder, which on the card has no host rung: a typed error, and
# the next admission shed until the governor's cooldown passes; then the 13 queries fused, their kernel and upload
# visits faulting at FAULT_RATES (every third fault an OOM), the OOMs
# having released the resident table, in morsels of FAULT_MORSEL halved
# at each OOM: one a query)
FAULT_RATES = {"kernel": 0.2, "upload": 0.2}
FAULT_MORSEL = 64 << 30


def serving_phase(dev, card, db, cache, queries, oracle, kernels, calib,
                  measured) -> None:
    """Phase 13, on phase 4's resident database (before phase 11 frees
    it): the tuner on the card, then the serving control plane."""
    import os
    import shutil
    import tempfile
    from repro_torch.cost.model import H100
    from repro_torch.sql import calibrate, engine, faults, morsel, server
    from repro_torch.sql import model as M
    from repro_torch.sql import resilience as RS
    from repro_torch.sql import result_cache, serving, shard, tune
    from repro_torch.sql import compile as TC
    from repro_torch.sql.compile import compile_plan
    t = phase(f"13 the tuner ({tune.SMOKE_GRID['n']} rows) and the serving "
              f"control plane: batch server, result cache, serving loop of "
              f"{ARRIVALS} arrivals, faults; SF {SF}")
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, _ in COUNTERS.values()}

    def counts():
        return {fn: getattr(mods[m], c) for fn, (m, c) in COUNTERS.items()}

    saved = os.environ.get("REPRO_CALIB_CACHE")
    tmp = tempfile.mkdtemp(prefix="tune-")
    os.environ["REPRO_CALIB_CACHE"] = tmp
    calibrate.save(calib)
    hw_cal = M.default_hardware(dev)
    if hw_cal != calibrate.apply(calib, H100):
        raise AssertionError(f"default_hardware did not read the "
                             f"calibration: {hw_cal}")
    for m, c in COUNTERS.values():
        setattr(mods[m], c, 0)

    # the tuner: every swept configuration is checked against its oracle
    # (and every partition depth against the default depth's rows) before
    # it is timed — measure raises otherwise
    t0 = time.perf_counter()
    tunings = tune.measure(grid=tune.SMOKE_GRID, device=dev)
    tune_s = time.perf_counter() - t0
    tune.save(tunings)
    for key in sorted(tunings.configs):
        c = tunings.configs[key]
        print("tuner " + json.dumps({
            "family": c.family, "width": c.width, "r": c.r,
            "part_bits": c.part_bits,
            "part_budget_bytes": c.part_budget_bytes, "best_us": c.best_us,
            "default_us": c.default_us, "speedup": c.speedup,
            "eff_GBps": None if c.eff_bw is None else c.eff_bw / 1e9,
            "card": card}), flush=True)
    store = tune.cached_store(dev)
    hw = M.default_hardware(dev)
    if hw != tune.apply_hardware(store, hw_cal):
        raise AssertionError(f"default_hardware did not fold the tunings: "
                             f"{hw}")
    if tune.tuned_r(device=dev) != store.r():
        raise AssertionError("tuned_r did not read the store")
    pp = tunings.configs["part_probe/w32"]
    if M.part_bits(tune.SMOKE_GRID["n_build"], hw) != pp.part_bits:
        raise AssertionError("part_bits does not give the tuned depth")
    print("tuned " + json.dumps({
        "seconds": tune_s, "grid": tune.SMOKE_GRID, "card": card,
        "calibrated_read_GBps": hw_cal.read_bw / 1e9,
        "tuned_read_GBps": hw.read_bw / 1e9,
        "part_budget_bytes": hw.part_budget_bytes,
        "static_part_bits": M.part_bits(tune.SMOKE_GRID["n_build"], H100),
        "tuned_part_bits": pp.part_bits, "tuned_r": store.r(),
        "checked": "every swept configuration gave the default's bits"}),
        flush=True)

    # the 13 queries part under the tuned budget, and auto on both
    # hardwares beside the measured times
    auto_rows = []
    for name, plan in queries.items():
        bits = {label: [M.part_bits(cache.get_build_count(db, j), h)
                        for j in plan.joins]
                for label, h in (("calibrated", hw_cal), ("tuned", hw))}
        q = compile_plan(plan, "part")
        got = q.execute(db, cache=cache)
        if not same_bits(got, oracle[name]):
            raise AssertionError(f"part (tuned) {name}: differs from the "
                                 "oracle")
        # the last join launched (a chain that empties launches no more)
        lc = q.launch_config.get("part_probe")
        if plan.joins and lc["bits"] not in bits["tuned"]:
            raise AssertionError(f"part (tuned) {name}: launched {lc}, the "
                                 f"tuned bits are {bits['tuned']}")
        budget = TC._model_budget(plan, db, dev,
                                  morsel.DEFAULT_MORSEL_BYTES)
        choice = {label: M.choose(plan, db, hw=h, n_shards=1,
                                  morsel_bytes=budget)
                  for label, h in (("calibrated", hw_cal), ("tuned", hw))}
        q = compile_plan(plan, "auto")
        got = q.execute(db, cache=cache)
        if not same_bits(got, oracle[name]) or \
                q.decided != choice["tuned"].strategy:
            raise AssertionError(f"auto (tuned) {name}: {q.decided}, "
                                 f"differs from the oracle or the choice")
        row = {"query": name, "part_bits": bits,
               **{f"{label}_decided": c.strategy for label, c in
                  choice.items()},
               **{f"{label}_predicted_ms": {k: v * 1e3 for k, v in
                                            c.predictions.items()}
                  for label, c in choice.items()},
               "measured_ms": {k: v.get(name) for k, v in measured.items()
                               if k != "shared"}}
        auto_rows.append(row)
        print("auto tuned " + json.dumps(row), flush=True)
    moved = [r["query"] for r in auto_rows
             if r["calibrated_decided"] != r["tuned_decided"]]
    print(f"auto: {len(moved)} choices moved by the tuning {moved}; card "
          f"{card}", flush=True)

    # the oracles of the narrowed variants (the result cache's and the
    # serving loop's subsumed answers)
    t0 = time.perf_counter()
    variants = engine.ssb_narrowed_variants(queries)
    want = dict(oracle)
    want.update({name: engine.run_query_oracle(db, plan)
                 for name, (_, plan) in variants.items()})
    print(f"variant oracles: {len(variants)}, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def expect_ran(plan, strategy, r):
        """The strategy a clean result must report: what compile_plan
        lowers a fixed strategy to, a wave member's "shared", or the
        strategy auto decided (``model_choice``)."""
        if r.shared_wave_size is not None:
            return "shared"
        if strategy == "auto":
            return r.model_choice
        return compile_plan(plan, strategy).strategy

    def check_clean(label, srv, results, asked, before=None):
        """Every result the oracle's bits on its first attempt, with no
        error and the strategy it asked for; no retry, and no fallback but
        the compile-time ones the results report (the server's counts
        since ``before``, a copy of its stats)."""
        fallbacks = 0
        for rid, (plan, strategy) in asked.items():
            r = results[rid]
            if r.error is not None or r.attempts != 1 or r.result is None:
                raise AssertionError(f"{label} {plan.name} {strategy}: "
                                     f"error {r.error}, attempts "
                                     f"{r.attempts}")
            if not same_bits(r.result, want[plan.name]):
                raise AssertionError(f"{label} {plan.name} {strategy}: "
                                     "differs from the oracle")
            if not r.cache_hit and r.strategy != expect_ran(plan, strategy,
                                                            r):
                raise AssertionError(f"{label} {plan.name} {strategy}: ran "
                                     f"{r.strategy}")
            fallbacks += r.fallback_reason is not None
        grew = {k: srv.stats[k] - (before or {}).get(k, 0)
                for k in ("retries", "fallbacks", "errors",
                          "pressure_events")}
        if grew != {"retries": 0, "fallbacks": fallbacks, "errors": 0,
                    "pressure_events": 0}:
            raise AssertionError(f"{label}: stats {grew}")

    # 1. the batch server, on the card in auto mode: each strategy's 13
    # queries twice (the second pass every build a hit), and sharded at
    # S = WAVE_SHARDS
    families = {"fused": {"spja"}, "sharded": {"spja"},
                "shared": {"multi_spja"}, "part": {"part_probe"},
                "opat": {"select_scan"}, "ref": set()}
    srv = server.QueryServer(db, max_batch=16)
    if (srv.device, srv.mode) != (dev, "auto"):
        raise AssertionError(f"server on {srv.device} {srv.mode}")
    ssrv = server.QueryServer(shard.shard_database(db, WAVE_SHARDS),
                              max_batch=16)
    batch = {}
    for strategy in SERVER_STRATEGIES + ("sharded",):
        s = ssrv if strategy == "sharded" else srv
        for rep in range(2):
            asked = {s.submit(plan, strategy): (plan, strategy)
                     for plan in queries.values()}
            before = {k: v for k, v in s.stats.items() if k != "occupancy"}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = s.run()
            run_ms = (time.perf_counter() - t0) * 1e3
            check_clean(f"server {strategy}", s, results, asked, before)
        for rid, (plan, _) in asked.items():
            r = results[rid]
            if r.cache_misses:
                raise AssertionError(f"server {strategy} {plan.name}: "
                                     f"{r.cache_misses} builds on the "
                                     "second pass")
            ran = set(r.launch_config)
            if not ran <= families[r.strategy] | families["opat"] or \
                    (r.strategy != "opat" and not ran):
                raise AssertionError(f"server {strategy} {plan.name}: "
                                     f"launch_config {r.launch_config}")
            if strategy == "sharded" and r.device_count != WAVE_SHARDS:
                raise AssertionError(f"server sharded {plan.name}: "
                                     f"{r.device_count} shards")
        if strategy == "auto":
            wave_pred = M.predict_shared(
                list(queries.values()), db, hw=hw, n_shards=1,
                morsel_bytes=TC._model_budget(
                    queries["q1.1"], db, dev, morsel.DEFAULT_MORSEL_BYTES))
            print("auto wave " + json.dumps({
                "predicted_ms": {k: v * 1e3 for k, v in wave_pred.items()},
                "shared_run_ms": batch["shared"]["run_ms"],
                "fused_run_ms": batch["fused"]["run_ms"], "card": card}),
                flush=True)
        row = {"strategy": strategy, "run_ms": run_ms,
               "latency_ms": {r.name: r.latency_s * 1e3
                              for r in results.values()},
               "ran": {r.name: r.strategy for r in results.values()},
               "wave_sizes": sorted({r.shared_wave_size or 1
                                     for r in results.values()}),
               "launch_config": {r.name: r.launch_config
                                 for r in list(results.values())[:2]},
               "card": card}
        batch[strategy] = row
        print("server " + json.dumps(row), flush=True)
    solo_ms = statistics.median(batch["fused"]["latency_ms"].values())

    # 2. the result cache: the 13 queries, then the narrowed variants
    # answered by subsumption
    rsrv = server.QueryServer(db, result_cache=result_cache.ResultCache())
    asked = {rsrv.submit(plan, "fused"): (plan, "fused")
             for plan in queries.values()}
    check_clean("result cache", rsrv, rsrv.run(), asked)
    asked = {rsrv.submit(plan, "fused"): (plan, "fused")
             for _, plan in variants.values()}
    before = {k: v for k, v in rsrv.stats.items() if k != "occupancy"}
    t0 = time.perf_counter()
    results = rsrv.run()
    sub_ms = (time.perf_counter() - t0) * 1e3
    check_clean("result cache", rsrv, results, asked, before)
    if not all(r.subsumption_hit for r in results.values()):
        raise AssertionError("result cache: a variant was not subsumed")
    print("result cache " + json.dumps({
        "variants": len(variants), "run_ms": sub_ms,
        "stats": rsrv.result_cache.stats(),
        "subsume_hits": rsrv.stats["result_subsume_hits"], "card": card}),
        flush=True)

    # 3. the serving loop: a few hundred Poisson arrivals over the 13
    # queries and their variants, the pool anchored and prewarmed, at the
    # rate one solo fused query a time would serve: asked as "shared" (a
    # wave serves its members faster, so waves form and run as one pass),
    # then as "auto" (the cost model decides whether a formed wave shares)
    # at that rate and at LOOP_SLOW of it
    pool = list(queries.values()) + [p for _, p in variants.values()]

    def loop_run(rate: float, strategy: str) -> dict:
        sched = serving.poisson_arrivals(rate, ARRIVALS, seed=ARRIVAL_SEED)
        pick = np.random.default_rng(ARRIVAL_SEED).integers(
            0, len(pool), ARRIVALS)
        loop = serving.ServingLoop(
            db, max_batch=LOOP_BATCH, warm_pool=pool,
            result_cache=result_cache.ResultCache(
                max_entries=LOOP_CACHE_ENTRIES))
        t0 = time.perf_counter()
        buckets = loop.prewarm()
        prewarm_s = time.perf_counter() - t0
        loop.server.stats.clear()
        loop.server.stats["occupancy"] = []
        tickets = []
        with loop:
            start = time.monotonic()
            for at, i in zip(sched, pick):
                pause = start + at - time.monotonic()
                if pause > 0:
                    time.sleep(pause)
                tickets.append(loop.submit(pool[i], strategy))
            results = [tk.wait(timeout=120) for tk in tickets]
        span_s = time.monotonic() - start
        check_clean("serving loop", loop.server,
                    {tk.rid: r for tk, r in zip(tickets, results)},
                    {tk.rid: (tk.plan, tk.strategy) for tk in tickets})
        lat = np.array([tk.latency_s for tk in tickets]) * 1e3
        waves = [r.shared_wave_size for r in results if r.shared_wave_size]
        st = loop.server.stats
        row = {"strategy": strategy, "arrivals": ARRIVALS, "rate_qps": rate,
               "seed": ARRIVAL_SEED,
               "span_s": span_s, "served_qps": ARRIVALS / span_s,
               "prewarm_buckets": buckets, "prewarm_s": prewarm_s,
               "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "mean_ms": float(lat.mean()), "max_ms": float(lat.max()),
               "shared_waves": st["shared_waves"],
               "wave_members": len(waves),
               "mean_wave_size": float(np.mean(waves)) if waves else None,
               "max_wave_size": max(waves) if waves else None,
               "dispatch": loop.former.dispatch_reasons,
               "former_model_calls": loop.predictor.model_calls,
               "former_model_s": loop.predictor.model_s,
               "arbitration_s": st["arbitration_s"],
               "result_cache_hits": st["result_cache_hits"],
               "subsume_hits": st["result_subsume_hits"],
               "ran": {k: sum(r.strategy == k for r in results)
                       for k in sorted({r.strategy for r in results})},
               "retries": st["retries"], "card": card}
        print("serving loop " + json.dumps(row), flush=True)
        return row

    rate = 1e3 / solo_ms
    full = loop_run(rate, "shared")
    if not full["max_wave_size"] or full["max_wave_size"] < 2:
        raise AssertionError("serving loop: no wave of two members formed")
    loop_run(rate, "auto")
    loop_run(rate * LOOP_SLOW, "auto")

    # 4. faults: an injected OOM, then kernel and upload faults — every
    # request a result with the oracle's bits, or a typed error (the
    # OOM's governor releases the resident fact table: the later rungs
    # stream it from the host, where the upload site is visited)
    t0 = time.perf_counter()
    fsrv = server.QueryServer(db, morsel_bytes=FAULT_MORSEL)
    mb0 = fsrv.morsel_bytes
    asked = {}
    with faults.active(faults.FaultPlan(ARRIVAL_SEED, {"kernel": 1.0},
                                        oom_every=1)):
        asked[fsrv.submit(queries["q2.1"], "fused")] = queries["q2.1"]
        results = fsrv.run()
    oom_ladder = {k: fsrv.stats[k] for k in ("pressure_events", "retries")}
    # its pressure events shut the door (a typed MemoryPressure at
    # admission) until SHED_COOLDOWN_S passes with no new one
    try:
        fsrv.submit(queries["q1.1"], "fused")
    except RS.MemoryPressure:
        pass
    else:
        raise AssertionError("faults: the governor admitted a request "
                             "past its high-water mark")
    time.sleep(RS.SHED_COOLDOWN_S)
    plan_f = faults.FaultPlan(ARRIVAL_SEED, FAULT_RATES)
    with faults.active(plan_f):
        more = {fsrv.submit(plan, "fused"): plan
                for plan in queries.values()}
        results.update(fsrv.run())
    asked.update(more)
    kinds = {}
    for rid, plan in asked.items():
        r = results[rid]
        if r.error is None:
            if not same_bits(r.result, oracle[plan.name]):
                raise AssertionError(f"faults {plan.name}: differs from the "
                                     f"oracle ({r.strategy})")
        elif not isinstance(r.error, RS.ErrorInfo) or \
                not isinstance(r.error.exception, RS.QueryError):
            raise AssertionError(f"faults {plan.name}: untyped {r.error}")
        if r.strategy == "ref":
            raise AssertionError(f"faults {plan.name}: answered on the host")
        key = r.strategy if r.error is None else r.error.error_kind
        kinds[key] = kinds.get(key, 0) + 1
    if fsrv.morsel_bytes >= mb0 or not fsrv.stats["pressure_events"]:
        raise AssertionError(f"faults: the governor did not halve the "
                             f"morsels ({mb0} -> {fsrv.morsel_bytes})")
    print("faults " + json.dumps({
        "requests": len(asked), "rates": FAULT_RATES,
        "seconds": time.perf_counter() - t0, "oom_request": oom_ladder,
        "outcomes": kinds, "sheds": fsrv.stats["sheds"],
        "morsel_bytes": [mb0, fsrv.morsel_bytes],
        "stats": {k: v for k, v in fsrv.stats.items() if k != "occupancy"},
        "injected": plan_f.stats(),
        "breakers": {f"{k[0]}/{k[1]}": v for k, v in
                     fsrv.breakers.snapshot().items()},
        "card": card}), flush=True)

    launched = counts()
    missing = [fn for fn in SERVING_PATH if not launched[fn]]
    if missing:
        raise AssertionError(f"phase 13 launched none of {missing}")
    for entry in kernels:
        fn = entry["name"].split(".")[-1]
        if fn in launched:
            entry["launches_serving"] = launched[fn]
    print("serving launches " + json.dumps(launched), flush=True)
    if saved is None:
        del os.environ["REPRO_CALIB_CACHE"]
    else:
        os.environ["REPRO_CALIB_CACHE"] = saved
    shutil.rmtree(tmp)
    print(f"phase13_s {time.perf_counter() - t:.3f}", flush=True)


def cuda_tensors() -> list:
    """(bytes, shape, dtype) of each device storage that a Python tensor
    still holds, largest first."""
    gc.collect()
    held = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            held[st.data_ptr()] = (st.nbytes(), list(o.shape),
                                   str(o.dtype).replace("torch.", ""))
    return sorted(held.values(), reverse=True)


def morsel_phase(t_all, card, dev, kernels, db, pdb, cache, queries, oracle,
                 mods, all13, pad_to, shapes, hw, **resident) -> int:
    """Phase 11, then the kernels line and the result line."""
    from repro_torch.cost.model import morsel_pipeline_time
    from repro_torch.kernels import ssb_fused
    from repro_torch.sql import compile as TC
    from repro_torch.sql import morsel as MS
    from repro_torch.sql import shard
    from repro_torch.sql.compile import compile_plan
    t = phase(f"11 morsels: 13 SSB queries fused, opat, shared, packed "
              f"fused and sharded at S = {MORSEL_SHARDS}, "
              f"{MORSEL_BYTES >> 20} MiB morsels, SF {SF}")
    h2d, host = {}, np.ones(H2D_BYTES, np.uint8)
    dst = torch.empty(H2D_BYTES, dtype=torch.uint8, device=dev)
    pinned = torch.ones(H2D_BYTES, dtype=torch.uint8, pin_memory=True)

    def copy_ms(src, reps=3):
        """Host-clock ms of one host-to-device copy of ``src``."""
        to = dst[:src.shape[0]]
        to.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            to.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    h2d["pinned_tensor_ms"] = copy_ms(pinned)
    h2d["pageable_numpy_ms"] = copy_ms(torch.from_numpy(host))
    t0 = time.perf_counter()
    start, end = MS.page_lock(host)
    h2d["register_ms"] = (time.perf_counter() - t0) * 1e3
    at = host.ctypes.data
    h2d["registered_numpy_ms"] = copy_ms(torch.from_numpy(
        host[start - at:end - at]))
    for k in ("pinned_tensor", "pageable_numpy", "registered_numpy"):
        n_bytes = end - start if k == "registered_numpy" else H2D_BYTES
        h2d[f"{k}_GBps"] = n_bytes / h2d[f"{k}_ms"] / 1e6
    h2d["calibrated_GBps"] = hw.interconnect_bw / 1e9
    print("h2d " + json.dumps(h2d), flush=True)
    h2d_rate = h2d["registered_numpy_GBps"] * 1e9
    del dst, pinned, host
    # the fact tables leave the card: each query now streams its morsels
    db.lineorder.release(device=True)
    pdb.lineorder.release(device=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def tensors_of(entry):
        """The device tensors of a hash-cache entry: a table's (htk, htv),
        part_loop's list of them, or PackedParts."""
        if torch.is_tensor(entry):
            return [entry]
        if isinstance(entry, (tuple, list)):
            return [t for e in entry for t in tensors_of(e)]
        return [t for t in (getattr(entry, "htk", None),
                            getattr(entry, "htv", None)) if torch.is_tensor(t)]

    def tables_bytes():
        return sum(t.numel() * t.element_size()
                   for entry in cache.tables.values()
                   for t in tensors_of(entry))

    held = cuda_tensors()
    print(f"resident fact bytes {db.lineorder.resident_bytes(dev)} plain, "
          f"{pdb.lineorder.resident_bytes(dev)} packed; allocated "
          f"{torch.cuda.memory_allocated() / 1e6:.1f} MB, of which the hash "
          f"cache's tables {tables_bytes() / 1e6:.1f} MB; device tensors "
          f"held: {len(held)}, {sum(h[0] for h in held) / 1e6:.1f} MB, the "
          f"largest {held[:4]}", flush=True)
    opat_mods = [mods[m] for m, *_ in OPAT]
    mf = mods["multi_fused"]

    def scan_cols(label, name):
        """The fact columns a query (or the wave) streams."""
        if label == "shared":
            col_ix, joins, mcol = TC.shared_footprint(all13)
            return [*col_ix, *(j.fact_col for j in joins), *mcol]
        plan = queries[name]
        return (TC._chain_scan_cols(plan) if label == "opat"
                else TC._fused_scan_cols(plan))

    def launches_a_morsel(label, name):
        """The dispatches a morsel the cost model charges the strategy."""
        if label != "opat":
            return 1
        plan = queries[name]
        return len(plan.filters) + len(plan.joins) + 2

    def run_morsels(label, database, name, budget=MORSEL_BYTES):
        """One morsel run of a query (or the wave) -> (result, n_morsels,
        double-buffer peak)."""
        if label == "shared":
            got, rep = TC.execute_shared_morsels(
                all13, database, cache=cache, pad_to=pad_to,
                morsel_bytes=budget)
            return got, rep.n_morsels, rep.peak_resident_bytes
        q = compile_plan(queries[name], {"opat": "opat",
                                         "sharded": "sharded"}.get(label,
                                                                   "fused"))
        got = q.execute(database, cache=cache, morsel_bytes=budget)
        return got, q.n_morsels, q.peak_resident_bytes

    def working_set(label, database, name, cols):
        """Device bytes a fact row of the query needs beyond its scanned
        columns and the hash tables (intermediates, grids): a one-morsel
        run over the columns uploaded whole first, which are then
        dropped again."""
        fact = database.lineorder
        for c in dict.fromkeys(cols):
            fact.on_device(c, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, n_morsels, _ = run_morsels(label, database, name,
                                      budget=1 << 40)
        torch.cuda.synchronize()
        work = torch.cuda.max_memory_allocated() - before
        fact.release(device=True)
        if n_morsels != 1:
            raise AssertionError(f"morsels {label} {name}: {n_morsels} "
                                 "morsels in the one-morsel run")
        return work / fact.n_rows

    def counted():
        return {"spja": ssb_fused.LAUNCHES, "multi_spja": mf.LAUNCHES,
                **{fn: mod.LAUNCHES for (_, fn, *_), mod in
                   zip(OPAT, opat_mods)}}

    # the shards of the host table (phase 12's were views of the resident
    # one): each streams its own morsels
    sdb = shard.shard_database(db, MORSEL_SHARDS)
    databases = {"fused": db, "opat": db, "packed_fused": pdb, "shared": db,
                 "sharded": sdb}
    # a sharded fold runs the fused kernel: the fused run's working set
    per_row = {(label, name): working_set(label, databases[label], name,
                                          scan_cols(label, name))
               for label, (res, *_) in resident.items() for name in res
               if label != "sharded"}
    per_row.update({("sharded", name): per_row["fused", name]
                    for name in resident["sharded"][0]})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ssb_fused.LAUNCHES = mf.LAUNCHES = 0
    for mod in opat_mods:
        mod.LAUNCHES = 0
    morsel_rows, slack = [], 64 << 20
    for label, (res, res_ms, res_kernel_ms) in resident.items():
        database = databases[label]
        for name in res:
            cols = scan_cols(label, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before_alloc = torch.cuda.memory_allocated()
            launched = counted()
            got, n_morsels, peak_res = run_morsels(label, database, name)
            torch.cuda.synchronize()
            peak_alloc = torch.cuda.max_memory_allocated()
            launched = {k: v - launched[k] for k, v in counted().items()}
            members = (list(zip(all13, got)) if label == "shared"
                       else [(queries[name], got)])
            want = (dict(zip((p.name for p in all13), res["all13"]))
                    if label == "shared" else {name: res[name]})
            for plan, g in members:
                if not (same_bits(g, oracle[plan.name])
                        and same_bits(g, want[plan.name])):
                    raise AssertionError(f"morsels {label} {plan.name}: "
                                         "differs from the oracle or the "
                                         "resident result")
            if n_morsels < (MIN_PACKED_MORSELS if database is pdb
                            else MIN_MORSELS):
                raise AssertionError(f"morsels {label} {name}: only "
                                     f"{n_morsels} morsels")
            kernel = {"fused": "spja", "packed_fused": "spja",
                      "shared": "multi_spja", "sharded": "spja"}.get(label)
            if kernel and launched[kernel] != n_morsels:
                raise AssertionError(f"morsels {label} {name}: {launched} "
                                     f"launches for {n_morsels} morsels")
            if label == "sharded":      # morsels add across shards
                per_shard = [MS.MorselStream(x.lineorder, MORSEL_BYTES,
                                             cols=cols).n_morsels
                             for x in sdb.shards]
                if n_morsels != sum(per_shard):
                    raise AssertionError(f"morsels sharded {name}: "
                                         f"{n_morsels}, the shards' streams "
                                         f"{per_shard}")
            stream = MS.MorselStream(database.lineorder, MORSEL_BYTES,
                                     cols=cols)
            scanned = sum(stream.morsel_nbytes(i)
                          for i in range(stream.n_morsels))
            # the hash tables, the two buffers, and a morsel's rows at the
            # working set the one-morsel run measured
            tables = tables_bytes()
            work = per_row[label, name] * stream.rows_per
            bound = tables + peak_res + work + slack
            if peak_alloc > bound:
                raise AssertionError(f"morsels {label} {name}: device peak "
                                     f"{peak_alloc} B over {bound} B")
            times = []
            for _ in range(MORSEL_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_morsels(label, database, name)
                times.append((time.perf_counter() - t0) * 1e3)
            row = {"strategy": label, "query": name, "morsels": n_morsels,
                   "launches": launched,
                   "launch_shape": shapes.get((label, name)),
                   "query_ms": statistics.median(times),
                   "resident_query_ms": res_ms[name],
                   "resident_kernel_ms": res_kernel_ms.get(name),
                   "scanned_GB": scanned / 1e9,
                   "upload_bound_ms": scanned / h2d_rate * 1e3,
                   "model_ms": morsel_pipeline_time(
                       scanned, n_morsels, hw,
                       launches_a_morsel(label, name)) * 1e3,
                   "peak_alloc_MB": peak_alloc / 1e6,
                   "bound_MB": bound / 1e6,
                   "allocated_before_MB": before_alloc / 1e6,
                   "hash_tables_MB": tables / 1e6,
                   "double_buffer_MB": peak_res / 1e6,
                   "work_B_per_row": per_row[label, name],
                   "work_MB": work / 1e6}
            row["over_upload_bound"] = row["query_ms"] / \
                row["upload_bound_ms"]
            row["over_model"] = row["query_ms"] / row["model_ms"]
            morsel_rows.append(row)
            print("morsel " + json.dumps(row), flush=True)
    morsel_launches = counted()
    totals = {label: {k: sum(r[k] or 0.0 for r in morsel_rows
                             if r["strategy"] == label)
                      for k in ("query_ms", "resident_query_ms",
                                "resident_kernel_ms", "upload_bound_ms",
                                "model_ms", "scanned_GB")}
              for label in resident}
    print("morsel totals " + json.dumps(totals), flush=True)
    print("profile morsel q2.1 fused " + json.dumps(profiled(
        lambda: compile_plan(queries["q2.1"], "fused").execute(
            db, cache=cache, morsel_bytes=MORSEL_BYTES),
        ("spja", "copy to device"))), flush=True)
    for entry in kernels:
        fn = entry["name"].split(".")[-1]
        if fn in morsel_launches:
            entry["launches_morsels"] = morsel_launches[fn]
    print(f"phase11_s {time.perf_counter() - t:.3f}")
    lm_phase(dev, card)
    train_phase(dev, card, kernels)
    print(f"total_s {time.perf_counter() - t_all:.3f}")
    print(f"card {card}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# phase 16: the mesh paths.  Worlds of MESH_WORLDS ranks on the one card
# (S = 1 over NCCL, S = 2 and 4 over gloo: NCCL refuses two ranks on one
# device), each rank generating SF 20 from SEED and holding its own shard;
# the runs of each world; the MoE checks on a 2 x 2 and a 1 x 4 mesh
MESH_WORLDS = (1, 2, 4)
MESH_TIMEOUT_S = 300
MESH_RUNS = {
    1: [{"label": "plain", "resident": True, "reps": QUERY_REPS}],
    2: [{"label": "plain", "resident": True, "reps": QUERY_REPS},
        {"label": "windows", "morsel_bytes": MORSEL_BYTES},
        {"label": "packed", "pack": True, "resident": True,
         "reps": QUERY_REPS}],
    4: [{"label": "plain", "resident": True, "reps": QUERY_REPS}]}
MOE_SEED = 16
MOE_SMOKE = ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
# the full-width layer: deepseek-moe-16b's 64 experts of d_model 2048 and
# d_ff 1408 in bf16 (1.1 GB), a batch of 4 x 512 tokens, 16 experts a rank
MOE_FULL = {"arch": "deepseek-moe-16b", "smoke": False, "mesh": (1, 4),
            "seed": MOE_SEED, "batch": 4, "seq": 512, "params_on": "card"}
# bf16 keeps 8 significant bits: the local path rounds each of a token's
# expert outputs as it accumulates them in bf16, the mesh path sums the
# ranks' partial outputs in f32 and rounds once, so the two differ by a
# few bf16 steps of the largest output (2^-8 of it a step); a wrong
# expert slice or a lost rank moves outputs by their own size
MOE_BF16_TOL = 2 ** -5


def mesh_phase(card, oracle, kernels, fused_ms, logical_ms) -> None:
    """Phase 16, after phase 13 and before phase 11 frees the resident
    database: ``sharded`` over process groups of ranks sharing the card,
    the interconnect's all-reduce, and expert-parallel MoE."""
    from repro_torch.distributed import mesh as MESH
    from repro_torch.distributed import ranks
    from repro_torch.sql.calibrate import ALLREDUCE_ELEMS
    t = phase(f"16 the mesh paths: the 13 queries sharded over worlds of "
              f"{MESH_WORLDS} ranks on one card, SF {SF}; the interconnect; "
              f"expert-parallel MoE on 2 x 2 and 1 x 4 meshes")
    launches = 0
    dev = torch.device("cuda", 0)
    for world in MESH_WORLDS:
        backend = MESH.backend_for(["cuda:0"] * world)
        torch.cuda.synchronize()
        parent_used = ranks.card_used_bytes(dev)
        t0 = time.perf_counter()
        out = MESH.spawn(ranks.sql_rank, world, backend,
                         {"sf": SF, "seed": SEED, "runs": MESH_RUNS[world],
                          "interconnect": [world] if world > 1 else []},
                         timeout_s=MESH_TIMEOUT_S)
        print("mesh_world " + json.dumps({
            "S": world, "backend": backend,
            "seconds": time.perf_counter() - t0,
            "db": [r["db"] for r in out], "db_s": [r["db_s"] for r in out],
            "pack_s": [r["pack_s"] for r in out]}), flush=True)
        for run in MESH_RUNS[world]:
            label = run["label"]
            runs = [r["runs"][label] for r in out]
            for rank, got in enumerate(runs):
                for name, want in oracle.items():
                    if not same_bits(got["results"][name], want):
                        raise AssertionError(f"mesh S={world} {label} rank "
                                             f"{rank} {name}: differs from "
                                             "the oracle")
                    if (got["device_count"][name],
                            got["shard_times"][name]) != (world, 1):
                        raise AssertionError(f"mesh S={world} {label} {name}:"
                                             f" {got['device_count'][name]} "
                                             "shards, "
                                             f"{got['shard_times'][name]} "
                                             "times")
                windows = sum(got["morsels"].values())
                if got["spja"] != got["morsels"] or got["launches"] != {
                        "ssb_fused.LAUNCHES": windows}:
                    raise AssertionError(
                        f"mesh S={world} {label} rank {rank}: spja "
                        f"{got['spja']} against windows {got['morsels']}; "
                        f"launched {got['launches']}")
                if label == "windows" and min(got["morsels"].values()) < 2:
                    raise AssertionError(f"mesh S={world} windows rank "
                                         f"{rank}: {got['morsels']} windows")
                launches += windows
            row = {"S": world, "run": label, "backend": backend,
                   "bits": "the oracle's on every rank",
                   "windows": {name: [g["morsels"][name] for g in runs]
                               for name in oracle},
                   "spja_launches": [sum(g["spja"].values()) for g in runs],
                   "shard_rows": [g["shard_rows"] for g in runs],
                   "shard_bytes": [g["shard_bytes"] for g in runs],
                   "table_bytes": [g["table_bytes"] for g in runs],
                   "reserved_bytes": [g["reserved_bytes"] for g in runs]}
            # the ranks' share of the card's memory while each held its
            # shard and tables, and the CUDA context: that share less what
            # the allocators reserved (the parent's own held still)
            ranks_used = runs[0]["card_used_bytes"] - parent_used
            row["ranks_used_bytes"] = ranks_used
            row["context_bytes_a_rank"] = (
                ranks_used - sum(g["reserved_bytes"] for g in runs)) / world
            if run.get("reps"):
                row["query_ms"] = {name: max(g["query_ms"][name]
                                             for g in runs)
                                   for name in oracle}
                row["rank_query_ms"] = [g["query_ms"] for g in runs]
                row["allreduce_ms"] = max(g["allreduce_ms"] for g in runs)
                logical = (fused_ms if world == 1 else
                           logical_ms.get(world) if label == "plain"
                           else None)
                if logical:
                    row["logical_query_ms"] = logical
                    row["total_ms"] = sum(row["query_ms"].values())
                    row["logical_total_ms"] = sum(logical.values())
            print("mesh_run " + json.dumps(row), flush=True)
        if world > 1:
            links = [r["interconnect"][0] for r in out]
            if len({(x["rate"], x["backend"]) for x in links}) != 1 or \
                    not links[0]["rate"] or links[0]["backend"] != backend:
                raise AssertionError(f"interconnect S={world}: {links}")
            print("mesh_interconnect " + json.dumps({
                "S": world, "backend": links[0]["backend"],
                "GBps": links[0]["rate"] / 1e9,
                "elems": ALLREDUCE_ELEMS, "card": card}), flush=True)
        del out
    next(k for k in kernels
         if k["name"] == "ssb_fused.spja")["launches_mesh"] = launches

    cases = [{"arch": arch, "mesh": (2, 2), "seed": MOE_SEED, "batch": 4,
              "seq": 32, "forward": True} for arch in MOE_SMOKE]
    t0 = time.perf_counter()
    out = MESH.spawn(ranks.moe_rank, 4, MESH.backend_for(["cuda:0"] * 4),
                     {"cases": cases + [MOE_FULL]}, timeout_s=MESH_TIMEOUT_S)
    for i, case in enumerate(cases + [MOE_FULL]):
        got = [r["cases"][i] for r in out]
        full = case is MOE_FULL
        tol = MOE_BF16_TOL * max(g["local_max_abs"] for g in got) if full \
            else LM_TOL
        errs = [g["max_abs_err"] for g in got]
        fwd = [g.get("forward_err") for g in got]
        if max(errs) > tol or max(g["aux_err"] for g in got) > LM_TOL or \
                (not full and max(fwd) > LM_TOL):
            raise AssertionError(f"moe {case['arch']} {case['mesh']}: errors "
                                 f"{errs}, aux {[g['aux_err'] for g in got]},"
                                 f" forward {fwd} (tolerance {tol})")
        print("mesh_moe " + json.dumps({
            "arch": case["arch"], "mesh": case["mesh"],
            "dtype": got[0]["dtype"], "full_width": full,
            "max_abs_err": max(errs), "tolerance": tol,
            "aux_err": max(g["aux_err"] for g in got),
            "forward_err": None if full else max(fwd),
            "local_on": got[0]["local_on"],
            "local_ms": got[0]["local_ms"],
            "mesh_ms": [g["mesh_ms"] for g in got],
            "expert_bytes_a_rank": got[0]["expert_bytes"],
            "card": card}), flush=True)
    print(f"moe_world_s {time.perf_counter() - t0:.3f}")
    print(f"phase16_s {time.perf_counter() - t:.3f}", flush=True)


# phase 14: the LM serving path.  The 10 smoke configs in float32 from one
# seed, card against host within the CPU tests' tolerance; then
# qwen2-0.5b at full width (bf16, random weights from the seed): a
# BatchServer of LM_SLOTS slots answering LM_REQUESTS (prompt tokens,
# requests), LM_MAX_NEW new tokens each, twice; a decode loop of
# LM_PROFILE_STEPS steps profiled
LM_SEED = 14
LM_TOL = 1e-4
LM_ARCH = "qwen2-0.5b"
LM_SLOTS = 4
LM_REQUESTS = ((128, 4), (4096, 2))
LM_MAX_NEW = 32
LM_PROFILE_STEPS = 8
# bf16 prefill and decode against forward at the same positions, each
# through the same weights: the largest absolute logit difference allowed
LM_BF16_ATOL = 0.1


def lm_phase(dev, card) -> dict:
    """Phase 14: the LM scaffold's serving path on the card.  It reaches
    none of the 15 kernels: every count stays 0."""
    from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
    from repro_torch.models import api, smoke
    from repro_torch.serve.engine import BatchServer, Request
    t = phase(f"14 the LM serving path: the {len(ARCH_IDS)} smoke configs "
              f"on the card against the host; {LM_ARCH} at full width, a "
              f"{LM_SLOTS}-slot BatchServer, prompts "
              f"{[p for p, _ in LM_REQUESTS]}")
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, _ in COUNTERS.values()}
    for m, c in COUNTERS.values():
        setattr(mods[m], c, 0)

    smoke_err = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = smoke_config(arch)
        host = api.init(cfg, torch.Generator().manual_seed(LM_SEED + i),
                        device="cpu")
        want = smoke.pass_outputs(host, cfg, smoke.batch(cfg, LM_SEED, "cpu"))
        got = smoke.pass_outputs(api.to(host, dev), cfg,
                                 smoke.batch(cfg, LM_SEED, dev))
        smoke_err[arch] = smoke.assert_close(got, want, LM_TOL)
    print("lm smoke max_abs_err " + json.dumps(smoke_err), flush=True)

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if params["embed"].device != dev or params["embed"].dtype != \
            torch.bfloat16:
        raise AssertionError(f"{LM_ARCH}: params {params['embed'].dtype} on "
                             f"{params['embed'].device}")
    weight_bytes = api.param_bytes(params)
    rng = np.random.default_rng(LM_SEED)
    requests = []
    for plen, count in LM_REQUESTS:
        requests += [(len(requests), rng.integers(0, cfg.vocab_size, plen)
                      .tolist()) for _ in range(count)]
    max_len = max(p for p, _ in LM_REQUESTS) + LM_MAX_NEW

    def serve():
        srv = BatchServer(cfg, params, max_batch=LM_SLOTS, max_len=max_len)
        for rid, prompt in requests:
            srv.submit(Request(rid, prompt, LM_MAX_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv.run()
        torch.cuda.synchronize()
        return out, srv.stats, time.perf_counter() - t0

    allocated = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first, _, first_s = serve()
    out, stats, wall_s = serve()
    peak = torch.cuda.max_memory_allocated(dev)
    for rid, prompt in requests:
        if len(out[rid].tokens) != LM_MAX_NEW:
            raise AssertionError(f"request {rid}: {len(out[rid].tokens)} "
                                 f"tokens, not {LM_MAX_NEW}")
        if out[rid].tokens != first[rid].tokens:
            raise AssertionError(f"request {rid}: a second run gave other "
                                 f"tokens")
    waves = [dict(w, prefill_ms=w["prefill_s"] * 1e3,
                  decode_ms_per_step=w["decode_s"] * 1e3
                  / max(w["decode_steps"], 1)) for w in stats["wave_log"]]

    # prefill of all but the last token, then a decode of it, against the
    # forward at those positions (one prompt of each length)
    consistency = {}
    for plen, _ in LM_REQUESTS:
        prompt = next(p for _, p in requests if len(p) == plen)
        tokens = torch.tensor([prompt], dtype=torch.int32, device=dev)
        full, _ = api.forward(params, cfg, {"tokens": tokens})
        want_pre, want_dec = full[0, -2], full[0, -1]
        del full
        pre, cache = api.prefill(params, cfg, {"tokens": tokens[:, :-1]},
                                 plen)
        dec, cache = api.decode(params, cfg, cache, tokens[:, -1:], plen - 1)
        errs = {"prefill": float((pre[0, 0] - want_pre).abs().max()),
                "decode": float((dec[0, 0] - want_dec).abs().max())}
        same = {"prefill": bool(pre[0, 0].argmax() == want_pre.argmax()),
                "decode": bool(dec[0, 0].argmax() == want_dec.argmax())}
        consistency[plen] = {"max_abs_err": errs, "argmax_agrees": same,
                             "max_abs_logit": float(want_dec.abs().max())}
        del cache
        if max(errs.values()) > LM_BF16_ATOL:
            raise AssertionError(f"{LM_ARCH} prompt {plen}: prefill/decode "
                                 f"vs forward {errs} over {LM_BF16_ATOL}")

    # the decode loop alone: LM_PROFILE_STEPS steps on the first bucket's
    # wave, timed, then profiled
    plen = LM_REQUESTS[0][0]
    prompts = [p for _, p in requests if len(p) == plen][:LM_SLOTS]
    tokens = torch.tensor(prompts, dtype=torch.int32, device=dev)
    _, cache = api.prefill(params, cfg, {"tokens": tokens},
                           plen + 2 * LM_PROFILE_STEPS)
    step_tok = tokens[:, -1:]

    def loop(start):
        for i in range(LM_PROFILE_STEPS):
            api.decode(params, cfg, cache, step_tok, start + i)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(plen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
    prof = profiled(lambda: loop(plen + LM_PROFILE_STEPS))
    kv_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    busy_ms = prof["busy_ms"] / LM_PROFILE_STEPS
    row = {"arch": LM_ARCH, "card": card,
           "params": sum(x.numel() for _, x in smoke.leaves(params)),
              "weight_GB": weight_bytes / 1e9, "init_s": init_s,
           "requests": len(requests), "max_new": LM_MAX_NEW,
           "slots": LM_SLOTS, "waves": waves,
           "first_run_s": first_s, "run_s": wall_s,
           "tokens_per_s": stats["tokens"] / wall_s,
           "peak_allocated_GB": peak / 1e9,
           "peak_over_before_GB": (peak - allocated) / 1e9,
           "decode_loop_ms_per_step": step_ms,
           "decode_device_busy_ms_per_step": busy_ms,
           "decode_launches_per_step": prof["launches"] / LM_PROFILE_STEPS,
           "decode_busy_share": busy_ms / step_ms,
           "decode_busy_share_profiled": prof["busy_share"],
           "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "decode_cache_MB": kv_bytes / 1e6,
           "decode_kernels": prof["kernels"],
           "consistency": consistency}
    row["decode_over_bound"] = step_ms / row["decode_bound_ms"]
    print("lm serve " + json.dumps(row), flush=True)
    launched = {fn: getattr(mods[m], c) for fn, (m, c) in COUNTERS.items()}
    if any(launched.values()):
        raise AssertionError(f"the LM path launched kernels: {launched}")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase14_s {time.perf_counter() - t:.3f}", flush=True)
    return row


# phase 15: the LM training path.  The 10 smoke configs in float32 from
# one seed, card against host within the CPU tests' tolerance; then
# TRAIN_ARCH at full width (its published config: bf16 params, remat),
# fed by a TokenPipeline of TRAIN_BATCH x TRAIN_SEQ tokens: TRAIN_WARM +
# TRAIN_TIMED steps on the stream, FIT_STEPS on one fixed batch, an async
# checkpoint during a step
TRAIN_SEED = 15
TRAIN_TOL = 1e-4
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_WARM, TRAIN_TIMED = 2, 8
FIT_STEPS = 8
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16, published peak


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits, as integers of its width."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def train_phase(dev, card, kernels) -> dict:
    """Phase 15: the LM scaffold's training path on the card.  Its one
    kernel is ``select_scan`` (the pipeline's quality filter), launched
    once a batch; every other count stays 0."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops, ref, select_scan
    from repro_torch.models import api, smoke
    from repro_torch.models.api import leaves, tree_map
    from repro_torch.train.optim import (AdamWConfig, adamw_update,
                                         init_opt_state)
    from repro_torch.train.step import loss_and_grads, make_train_step
    t = phase(f"15 the LM training path: the {len(ARCH_IDS)} smoke configs "
              f"on the card against the host; {TRAIN_ARCH} at full width, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step from a "
              f"TokenPipeline, a fixed batch, an async checkpoint")
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, _ in COUNTERS.values()}

    smoke_err = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = smoke_config(arch)
        host = api.init(cfg, torch.Generator().manual_seed(TRAIN_SEED + i),
                        device="cpu")
        want = smoke.train_outputs(host, cfg,
                                   smoke.batch(cfg, TRAIN_SEED, "cpu"))
        if smoke.least_move(host, want) <= 5 * TRAIN_TOL:
            raise AssertionError(f"{arch}: the host's step left a param "
                                 f"within the tolerance of its start")
        got = smoke.train_outputs(api.to(host, dev), cfg,
                                  smoke.batch(cfg, TRAIN_SEED, dev))
        smoke_err[arch] = smoke.assert_close(got, want, TRAIN_TOL)
    print("train smoke max_abs_err " + json.dumps(smoke_err), flush=True)

    cfg = get_config(TRAIN_ARCH)
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED))
    opt = init_opt_state(params)
    if params["embed"].dtype != torch.bfloat16 or \
            opt["master"]["embed"].dtype != torch.float32 or \
            opt["m"]["embed"].dtype != torch.float32 or not cfg.remat:
        raise AssertionError(f"{TRAIN_ARCH}: not its published training "
                             f"dtypes")
    n_params = sum(p.numel() for _, p in leaves(params))
    data = DataConfig(seed=TRAIN_SEED, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    pipe = TokenPipeline(cfg, data)
    step_fn = make_train_step(cfg)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ

    # the stream: every count 0 just before, read just after; each
    # batch_at's select_scan outputs kept to be held to the plain version
    calls = []
    real_select = ops.select_scan

    def recorded(*args, **kw):
        out = real_select(*args, **kw)
        calls.append((args, out))
        return out

    losses, per_batch = [], []
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for m, c in COUNTERS.values():
        setattr(mods[m], c, 0)
    ops.select_scan = recorded
    try:
        for step in range(TRAIN_WARM + TRAIN_TIMED):
            if step == TRAIN_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = select_scan.LAUNCHES
            batch = pipe.batch_at(step)
            per_batch.append(select_scan.LAUNCHES - before)
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    finally:
        ops.select_scan = real_select
    launched = {fn: getattr(mods[m], c) for fn, (m, c) in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if per_batch != [1] * len(per_batch) or \
            launched["select_scan"] != len(per_batch) or \
            any(v for fn, v in launched.items() if fn != "select_scan"):
        raise AssertionError(f"the training stream launched {launched}, "
                             f"{per_batch} select_scan a batch")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{TRAIN_ARCH}: losses {losses}")
    filter_err = 0
    for step, ((scores, ids, lo, hi), (kept, count)) in enumerate(calls):
        want_kept, want_count = ref.select_scan(scores, ids, lo, hi)
        if not (torch.equal(kept, want_kept) and
                int(count) == int(want_count) and count.dtype == torch.int64
                and scores.device == dev and scores.shape == (
                    TRAIN_BATCH * data.pool_factor,)):
            raise AssertionError(f"batch {step}: select_scan's "
                                 f"({kept.tolist()}, {int(count)}) against "
                                 f"the plain ({want_kept.tolist()}, "
                                 f"{int(want_count)})")
        docs, _, _ = pipe.draw(step)
        idx = want_kept[torch.arange(TRAIN_BATCH, device=dev)
                        % torch.clamp(want_count, min=1)]
        want_tokens = torch.from_numpy(docs).to(dev)[idx.long()]
        if not torch.equal(pipe.batch_at(step)["tokens"], want_tokens):
            raise AssertionError(f"batch {step}: tokens not the plain "
                                 f"filter's")
    step_ms = stream_s * 1e3 / TRAIN_TIMED

    # one step profiled; the optimizer alone on the last step's gradients
    prof = profiled(lambda: step_fn(params, opt, batch))
    _, grads = loss_and_grads(params, cfg, batch)
    opt_cfg = AdamWConfig()
    adam_ms = event_ms(lambda: adamw_update(opt_cfg, params, grads, opt), 3)
    opt_bytes = sum(
        2 * p.numel() * p.element_size()                  # param r + w
        + grads_of.numel() * grads_of.element_size()      # grad r
        + 2 * sum(leaf.numel() * leaf.element_size()      # master, m, v
                  for leaf in (mast, mm, vv))
        for (_, p), (_, grads_of), (_, mast), (_, mm), (_, vv) in zip(
            leaves(params), leaves(grads), leaves(opt["master"]),
            leaves(opt["m"]), leaves(opt["v"])))
    del grads

    # a fixed batch: the loss must fall
    fit = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                           weight_decay=0.0))
    opt = init_opt_state(params)
    fixed = pipe.batch_at(0)
    fit_losses = []
    for _ in range(FIT_STEPS):
        params, opt, metrics = fit(params, opt, fixed)
        fit_losses.append(metrics["loss"])
    fit_losses = [float(x) for x in fit_losses]
    if not all(np.isfinite(fit_losses)) or \
            not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"{TRAIN_ARCH} on a fixed batch: losses "
                             f"{fit_losses}")

    # an async checkpoint while the next step runs, restored on the card
    tree = {"params": params, "opt": opt}
    snapshot = tree_map(torch.clone, tree)
    ckpt_bytes = api.param_bytes(tree)
    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        mgr = CheckpointManager(tmp, async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(FIT_STEPS, tree)
        snapshot_s = time.perf_counter() - t0
        fit(params, opt, fixed)
        torch.cuda.synchronize()
        step_done_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        template = tree_map(torch.empty_like, tree)
        t0 = time.perf_counter()
        got = mgr.restore(FIT_STEPS, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for (path, g), (_, w) in zip(leaves(got), leaves(snapshot)):
            if g.device != dev or g.dtype != w.dtype or \
                    not torch.equal(bits(g), bits(w)):
                raise AssertionError(f"checkpoint {'/'.join(path)}: not "
                                     f"the snapshot's bits")
        if torch.equal(bits(params["embed"]),
                       bits(snapshot["params"]["embed"])):
            raise AssertionError("the step during the save changed nothing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del got, template, snapshot

    flop_bound_ms = 6 * n_params * tokens_a_step / BF16_FLOPS_PER_S * 1e3
    row = {"arch": TRAIN_ARCH, "card": card, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
           "steps_timed": TRAIN_TIMED, "step_ms": step_ms,
           "tokens_per_s": tokens_a_step / step_ms * 1e3,
           "losses": losses, "fit_losses": fit_losses,
           "select_scan_a_batch": per_batch,
           "peak_allocated_GB": peak / 1e9,
           "peak_over_before_GB": (peak - allocated) / 1e9,
           "allocated_before_GB": allocated / 1e9,
           "step_device_busy_ms": prof["busy_ms"],
           "step_busy_share": prof["busy_ms"] / step_ms,
           "step_busy_share_profiled": prof["busy_share"],
           "step_launches": prof["launches"],
           "step_kernels": prof["kernels"],
           "flop_bound_ms": flop_bound_ms,
           "step_over_flop_bound": step_ms / flop_bound_ms,
           "adamw_ms": adam_ms,
           "adamw_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
           "adamw_GB": opt_bytes / 1e9,
           "checkpoint_GB": ckpt_bytes / 1e9,
           "checkpoint_snapshot_s": snapshot_s,
           "checkpoint_step_during_save_s": step_done_s,
           "checkpoint_save_s": save_s,
           "checkpoint_restore_s": restore_s}
    print("lm train " + json.dumps(row), flush=True)
    for entry in kernels:
        if entry["name"].split(".")[-1] == "select_scan":
            entry["launches_train"] = launched["select_scan"]
    del params, opt, tree, batch, fixed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase15_s {time.perf_counter() - t:.3f}", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    return morsel_phase(**resident_phases())


if __name__ == "__main__":
    sys.exit(main())
