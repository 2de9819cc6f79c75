"""The paper's bandwidth-saturation cost models (§4, §5.3), parameterized
by hardware.

The port of ``repro.cost.model``, the formulas unchanged, so the port and
the reference give the same predictions on the same ``Hardware``.  Two
kinds of entries:

  * PAPER_CPU / PAPER_GPU — the paper's Table 2 (i7-6900 / V100); used to
    check the paper's own claims (16.2x bandwidth ratio for
    select/project/sort, sub-ratio joins, >ratio full queries, coprocessor
    non-viability) — see tests/test_torch_cost.py;
  * H100 — the port's card: its geometry and published rates, from
    NVIDIA's data sheet.  ``repro_torch.sql.calibrate`` replaces the rates
    with ones measured on the card.

All times in seconds, sizes in bytes, N = row count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Hardware:
    name: str
    read_bw: float           # B/s from device memory
    write_bw: float
    cache_bw: float          # last on-chip cache (GPU L2 / CPU L3)
    cache_size: float        # bytes
    line_bytes: int          # random-access granule from device memory
    mem_capacity: float
    interconnect_bw: Optional[float] = None  # the host link (PCIe)
    # per-dispatch overhead of one kernel launch (host->device submit +
    # executable lookup).  0 for the paper's pure-bandwidth targets; the
    # measured value (repro_torch.sql.calibrate) is what prices a
    # partition-at-a-time loop's O(2^bits) dispatches against the fused
    # single-launch probe.
    launch_overhead_s: float = 0.0
    # measured per-partition byte budget for the partitioned join's
    # radix depth (the reference's tuner sweeps part_bits and expresses
    # the winner as the budget that reproduces it; the port has no tuner
    # yet).  None -> the static model default
    # (repro_torch.sql.model.PART_BUDGET_BYTES / cache_size).
    part_budget_bytes: Optional[float] = None

    @property
    def interconnect_gbps(self) -> Optional[float]:
        """``interconnect_bw`` in GB/s — the unit the scale-out reports
        and the cost-model docs quote; None when unmeasured."""
        if self.interconnect_bw is None:
            return None
        return self.interconnect_bw / 1e9


# Table 2 of the paper
PAPER_CPU = Hardware("i7-6900", 53e9, 55e9, 157e9, 20e6, 64, 64e9)
PAPER_GPU = Hardware("V100", 880e9, 880e9, 2.2e12, 6e6, 128, 32e9,
                     interconnect_bw=12.8e9)
# The port's card, NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core
# GPU data sheet: 3.35 TB/s HBM3, 80 GB, 50 MB L2, 32-byte L2 sectors (the
# random-access granule), PCIe Gen5 x16 at 128 GB/s both ways (64 GB/s
# host to device: the link a morsel crosses).  The data sheet gives no L2
# rate: the static entry assumes the paper's V100 ratio of L2 to memory
# rate (PAPER_GPU: 2.2 TB/s over 880 GB/s), and no launch overhead.
# Calibration on the card (repro_torch.sql.calibrate) measures all four.
H100 = Hardware("H100-SXM5-80GB", 3.35e12, 3.35e12,
                3.35e12 * (PAPER_GPU.cache_bw / PAPER_GPU.read_bw), 50e6, 32,
                80e9, interconnect_bw=64e9)

BANDWIDTH_RATIO_PAPER = PAPER_GPU.read_bw / PAPER_CPU.read_bw  # ~16.6 (16.2 in-text)


# ---------------------------------------------------------------------------
# §4.1 project
# ---------------------------------------------------------------------------


def project_time(n: int, hw: Hardware, n_in_cols: int = 2,
                 n_out_cols: int = 1, width: int = 4) -> float:
    return (n_in_cols * width * n / hw.read_bw
            + n_out_cols * width * n / hw.write_bw)


# ---------------------------------------------------------------------------
# §4.2 select
# ---------------------------------------------------------------------------


def select_time(n: int, selectivity: float, hw: Hardware,
                width: int = 4) -> float:
    return (width * n / hw.read_bw
            + width * selectivity * n / hw.write_bw)


# ---------------------------------------------------------------------------
# §4.3 hash join probe  (no-partitioning join, linear probing)
# ---------------------------------------------------------------------------


def join_probe_time(n_probe: int, ht_bytes: float, hw: Hardware,
                    width: int = 4, l2_size: Optional[float] = None,
                    l2_bw: Optional[float] = None) -> float:
    """Two-level version of the paper's model: if the table fits the
    on-chip cache, probes run at cache bandwidth; else every probe reads a
    full memory line, with pi = P(line cached)."""
    scan = 2 * width * n_probe / hw.read_bw
    if ht_bytes <= hw.cache_size:
        probe = n_probe * hw.line_bytes / hw.cache_bw
        return max(scan, probe)
    pi = hw.cache_size / ht_bytes
    probe = (1 - pi) * n_probe * hw.line_bytes / hw.read_bw
    return scan + probe


def join_build_time(n_build: int, hw: Hardware, width: int = 4) -> float:
    return 2 * width * n_build / hw.read_bw \
        + 2 * width * n_build / hw.write_bw


# ---------------------------------------------------------------------------
# §4.4 radix sort
# ---------------------------------------------------------------------------


def radix_pass_time(n: int, hw: Hardware, width: int = 4) -> float:
    hist = width * n / hw.read_bw
    shuffle = 2 * width * n / hw.read_bw + 2 * width * n / hw.write_bw
    return hist + shuffle


def sort_time(n: int, hw: Hardware, key_bits: int = 32,
              bits_per_pass: int = 8) -> float:
    passes = -(-key_bits // bits_per_pass)
    return passes * radix_pass_time(n, hw)


# ---------------------------------------------------------------------------
# morsel-streamed scan (out-of-core pipeline)
# ---------------------------------------------------------------------------


def morsel_pipeline_time(n_bytes: float, n_morsels: int, hw: Hardware,
                         launches_per_morsel: int = 1) -> float:
    """Time of one streamed pass executed as ``n_morsels`` double-
    buffered stages: the host→device copy of morsel i+1 overlaps the
    compute on morsel i, so the steady state runs at
    ``max(per_copy, per_comp)`` per stage, with one un-overlapped copy
    at the head and one un-overlapped compute at the tail, plus
    ``launches_per_morsel`` dispatches per stage.

    ``per_copy`` prices the encoded morsel crossing the interconnect
    (0 when ``hw.interconnect_bw`` is None — host execution has no
    copy); ``per_comp`` is the bandwidth-bound scan of the same bytes.
    At ``n_morsels <= 1`` this reduces exactly to
    ``n_bytes / read_bw + launches * launch_overhead_s`` — the
    pre-morsel single-pass formula, with NO copy term: a single-morsel
    stream is the resident in-memory case, whose one-time upload is
    amortized across queries rather than paid per scan.  Only a
    multi-morsel stream re-crosses the interconnect every pass; its
    extra cost is the head copy, the (n-1) extra dispatch sets, and
    whichever of copy/compute does NOT hide behind the other."""
    n = max(1, int(n_morsels))
    launch = n * launches_per_morsel * hw.launch_overhead_s
    if n == 1 or not hw.interconnect_bw:
        return n_bytes / hw.read_bw + launch
    per_comp = n_bytes / hw.read_bw / n
    per_copy = n_bytes / hw.interconnect_bw / n
    return (per_copy + (n - 1) * max(per_copy, per_comp) + per_comp
            + launch)


# ---------------------------------------------------------------------------
# §3.1 coprocessor model + §5.3 full-query model (q2.1)
# ---------------------------------------------------------------------------


def coprocessor_time(n_bytes: float, hw: Hardware = PAPER_GPU) -> float:
    """Lower bound for the coprocessor model: everything crosses PCIe."""
    assert hw.interconnect_bw
    return n_bytes / hw.interconnect_bw


def q1_time(n_lo: int, hw: Hardware, width: int = 4) -> float:
    """Q1.x: single pass over 4 fact columns (upper bound, paper §3.1)."""
    return 4 * width * n_lo / hw.read_bw


def q21_time(n_lo: int, n_supp: int, n_date: int, part_ht_bytes: float,
             hw: Hardware, sigma1: float = 1 / 5, sigma2: float = 1 / 25,
             width: int = 4) -> float:
    """§5.3 three-term model for SSB q2.1.

    r1: fact-column access (later columns skip unselected cache lines)
    r2: hash-table probes (supplier+date cached; part has cache-miss term)
    r3: result read+write (negligible group count)
    """
    c, br, bw = hw.line_bytes, hw.read_bw, hw.write_bw
    lines = width * n_lo / c
    r1 = (lines
          + min(lines, n_lo * sigma1)
          + 2 * min(lines, n_lo * sigma1 * sigma2)) * (c / br)
    cache_avail = hw.cache_size - 2 * width * (n_supp + n_date)
    pi = min(1.0, max(0.0, cache_avail / part_ht_bytes))
    r2 = (2 * n_supp + 2 * n_date
          + (1 - pi) * n_lo * sigma1) * (c / br)
    groups = n_lo * sigma1 * sigma2
    r3 = groups * c / br + groups * c / bw
    return r1 + r2 + r3


# ---------------------------------------------------------------------------
# derived paper-claim checks (consumed by tests + EXPERIMENTS.md)
# ---------------------------------------------------------------------------


def paper_claims() -> dict:
    n = 1 << 29
    sf20 = 120_000_000
    out = {}
    out["bandwidth_ratio"] = BANDWIDTH_RATIO_PAPER
    out["project_speedup"] = (project_time(n, PAPER_CPU)
                              / project_time(n, PAPER_GPU))
    out["select_speedup"] = (select_time(n, 0.5, PAPER_CPU)
                             / select_time(n, 0.5, PAPER_GPU))
    out["sort_speedup"] = (sort_time(1 << 28, PAPER_CPU)
                           / sort_time(1 << 28, PAPER_GPU))
    # join with 1GB hash table (both caches miss; GPU reads 2x line size)
    out["join_1gb_speedup"] = (
        join_probe_time(256_000_000, 1e9, PAPER_CPU)
        / join_probe_time(256_000_000, 1e9, PAPER_GPU))
    # q2.1 predictions (paper: GPU model 3.7ms vs measured 3.86ms)
    out["q21_gpu_model_ms"] = q21_time(
        sf20, 8_000, 2_556, 8e6, PAPER_GPU) * 1e3
    out["q21_cpu_model_ms"] = q21_time(
        sf20, 8_000, 2_556, 8e6, PAPER_CPU) * 1e3
    # coprocessor: 4 int columns of SF20 must cross PCIe; CPU scans instead
    bytes_q11 = 4 * 4 * sf20
    out["coprocessor_q1_ms"] = coprocessor_time(bytes_q11) * 1e3
    out["cpu_q1_ms"] = q1_time(sf20, PAPER_CPU) * 1e3
    out["coprocessor_loses"] = out["coprocessor_q1_ms"] > out["cpu_q1_ms"]
    return out
