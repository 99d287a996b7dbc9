"""The yardstick's arithmetic: the card's peaks, the bytes and operations a
kernel launch needs, roofline shares, the union of device intervals and the
idle gaps between them.

The peaks are NVIDIA's data-sheet figures, dense and without sparsity, at
the full power limit: H100 SXM 3.35 TB/s of HBM and 67 TFLOP/s in float32
outside the tensor cores; H100 PCIe 2.0 TB/s and 51 TFLOP/s. The port
computes in float32 with TF32 off, so float32 is the peak its model
operations are held to.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def card_rates(name: str) -> Tuple[float, float]:
    """(bytes/s, float32 FLOP/s) of the card named ``name``."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def bound_s(nbytes: float, ops: float, rates: Tuple[float, float]) -> float:
    """The least time a launch could take: its bytes at the memory peak or
    its operations at the compute peak, whichever is longer."""
    return max(nbytes / rates[0], ops / rates[1])


# Each distinct input row is read once and each output written once, plus the
# ids and, for the gather-sum, its task table (start int64, length and
# destination int32).


def gather_rows_cost(distinct_rows: int, k: int, d: int, elem: int, id_elem: int):
    """(bytes, operations) of one row gather of ``k`` ids into (K, d)."""
    return distinct_rows * d * elem + k * id_elem + k * d * elem, 0.0


def gather_sum_cost(distinct_rows: int, valid_slots: int, slots: int, tasks: int,
                    out_rows: int, d: int, elem: int):
    """(bytes, operations) of one gather-sum: the distinct rows read, the
    int32 slot ids and the task table read, the float32 sums written, one
    addition per valid slot and column."""
    nbytes = distinct_rows * d * elem + slots * 4 + tasks * 16 + out_rows * d * 4
    return nbytes, float(valid_slots) * d


def adagrad_cost(valid_rows: int, k: int, d: int, elem: int, id_elem: int):
    """(bytes, operations) of one row-sparse Adagrad launch: gradients,
    state and values read, state and values written for every valid row,
    and the ids; seven operations per element."""
    return 5 * valid_rows * d * elem + k * id_elem, 7.0 * valid_rows * d


def roofline_share(launches: Iterable[Tuple[float, float, float]],
                   rates: Tuple[float, float]):
    """Percent of the roofline over ``launches`` of (bytes, ops, seconds):
    the sum of their least times over the sum of their device times; None
    when there is no launch."""
    least = took = 0.0
    for nbytes, ops, seconds in launches:
        least += bound_s(nbytes, ops, rates)
        took += seconds
    if took <= 0.0:
        return None
    return 100.0 * least / took


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The idle (start, end) stretches of [lo, hi] outside the disjoint,
    sorted ``busy`` intervals."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
