"""The gaps that decide ``correct``, and the judgement against the limits.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's (not the norm of their difference), measured
against the reference's norm of that leaf or of the median leaf, whichever
is larger, since some gradients are all but zero; the worst leaf is the
number.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def relative_gap(program: float, reference: float) -> float:
    return abs(program - reference) / max(abs(reference), 1e-30)


def leaf_gap(program: Dict[str, float], reference: Dict[str, float]) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    if not reference:
        return float("nan")
    med = float(np.median(list(reference.values())))
    return max(abs(program[k] - r) / max(r, med, 1e-30) for k, r in reference.items())


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, List[str]]:
    """(correct, one line per number with its limit). Every limited number
    must be present, finite and at most its limit."""
    ok, lines = True, []
    for name, spec in limits.items():
        value = numbers.get(name, float("nan"))
        limit = float(spec["limit"])
        good = math.isfinite(value) and value <= limit
        ok &= good
        lines.append(f"{name} {value:.6g} limit {limit:.6g} {'ok' if good else 'FAILED'}")
    return ok, lines


def compared(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Dict[str, Dict]:
    """The result line's last key: each number with its limit."""
    return {name: {"value": numbers.get(name, float("nan")), "limit": float(spec["limit"])}
            for name, spec in limits.items()}
