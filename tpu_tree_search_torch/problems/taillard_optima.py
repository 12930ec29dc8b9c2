"""Committed best-known makespans for the bundled Taillard PFSP instances
(the port's copy of `tpu_tree_search/problems/taillard_optima.py`).

Primal-gap computation (``obs/quality.py``, ``tts report``) needs a
*reference* value per instance: the anytime-search literature reports
quality as the gap to the best known solution, not as raw makespans
(Berthold's primal-integral framing, arXiv:2012.09511 §5 uses the same
convention for B&B@Grid). This table commits that reference separately
from ``problems/pfsp/taillard.py`` so a drive-by edit of the engine's
initial-UB table cannot silently move the goalposts of every historical
quality curve — ``tests/test_torch_obs_host.py`` cross-checks the two, and
this table against the JAX package's.

Provenance: E. Taillard, "Benchmarks for basic scheduling problems"
(EJOR 64, 1993), per the summary table shipped with the reference kit's
``c_taillard.c:31-43`` (the same values the engine uses for ``ub=1``
warm starts). For the 20- and 50-job classes these are proven optima;
for the largest classes (100x20 upward) they are best-known upper
bounds — either way they are the fixed reference a gap is quoted
against. Instances built from an ad-hoc ``p_times`` matrix have no
entry, and every helper here degrades to ``None`` (gap unknown) rather
than guessing.
"""

from __future__ import annotations

#: Best-known makespan per 1-based Taillard instance id. Grouped by
#: instance class (jobs x machines), ten instances per class.
BEST_KNOWN: dict[int, int] = {
    # ta001-ta010 (20x5)
    1: 1278, 2: 1359, 3: 1081, 4: 1293, 5: 1235,
    6: 1195, 7: 1234, 8: 1206, 9: 1230, 10: 1108,
    # ta011-ta020 (20x10)
    11: 1582, 12: 1659, 13: 1496, 14: 1377, 15: 1419,
    16: 1397, 17: 1484, 18: 1538, 19: 1593, 20: 1591,
    # ta021-ta030 (20x20)
    21: 2297, 22: 2099, 23: 2326, 24: 2223, 25: 2291,
    26: 2226, 27: 2273, 28: 2200, 29: 2237, 30: 2178,
    # ta031-ta040 (50x5)
    31: 2724, 32: 2834, 33: 2621, 34: 2751, 35: 2863,
    36: 2829, 37: 2725, 38: 2683, 39: 2552, 40: 2782,
    # ta041-ta050 (50x10)
    41: 2991, 42: 2867, 43: 2839, 44: 3063, 45: 2976,
    46: 3006, 47: 3093, 48: 3037, 49: 2897, 50: 3065,
    # ta051-ta060 (50x20)
    51: 3846, 52: 3699, 53: 3640, 54: 3719, 55: 3610,
    56: 3679, 57: 3704, 58: 3691, 59: 3741, 60: 3755,
    # ta061-ta070 (100x5)
    61: 5493, 62: 5268, 63: 5175, 64: 5014, 65: 5250,
    66: 5135, 67: 5246, 68: 5094, 69: 5448, 70: 5322,
    # ta071-ta080 (100x10)
    71: 5770, 72: 5349, 73: 5676, 74: 5781, 75: 5467,
    76: 5303, 77: 5595, 78: 5617, 79: 5871, 80: 5845,
    # ta081-ta090 (100x20)
    81: 6173, 82: 6183, 83: 6252, 84: 6254, 85: 6285,
    86: 6331, 87: 6223, 88: 6372, 89: 6247, 90: 6404,
    # ta091-ta100 (200x10)
    91: 10862, 92: 10480, 93: 10922, 94: 10889, 95: 10524,
    96: 10329, 97: 10854, 98: 10730, 99: 10438, 100: 10675,
    # ta101-ta110 (200x20)
    101: 11158, 102: 11160, 103: 11281, 104: 11275, 105: 11259,
    106: 11176, 107: 11337, 108: 11301, 109: 11146, 110: 11284,
    # ta111-ta120 (500x20)
    111: 26040, 112: 26500, 113: 26371, 114: 26456, 115: 26334,
    116: 26469, 117: 26389, 118: 26560, 119: 26005, 120: 26457,
}


def known_optimum(inst) -> int | None:
    """Best-known makespan for a 1-based instance id; ``None`` when the
    instance is unknown (ad-hoc matrices, non-integer ids)."""
    if not isinstance(inst, int):
        return None
    return BEST_KNOWN.get(inst)


def optimum_for(problem) -> int | None:
    """Reference value for a problem object: PFSP instances resolve
    through their ``inst`` id; everything else (N-Queens — a counting
    problem with no objective — ad-hoc matrices) has no reference."""
    if getattr(problem, "name", None) != "pfsp":
        return None
    return known_optimum(getattr(problem, "inst", None))


def gap(best, optimum) -> float | None:
    """Relative primal gap ``(best - optimum) / optimum``; ``None`` when
    either side is unknown/unusable (no incumbent yet, unknown instance,
    non-positive reference)."""
    if best is None or optimum is None or optimum <= 0:
        return None
    from .base import INF_BOUND

    if best >= INF_BOUND:
        return None
    return (float(best) - float(optimum)) / float(optimum)
