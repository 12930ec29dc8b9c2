"""Taillard PFSP benchmark instances, generated deterministically.

Re-implementation of the instance generator used by the reference
(`baselines/pfsp/lib/c_taillard.c:5-112`, `lib/pfsp/Taillard.chpl:3-98`),
copied from the JAX package so the port stands alone: a Lehmer LCG seeded from the
published per-instance seed table yields integer processing times in [1, 99].
The LCG's uniform step divides in *single precision* (C: ``(float)seed /
(float)m``, `c_taillard.c:84`), which we replicate bit-exactly with
``np.float32`` so the generated instances match the reference byte for byte.

Processing-time layout is row-major by machine: ``ptm[machine, job]``
(`c_taillard.c:99-103`).
"""

from __future__ import annotations

import numpy as np

# Per-instance LCG seeds (ta001..ta120), `c_taillard.c:5-29` / `Taillard.chpl:3-27`.
TIME_SEEDS = (
    873654221, 379008056, 1866992158, 216771124, 495070989,
    402959317, 1369363414, 2021925980, 573109518, 88325120,
    587595453, 1401007982, 873136276, 268827376, 1634173168,
    691823909, 73807235, 1273398721, 2065119309, 1672900551,
    479340445, 268827376, 1958948863, 918272953, 555010963,
    2010851491, 1519833303, 1748670931, 1923497586, 1829909967,
    1328042058, 200382020, 496319842, 1203030903, 1730708564,
    450926852, 1303135678, 1273398721, 587288402, 248421594,
    1958948863, 575633267, 655816003, 1977864101, 93805469,
    1803345551, 49612559, 1899802599, 2013025619, 578962478,
    1539989115, 691823909, 655816003, 1315102446, 1949668355,
    1923497586, 1805594913, 1861070898, 715643788, 464843328,
    896678084, 1179439976, 1122278347, 416756875, 267829958,
    1835213917, 1328833962, 1418570761, 161033112, 304212574,
    1539989115, 655816003, 960914243, 1915696806, 2013025619,
    1168140026, 1923497586, 167698528, 1528387973, 993794175,
    450926852, 1462772409, 1021685265, 83696007, 508154254,
    1861070898, 26482542, 444956424, 2115448041, 118254244,
    471503978, 1215892992, 135346136, 1602504050, 160037322,
    551454346, 519485142, 383947510, 1968171878, 540872513,
    2013025619, 475051709, 914834335, 810642687, 1019331795,
    2056065863, 1342855162, 1325809384, 1988803007, 765656702,
    1368624604, 450181436, 1927888393, 1759567256, 606425239,
    19268348, 1298201670, 2041736264, 379756761, 28837162,
)

# Known optimal makespans (initial UB when ub=1), `c_taillard.c:31-43`.
OPTIMAL_MAKESPANS = (
    1278, 1359, 1081, 1293, 1235, 1195, 1234, 1206, 1230, 1108,            # 20x5
    1582, 1659, 1496, 1377, 1419, 1397, 1484, 1538, 1593, 1591,            # 20x10
    2297, 2099, 2326, 2223, 2291, 2226, 2273, 2200, 2237, 2178,            # 20x20
    2724, 2834, 2621, 2751, 2863, 2829, 2725, 2683, 2552, 2782,            # 50x5
    2991, 2867, 2839, 3063, 2976, 3006, 3093, 3037, 2897, 3065,            # 50x10
    3846, 3699, 3640, 3719, 3610, 3679, 3704, 3691, 3741, 3755,            # 50x20
    5493, 5268, 5175, 5014, 5250, 5135, 5246, 5094, 5448, 5322,            # 100x5
    5770, 5349, 5676, 5781, 5467, 5303, 5595, 5617, 5871, 5845,            # 100x10
    6173, 6183, 6252, 6254, 6285, 6331, 6223, 6372, 6247, 6404,            # 100x20
    10862, 10480, 10922, 10889, 10524, 10329, 10854, 10730, 10438, 10675,  # 200x10
    11158, 11160, 11281, 11275, 11259, 11176, 11337, 11301, 11146, 11284,  # 200x20
    26040, 26500, 26371, 26456, 26334, 26469, 26389, 26560, 26005, 26457,  # 500x20
)


def nb_jobs(inst: int) -> int:
    """Job count for instance id (1..120), `c_taillard.c:45-52`."""
    if inst > 110:
        return 500
    if inst > 90:
        return 200
    if inst > 60:
        return 100
    if inst > 30:
        return 50
    return 20


def nb_machines(inst: int) -> int:
    """Machine count for instance id (1..120), `c_taillard.c:54-68`."""
    if inst > 110:
        return 20
    if inst > 100:
        return 20
    if inst > 90:
        return 10
    if inst > 80:
        return 20
    if inst > 70:
        return 10
    if inst > 60:
        return 5
    if inst > 50:
        return 20
    if inst > 40:
        return 10
    if inst > 30:
        return 5
    if inst > 20:
        return 20
    if inst > 10:
        return 10
    return 5


def best_ub(inst: int) -> int:
    """Known optimal makespan (1-based instance id), `c_taillard.c:70-73`."""
    return OPTIMAL_MAKESPANS[inst - 1]


def _unif_step(seed: int) -> tuple[int, int]:
    """One LCG draw in [1, 99]; returns (new_seed, value). `c_taillard.c:75-87`.

    The 0..1 projection divides in float32 (then widens to float64 for the
    range scaling) — this ordering is load-bearing for bit parity.
    """
    m, a, b, c = 2147483647, 16807, 127773, 2836
    k = seed // b
    seed = a * (seed % b) - k * c
    if seed < 0:
        seed += m
    value_0_1 = np.float32(seed) / np.float32(m)
    return seed, 1 + int(float(value_0_1) * 99.0)


def processing_times(inst: int) -> np.ndarray:
    """Processing-time matrix ``(machines, jobs)`` int32 for ta<inst>.

    Row-major by machine, filled machine-major (`c_taillard.c:89-104`).
    """
    n = nb_jobs(inst)
    m = nb_machines(inst)
    seed = TIME_SEEDS[inst - 1]
    ptm = np.empty((m, n), dtype=np.int32)
    for i in range(m):
        for j in range(n):
            seed, v = _unif_step(seed)
            ptm[i, j] = v
    return ptm


def reduced_instance(inst: int, jobs: int, machines: int | None = None) -> np.ndarray:
    """A small synthetic instance: the top-left ``(machines, jobs)`` corner of
    ta<inst>'s processing-time matrix. Used by tests to keep B&B trees tiny
    while exercising the full bound machinery (SURVEY.md §4: 'reduced-job
    variants'). Not a reference instance — golden counts are self-anchored.
    """
    ptm = processing_times(inst)
    m = machines if machines is not None else ptm.shape[0]
    return np.ascontiguousarray(ptm[:m, :jobs])
