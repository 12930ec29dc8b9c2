"""The dispatch's loop condition set by the cycle, ``--profile``'s window,
the copies' refusal under a trace and ``check``'s device, on the CPU.

  * ``cycle_cond_plain`` (`ops/dispatch.py`, what a fused cycle under a
    graph's while node does to the state and the condition) equals the
    JAX ``loop_fns`` ``cond`` (`tpu_tree_search/engine/resident.py:421`)
    over states made from a seed, and counts the body's run; the plain
    dispatch loop leaves the words K plain cycles leave, its runs its
    cycles, and the JAX dispatch's counts;
  * ``--profile`` caps K and stops at the first dispatch boundary past
    which the traced graph-body launches could pass the budget
    (`obs/phases.py` ``profile_k_cap``, ``profile_cut``), prints the cut,
    and the search's counts hold;
  * ``--profile`` of a mesh whose device list puts two copies of a shard on
    one card is refused by ``check_supported`` (`parallel/resident_mesh.py`
    ``shared_card_copies``, from the position strings);
  * ``check`` runs on the card unless asked for the CPU: without a card it
    exits 2 naming ``--device cpu``, and ``--update`` off the CPU exits 2.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tpu_tree_search_torch import cli
from tpu_tree_search_torch.analysis import program_audit
from tpu_tree_search_torch.engine.resident import (NQueensResident,
                                                   pool_from_numpy)
from tpu_tree_search_torch.obs import phases
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops import cycle_nqueens as CN
from tpu_tree_search_torch.ops import dispatch as D
from tpu_tree_search_torch.parallel.resident_mesh import shared_card_copies
from tpu_tree_search_torch.problems import NQueensProblem

INF = 2**31 - 1


# -- the loop condition set by the cycle ------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cycle_cond_plain_equals_the_jax_cond(seed):
    import jax.numpy as jnp

    from tpu_tree_search.engine.resident import _make_program
    from tpu_tree_search.problems import NQueensProblem as JaxNQueens

    N, m, M, K = 8, 5, 16, 6
    capacity = 4 * M * N
    cond, _ = _make_program(JaxNQueens(N), m, M, K, capacity,
                            None).loop_fns()
    rng = np.random.default_rng(seed)
    for _ in range(64):
        size = int(rng.integers(0, capacity + 1))
        cycles = int(rng.integers(0, K + 2))
        runs = int(rng.integers(0, K + 2))
        st = C.new_state(size, INF, "cpu")
        st[C.ST_CYCLES] = cycles
        st[C.ST_RUNS] = runs
        before = st.clone()
        want = bool(cond((None, None, jnp.int32(size), None, None, None,
                          jnp.int32(cycles))))
        assert D.cycle_cond_plain(st, m, M * N, capacity, K) is want
        assert D.loop_active(before.tolist(), m, M * N, capacity, K) is want
        # The body's run counted, no other word touched.
        before[C.ST_RUNS] += 1
        assert torch.equal(st, before)


def _frontier(N: int, target: int):
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = NQueensProblem(N)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, INF, target)
    return prob, pool.as_batch()


@pytest.mark.parametrize("K", [4, 1000])
def test_plain_dispatch_loop_words_after_k_cycles(K):
    """One plain dispatch (the CPU's ``step``) against K plain cycles on a
    copy, and against the JAX dispatch: every state word the cycles write
    equal, the runs the cycles; at K = 1000 the loop condition fails first,
    and no run follows the last cycle."""
    from tpu_tree_search.engine.resident import _make_program
    from tpu_tree_search.problems import NQueensProblem as JaxNQueens

    N, m, M = 8, 5, 16
    prob, fr = _frontier(N, M + 7)
    k = fr["board"].shape[0]
    capacity = 4 * M * N + 2 * k
    prog = NQueensResident(prob, m, M, K, capacity, "cpu")
    state = prog.init_state(fr, INF)
    ref = prog.init_state(fr, INF)
    prog.step(state)
    ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
    cycles = 0
    for _ in range(K):
        CN.cycle_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, N, 1, M,
                               m, K)
        if not int(ref.st[C.ST_ACTIVE]):
            break
        cycles += 1
    got = state.st.tolist()
    want = ref.st.tolist()
    # Every word the cycles write; the reference's last call, past the
    # condition, is a no-op that clears st[ST_ACTIVE] alone, where the
    # dispatch (as the graph) launches no cycle.
    assert [v for i, v in enumerate(got[:C.ST_RUNS]) if i != C.ST_ACTIVE] == [
        v for i, v in enumerate(want[:C.ST_RUNS]) if i != C.ST_ACTIVE]
    assert got[C.ST_ACTIVE] == 1 and want[C.ST_ACTIVE] == int(cycles == K)
    assert got[C.ST_CYCLES] == cycles == got[C.ST_RUNS] > 0
    assert (cycles == K) is (K == 4)
    size = got[C.ST_SIZE]
    assert torch.equal(state.pool_vals[:size], ref.pool_vals[:size])
    assert torch.equal(state.pool_aux[:size], ref.pool_aux[:size])
    # The JAX dispatch of the same K.
    jprog = _make_program(JaxNQueens(N), m, M, K, capacity, None)
    out = jprog.step(jprog.init_state(
        {"board": fr["board"], "depth": fr["depth"].astype(np.int16)}, INF))
    assert (int(out[2]), int(out[4]), int(out[5]), int(out[6])) == (
        size, got[C.ST_TREE], got[C.ST_SOL], cycles)


def test_plain_dispatch_runs_restart_each_dispatch():
    """The runs are the graph init node's: zeroed at every dispatch."""
    N, m, M, K = 8, 5, 16, 3
    prob, fr = _frontier(N, M + 7)
    capacity = 4 * M * N + 2 * fr["board"].shape[0]
    prog = NQueensResident(prob, m, M, K, capacity, "cpu")
    state = pool_from_numpy(fr["board"], fr["depth"], fr["board"].shape[0],
                            INF, capacity, "cpu", prog.vals_dtype,
                            prog.aux_dtype)
    for _ in range(3):
        prog.step(state)
        assert int(state.st[C.ST_RUNS]) == int(state.st[C.ST_CYCLES]) == K


# -- --profile's window -----------------------------------------------------


@pytest.mark.parametrize("launches,depth,budget,cap", [
    (250, 2, 200_000, 400), (3, 2, 200_000, 33_333), (121, 2, 3000, 12),
    (10**6, 2, 200_000, 1), (223, 1, 267_020, 1197)])
def test_profile_k_cap(launches, depth, budget, cap):
    assert phases.profile_k_cap(launches, depth, budget) == cap
    # The first read's dispatches in flight stay in the budget (a cap of 1
    # is the floor: one body alone may pass it).
    assert depth * cap * launches <= budget or cap == 1


@pytest.mark.parametrize("traced,ahead,budget,cut", [
    (100_000, 100_000, 200_000, False), (100_000, 100_001, 200_000, True),
    (0, 200_001, 200_000, True), (1452, 2904, 3000, True), (0, 0, 1, False)])
def test_profile_cut(traced, ahead, budget, cut):
    assert phases.profile_cut(traced, ahead, budget) is cut


def _run(argv, capsys):
    assert cli.main(argv + ["--json"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    window = [ln for ln in out.splitlines() if ln.startswith("Profile window")]
    return rec, window


def test_profile_cut_on_a_plain_search(tmp_path, capsys, monkeypatch):
    """A small budget: K capped, the trace stopped after the first
    dispatch, the rest untraced, the counts those of the whole search."""
    monkeypatch.setattr(phases, "PROFILE_BUDGET", 3000)
    rec, window = _run(["nqueens", "--N", "10", "--device", "cpu", "--M", "64",
                        "--unfused", "--profile", str(tmp_path)], capsys)
    assert (rec["explored_tree"], rec["explored_sol"]) == (35538, 724)
    assert rec["K"] < 4096 and rec["dispatches"] > 1
    assert len(window) == 1, window
    head = f"Profile window: dispatches 1..1 of {rec['dispatches']} traced, "
    assert window[0].startswith(head) and window[0].endswith("budget 3000")
    launches = int(window[0][len(head):].split()[0])
    assert 0 < launches <= 3000
    assert (tmp_path / "torch_profile.json").stat().st_size > 0
    assert phases.SessionTrace.active() is None


def test_profile_whole_search_within_budget(tmp_path, capsys):
    """The default budget holds a small search whole: every dispatch
    traced."""
    rec, window = _run(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                        "--profile", str(tmp_path)], capsys)
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    n = rec["dispatches"]
    assert window and window[0].startswith(
        f"Profile window: dispatches 1..{n} of {n} traced, ")
    assert window[0].endswith(f"budget {phases.PROFILE_BUDGET}")


# -- the copies' refusal under a trace --------------------------------------


@pytest.mark.parametrize("positions,D,mp,shared", [
    (["cuda:0", "cuda:0"], 2, 2, [(0, "cuda:0"), (1, "cuda:0")]),
    (["cuda", "cuda:0"], 1, 2, [(0, "cuda:0")]),
    (["cuda:0"] * 4, 2, 2, [(0, "cuda:0"), (1, "cuda:0")]),
    (["cuda:0", "cuda:1"], 2, 2, []),
    (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], 2, 2, []),
    (["cuda:0", "cuda:0"], 2, 1, []),
    (["cpu", "cpu"], 2, 2, [])])
def test_shared_card_copies(positions, D, mp, shared):
    assert shared_card_copies(positions, D, mp) == shared


def _supported(argv):
    args = cli.build_parser().parse_args(argv)
    cli.check_supported(args)


MESH_LB2 = ["pfsp", "--inst", "14", "--lb", "lb2", "--tier", "mesh", "--D", "2"]


def test_profile_of_copies_on_one_card_is_refused(tmp_path):
    with pytest.raises(ValueError, match="two copies on cuda:0"):
        _supported(MESH_LB2 + ["--mp", "2", "--device", "cuda:0,cuda:0",
                               "--profile", str(tmp_path)])
    # Distinct cards, one position a shard (mp = 1), or no trace: accepted.
    _supported(MESH_LB2 + ["--mp", "2", "--device", "cuda:0,cuda:1",
                           "--profile", str(tmp_path)])
    _supported(MESH_LB2 + ["--device", "cuda:0,cuda:0", "--profile",
                           str(tmp_path)])
    _supported(MESH_LB2 + ["--mp", "2", "--device", "cuda:0,cuda:0"])


def test_profile_of_copies_exits_2(tmp_path, capsys):
    rc = cli.main(MESH_LB2 + ["--mp", "2", "--device", "cuda:0,cuda:0",
                              "--profile", str(tmp_path)])
    assert rc == 2
    assert "torch.profiler" in capsys.readouterr().err


# -- check on the card unless asked for the CPU -------------------------------


def test_check_without_a_card_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check", "--family", "nqueens", "--no-locks"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        program_audit.run_check(families=["nqueens"], with_locks=False)


def test_check_update_needs_the_cpu(capsys, monkeypatch):
    from tpu_tree_search_torch.ops import backend

    monkeypatch.setattr(backend, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    assert cli.main(["check", "--update"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(ValueError, match="--device cpu"):
        program_audit.run_check(update=True, device="cuda")
