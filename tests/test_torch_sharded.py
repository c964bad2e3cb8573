"""The port's checks over ranks (zkevm_specs_tpu_torch.parallel: shard,
logup_shard's multi-rank form, block_shard) on the CPU, at world sizes 1,
2, 3 and 4: one ``torch.multiprocessing`` spawn of gloo ranks a world size
for the whole module, each rank running every case of
tests/torch_shard_cases.py and sending back its results.

Every rank must return the same verdicts, and they must equal the port's
single-device verdicts and the JAX package's spec-mode verdicts (no XLA
compile), key for key, on the cases of tests/test_sharding.py (a clean
group, a failing lane on a remote share, a hinted gadget, a clean state
circuit, a violation at a share boundary caught through the halo),
tests/test_logup_sharded.py (rw and bytecode true, a corrupted table part
on a rank other than 0 false, a bad multiplicity false) and
tests/test_sharded_block.py (a clean block; step, copy, exp and withdrawal
failures attributed; a state row edited; the 2 x 2 grid at world size
4).  The mesh's group and its join both have a time limit, so a hang fails
the test instead of taking the run's clock."""
import pickle
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_shard_cases as cases  # noqa: E402
from zkevm_specs_tpu.circuits import state as jst  # noqa: E402
from zkevm_specs_tpu.dsl.value import Ctx as JCtx  # noqa: E402
from zkevm_specs_tpu.tables import schemas as js  # noqa: E402
from zkevm_specs_tpu.tables.engine import Table as JTable  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch.circuits.state import make_state_check_fn, pack_state_inputs  # noqa: E402
from zkevm_specs_tpu_torch.parallel.logup_shard import (  # noqa: E402
    multiplicities, sharded_logup_check)
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.runtime.convert import to_device  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

from test_torch_block import JaxSide  # noqa: E402

torch.set_num_threads(1)

WORLDS = (1, 2, 3, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out_dir: Path):
    return mp.start_processes(cases.run_rank, args=(world, _free_port(), str(out_dir)),
                              nprocs=world, join=False, start_method="spawn")


def _join(world: int, ctx, out_dir: Path, deadline: float) -> list:
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world size {world}: the ranks did not finish in {cases.TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks, all spawned at once, and this process's
    single-device and JAX verdicts meanwhile; each group joined with a time
    limit."""
    dirs = {world: tmp_path_factory.mktemp(f"world{world}") for world in WORLDS}
    started = {world: _spawn(world, dirs[world]) for world in WORLDS}
    deadline = time.monotonic() + cases.TIMEOUT_S
    try:
        single = _single()
    finally:
        ranks = {world: _join(world, ctx, dirs[world], deadline) for world, ctx in started.items()}
    return ranks, single


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _jax_state_fails(rows, mpt):
    ctx = JCtx(np, len(rows), "eager")
    return np.asarray(jst.check_state_rows(ctx, jst.StateRows(ctx, rows),
                                           JTable.from_rows(ctx, js.MPT_SCHEMA, mpt)).fail)


def _port_state_fails(rows, mpt):
    cols, tree, meta = pack_state_inputs(rows, mpt)
    return make_state_check_fn(meta, device="cpu")(*to_device((cols, tree), "cpu")).numpy()


def _single():
    """The port's single-device verdicts and the JAX spec-mode verdicts of
    every case."""
    out = {}
    for name, (v, steps, nexts) in cases.group_cases().items():
        out[("group", name)] = v(*v.prepare_inputs(steps, nexts)).numpy()
    for bad in (False, True):
        rows, mpt = cases.state_rows(cases.STATE_ROWS, bad)
        out[("state", bad)] = _port_state_fails(rows, mpt)
        out[("jax_state", bad)] = _jax_state_fails(rows, mpt)
    for corrupt in (False, True):
        bv = CompiledBlockVerifier(cases.block_witness(PT, PY, corrupt), device="cpu")
        out[("block", corrupt)] = bv.run_device(bv.prepare())
        with pytest.MonkeyPatch.context() as mp_:
            jax_side = JaxSide(cases.block_witness(JT, JY, corrupt), mp_)
        out[("jax_block", corrupt)] = jax_side.failures()
        out[("circuits", corrupt)] = [n for n, _ in bv.circuit_kernels]
        if not corrupt:
            out[("lookups", corrupt)] = bv.verify_lookups(tables_names=cases.LOGUP_FAMILIES)
            for world in WORLDS:
                out[("corrupt_part", world)] = bv.verify_lookups(
                    tables_names=("rw",), corrupt_table=cases.corrupt_last_share(world))
            q_fps, en, parts, counts = cases.logup_inputs(bv)
            out["logup_clean"] = sharded_logup_check(q_fps, en, parts,
                                                     multiplicities(counts, "cpu"), 0xA1FA,
                                                     device="cpu")
            counts[int(np.flatnonzero(counts)[0])] += 1
            out["logup_bad_multiplicity"] = sharded_logup_check(
                q_fps, en, parts, multiplicities(counts, "cpu"), 0xA1FA, device="cpu")
            out["bv"] = bv
            out["jax_state_rows"] = jax_side.bv._state_rows, jax_side.bv._state_mpt
    return out


def _same_on_every_rank(results):
    def canon(v):
        if isinstance(v, np.ndarray):
            return ("array", v.dtype.str, v.tolist())
        if isinstance(v, dict):
            return {k: canon(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(canon(x) for x in v)
        return v

    first = canon(results[0])
    for r, res in enumerate(results[1:], 1):
        assert canon(res) == first, f"rank {r} differs from rank 0"
    return results[0]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_verdicts(ranks, world):
    assert len(ranks[world]) == world
    _same_on_every_rank(ranks[world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["add_ok", "add_remote_lane", "div_hinted"])
def test_sharded_group_matches_single_device(ranks, single, world, name):
    got = ranks[world][0][("group", name)]
    np.testing.assert_array_equal(got, single[("group", name)])
    assert got.shape == (cases.GROUP_LANES,)
    if name == "add_remote_lane":
        assert np.flatnonzero(got).tolist() == [cases.CORRUPT_LANE]
    else:
        assert not got.any()
    if name == "div_hinted":
        assert ranks[world][0][("group_hints", name)] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bad", [False, True])
def test_sharded_state_circuit_matches_single_device_and_jax(ranks, single, world, bad):
    got = ranks[world][0][("state", bad)]
    np.testing.assert_array_equal(got, single[("state", bad)])
    np.testing.assert_array_equal(got, single[("jax_state", bad)])
    assert got.any() == bad
    if bad:
        # the swapped rows 7 | 8: at world size 2 the boundary of the shares
        assert set(np.flatnonzero(got).tolist()) & {7, 8, 9}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_sharded_block_matches_single_device_and_jax(ranks, single, world, corrupt):
    got = ranks[world][0][("block", corrupt)]
    assert got == single[("block", corrupt)] == single[("jax_block", corrupt)]
    assert set(ranks[world][0][("placement", corrupt)]) == set(single[("circuits", corrupt)])
    if corrupt:
        names = {k[0] for k in got if isinstance(k, tuple)}
        assert any(isinstance(k, int) for k in got), "the ADD step's edit is not caught"
        assert {"copy", "exp"} <= names and names & {"pi", "withdrawal"}, names
    else:
        assert got == {}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_verify_messages(ranks, single, world, corrupt):
    """``verify``'s message, in the JAX format: steps, state rows, lookup
    families, then each circuit's rows."""
    msg = ranks[world][0][("message", corrupt)]
    if not corrupt:
        assert msg is None
        return
    fails = single[("block", True)]
    steps = sorted(k for k in fails if isinstance(k, int))
    parts = [f"steps {steps[:8]}"]
    for name in single[("circuits", True)]:
        rows = sorted(r for n, r in (k for k in fails if isinstance(k, tuple)) if n == name)
        if rows:
            parts.append(f"{name} rows {rows[:8]}")
    assert msg == "sharded block verification failed: " + "; ".join(parts)
    assert ranks[world][0][("lookups", True)] == {}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_row_edit_matches_single_device_and_jax(ranks, single, world):
    mid, got = ranks[world][0]["state_row_edit"]
    bv = single["bv"]
    rows = [dict(r) for r in bv._state_rows]
    rows[mid]["value"] += 1
    want = _port_state_fails(rows, bv._state_mpt)
    jrows, jmpt = single["jax_state_rows"]
    jrows = [dict(r) for r in jrows]
    jrows[mid]["value"] += 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_state_fails(jrows, jmpt))
    assert got.any()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_logup_families(ranks, single, world):
    res = ranks[world][0]
    assert res[("lookups", False)] == single[("lookups", False)] == {"rw": True, "bytecode": True}
    assert res["lookups_corrupt_part"] == {"rw": False}
    assert single[("corrupt_part", world)] == {"rw": False}
    assert res["logup_bad_multiplicity"] is False


def test_single_device_bad_multiplicity(single):
    assert single["logup_clean"] is True
    assert single["logup_bad_multiplicity"] is False


def test_grid_2x2(ranks, single):
    res = ranks[4][0]
    want = single[("block", True)]
    assert want == single[("jax_block", True)]
    assert res["grid_steps"] == {k: v for k, v in want.items() if isinstance(k, int)}
    assert res["grid_steps"]
    assert {("state", int(r)) for r in np.flatnonzero(res["grid_state"])} == {
        k for k in want if isinstance(k, tuple) and k[0] == "state"}
    assert res["grid_lookups"] == {"rw": True}
