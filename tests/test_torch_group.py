"""The port's compiled group verifier (zkevm_specs_tpu_torch.runtime.jit) on
the ADD and MUL groups at 64 lanes, replayed on the CPU, against the JAX
package: the same trace (signature, constraint count, bounds, hint
stream, witness arrays), all-pass fail bits, a corrupted lane caught at
that lane only in both packages, and the port's replay fed the JAX
package's own inputs.  Constructing the JAX verifier runs only its numpy
trace; nothing here compiles with XLA."""
import numpy as np
import pytest
import torch

import __graft_entry__
from zkevm_specs_tpu.evm import Block as JBlock
from zkevm_specs_tpu.evm import Bytecode as JBytecode
from zkevm_specs_tpu.evm import ExecutionState as JES
from zkevm_specs_tpu.evm import RWDictionary as JRWDictionary
from zkevm_specs_tpu.evm import StepState as JStepState
from zkevm_specs_tpu.evm import Tables as JTables
from zkevm_specs_tpu.evm.main import _run_group as j_run_group
from zkevm_specs_tpu.evm.main import verify_steps as j_verify_steps
from zkevm_specs_tpu.runtime.jit import CompiledGroupVerifier as JVerifier
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
from zkevm_specs_tpu_torch.evm.main import _run_group as p_run_group
from zkevm_specs_tpu_torch.evm.main import verify_steps as p_verify_steps
from zkevm_specs_tpu_torch.runtime.convert import inputs_from_numpy
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier
from zkevm_specs_tpu_torch.workloads import (
    build_add_workload, build_mul_workload, random_word_pairs)

torch.set_num_threads(1)

N = 64
CORRUPT = 5


_OPS = {"ADD": (JES.ADD, 3, lambda a, b: (a + b) % 2**256),
        "MUL": (JES.MUL, 5, lambda a, b: (a * b) % 2**256)}


def _jax_workload(op, n, corrupt_lane=None):
    """The JAX package's group on the port's operand words
    (tests/test_jit_runner.py:build_binop_batch with seeded words)."""
    jstate, gas, result_of = _OPS[op]
    bytecode = getattr(JBytecode(), op.lower())(1, 2).stop()
    h = bytecode.hash()
    rw = JRWDictionary(9)
    steps, nexts = [], []
    rwc = 9
    for i, (a, b) in enumerate(random_word_pairs(n)):
        c = result_of(a, b)
        if i == corrupt_lane:
            c = (c + 1) % 2**256
        rw.stack_read(1, 1022, a).stack_read(1, 1023, b).stack_write(1, 1023, c)
        steps.append(JStepState(jstate, rwc, call_id=1, is_root=True, code_hash=h,
                                program_counter=66, stack_pointer=1022, gas_left=gas))
        nexts.append(JStepState(JES.STOP, rwc + 3, call_id=1, is_root=True, code_hash=h,
                                program_counter=67, stack_pointer=1023, gas_left=0))
        rwc += 3
    tables = JTables(block_table=JBlock().table_assignments(),
                     bytecode_table=bytecode.table_assignments(), rw_table=rw.rws)
    return tables, steps, nexts


GROUPS = {
    "ADD": (ExecutionState.ADD, build_add_workload),
    "MUL": (ExecutionState.MUL, build_mul_workload),
}


@pytest.fixture(scope="module", params=sorted(GROUPS))
def group(request):
    name = request.param
    state, build = GROUPS[name]
    jstate = _OPS[name][0]
    tables, steps, nexts = build(N)
    # ADD: the JAX package's flagship builder itself, so the port's words
    # are shown to be the JAX entry point's
    jtables, jsteps, jnexts = (__graft_entry__._build_add_workload(N) if name == "ADD"
                               else _jax_workload(name, N))
    port = CompiledGroupVerifier(tables, state, steps, nexts, device="cpu")
    jax = JVerifier(jtables, jstate, jsteps, jnexts)
    return dict(name=name, port=port, jax=jax, steps=steps, nexts=nexts,
                jsteps=jsteps, jnexts=jnexts, state=state, jstate=jstate, build=build)


def test_trace_matches_jax(group):
    port, jax = group["port"], group["jax"]
    assert port.signature == jax.signature
    assert port.n_constraints == jax.n_constraints
    assert port.hint_bits == jax.hint_bits
    assert port.curr_bits == jax.curr_bits
    assert port.next_bits == jax.next_bits
    assert {k: v["n_rows"] for k, v in port.meta.items()} == \
        {k: v["n_rows"] for k, v in jax.meta.items()}
    assert {k: v["bits"] for k, v in port.meta.items()} == \
        {k: v["bits"] for k, v in jax.meta.items()}


def test_hint_stream_and_witness_arrays_match_jax(group):
    p_curr, p_next, p_tree, p_hints = group["port"]._built_inputs[2]
    j_curr, j_next, j_tree, j_hints = group["jax"]._built_inputs[2]
    assert len(p_hints) == len(j_hints) == group["port"].n_hints
    for ph, jh in zip(p_hints, j_hints):
        assert ph.keys() == jh.keys()
        for k in ph:
            np.testing.assert_array_equal(np.asarray(ph[k]), np.asarray(jh[k]))
    for p, j in ((p_curr, j_curr), (p_next, j_next)):
        assert p.keys() == j.keys()
        for k in p:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]).astype(np.int64))
    for name in ("rw", "bytecode", "block"):
        for cname, parts in p_tree[name]["cols"].items():
            for part, arr in parts.items():
                np.testing.assert_array_equal(
                    arr.numpy(), np.asarray(j_tree[name]["cols"][cname][part]).astype(np.int64))


def test_replay_passes_every_lane(group):
    port = group["port"]
    fail = port(*port.prepare_inputs(group["steps"], group["nexts"]))
    assert fail.dtype == torch.bool and fail.shape == (N,) and fail.device.type == "cpu"
    assert not fail.any()


def test_replay_on_the_jax_inputs(group):
    """The JAX verifier's prepare_inputs output, carried over by
    inputs_from_numpy, replays on the port's trace with the same verdict."""
    jax = group["jax"]
    inputs = inputs_from_numpy(*jax.prepare_inputs(group["jsteps"], group["jnexts"]), "cpu")
    assert not group["port"](*inputs).any()


def test_corrupt_lane_fails_alone_in_both_packages(group):
    tables, steps, nexts = group["build"](N, corrupt_lane=CORRUPT)
    port = CompiledGroupVerifier(tables, group["state"], steps, nexts, device="cpu")
    fail = port(*port.prepare_inputs(steps, nexts)).numpy()
    assert np.flatnonzero(fail).tolist() == [CORRUPT]

    # the eager spec runs (verify_steps' group evaluation) over the chain
    # step_0, next_0, step_1, next_1, ... with one pair per lane
    jtables, jsteps, jnexts = _jax_workload(group["name"], N, corrupt_lane=CORRUPT)
    for run_group, t, s, nx, st in ((j_run_group, jtables, jsteps, jnexts, group["jstate"]),
                                    (p_run_group, tables, steps, nexts, group["state"])):
        chain = [x for pair in zip(s, nx) for x in pair]
        failures = {}
        run_group(t, chain, st, False, False, list(range(0, 2 * N, 2)), [], failures)
        assert sorted(failures) == [2 * CORRUPT]

    # verify_steps itself on single-lane chains: the corrupted lane raises
    for verify, s, nx in ((j_verify_steps, jsteps, jnexts), (p_verify_steps, steps, nexts)):
        tables_of = jtables if verify is j_verify_steps else tables
        verify(tables_of, [s[CORRUPT - 1], nx[CORRUPT - 1]])
        with pytest.raises(AssertionError):
            verify(tables_of, [s[CORRUPT], nx[CORRUPT]])

    # and the port's replay fed the JAX inputs agrees
    jax = JVerifier(jtables, group["jstate"], jsteps, jnexts)
    jfail = port(*inputs_from_numpy(*jax.prepare_inputs(jsteps, jnexts), "cpu")).numpy()
    assert np.flatnonzero(jfail).tolist() == [CORRUPT]


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    tables, steps, nexts = build_add_workload(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledGroupVerifier(tables, ExecutionState.ADD, steps, nexts)
