"""The port's flow, context, account, copy and log gadgets
(zkevm_specs_tpu_torch.evm.execution: stack_family, jump, jumpi, gas,
msize, context, balance, extcode, calldataload, copy_family, log) against
the JAX package, on the CPU, tolerance 0.

Every vector of tests/evm/test_stack_family.py, of test_flow_family.py's
JUMP, JUMPI, GAS and MSIZE tests, of test_context_family.py, of
test_copy_log_exp_extcode.py's EXTCODESIZE, EXTCODEHASH, CODECOPY,
EXTCODECOPY, RETURNDATACOPY and LOG tests (the matrices, the reverted log
and the static-context rejection included) and of
test_calldatacopy_sweep.py runs as that file's own test body, with the
module's ``Tables`` and ``verify_steps`` intercepted: the witness the body
builds (its table rows and steps) goes through the JAX ``_run_group`` and,
as the same rows and steps in the port's classes, through the port's
``_run_group``, in spec mode.  The failure dicts must be equal key for key
and message for message (``test_torch_arith.check_both``'s first check);
then the body's own expectation (``success``, or the ``pytest.raises`` it
wraps) is applied to them as ``verify_steps`` applies it.

The replay: for the first vector of each execution state, the port's
``CompiledGroupVerifier`` on the CPU replays the vector's lane eight times
over and fails exactly the lanes spec mode fails, and every host hint loop
(CALLDATALOAD's ``BufferReaderGadget``) runs once a replay, not once a
lane."""
import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "evm"))

from zkevm_specs_tpu.evm import main as jmain  # noqa: E402
from zkevm_specs_tpu_torch.evm import main as pmain  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.evm.instruction import Instruction  # noqa: E402
from zkevm_specs_tpu_torch.evm.step import StepState  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.tables.container import Tables  # noqa: E402

import test_calldatacopy_sweep  # noqa: E402
import test_context_family  # noqa: E402
import test_copy_log_exp_extcode  # noqa: E402
import test_flow_family  # noqa: E402
import test_stack_family  # noqa: E402

torch.set_num_threads(1)

STEP_FIELDS = ("rw_counter", "call_id", "is_root", "is_create", "code_hash", "program_counter",
               "stack_pointer", "gas_left", "memory_word_size", "reversible_write_counter",
               "log_id")
REPLAY_LANES = 8

# (module, the test functions whose vectors the port's gadgets get)
SOURCES = (
    (test_stack_family, None),
    (test_flow_family, ("test_jump", "test_jump_to_non_jumpdest_rejected", "test_jumpi",
                        "test_gas_opcode", "test_msize")),
    (test_context_family, None),
    (test_copy_log_exp_extcode, ("test_extcodesize", "test_extcodehash", "test_codecopy",
                                 "test_extcodecopy", "test_returndatacopy",
                                 "test_returndatacopy_out_of_bound_rejected", "test_log",
                                 "test_extcodecopy_matrix", "test_returndatacopy_matrix",
                                 "test_log_reverted", "test_log_static_context_rejected")),
    (test_calldatacopy_sweep, None),
)


def _cases(sources=SOURCES):
    """(id, module, function, kwargs) for every parametrised case of
    ``sources``."""
    out = []
    for module, names in sources:
        names = names or sorted(n for n in vars(module) if n.startswith("test_"))
        for name in names:
            fn = getattr(module, name)
            grids = []
            for mark in getattr(fn, "pytestmark", []):
                if mark.name != "parametrize":
                    continue
                argnames, values = mark.args[:2]
                argnames = [a.strip() for a in (argnames.split(",") if isinstance(argnames, str)
                                                else argnames)]
                grids.append([dict(zip(argnames, v if len(argnames) > 1 else (v,)))
                              for v in values])
            for k, combo in enumerate(itertools.product(*grids)):
                kwargs = {key: val for part in combo for key, val in part.items()}
                out.append((f"{module.__name__}.{name}[{k}]", module, fn, kwargs))
    return out


CASES = _cases()


class _Recorded:
    """The JAX ``Tables`` a test body builds, with the rows it was given."""

    def __init__(self, jax_tables_cls):
        self.cls = jax_tables_cls

    def __call__(self, **rows):
        tables = self.cls(**rows)
        tables.recorded_rows = rows
        return tables


def port_steps(steps):
    return [StepState(ExecutionState[s.execution_state.name], aux_data=s.aux_data,
                      **{f: getattr(s, f) for f in STEP_FIELDS}) for s in steps]


def failures_of(main, tables, steps, begin=False, end=False):
    """``verify_steps``'s failure dict (its grouping by state and the first-
    and last-step flags), before its success check."""
    steps = list(steps)
    if end:
        steps.append(main.DUMMY_STEP_STATE)
    n = len(steps) - 1
    groups = {}
    for i in range(n):
        groups.setdefault((steps[i].execution_state, begin and i == 0, end and i == n - 1),
                          []).append(i)
    out = {}
    for (state, first, last), idxs in groups.items():
        main._run_group(tables, steps, state, first, last, idxs, [], out)
    return out


def run_case(module, fn, kwargs, monkeypatch, also=()):
    """Run the test body with both packages' spec runs behind its
    ``verify_steps`` (and that of each module of ``also``: a body built by
    another file's helper); returns the calls' (port tables, port steps,
    failures)."""
    calls = []

    def verify_steps(tables, steps, begin_with_first_step=False, end_with_last_step=False,
                     success=True):
        flags = (begin_with_first_step, end_with_last_step)
        want = failures_of(jmain, tables, steps, *flags)
        ptables = Tables(**tables.recorded_rows)
        psteps = port_steps(steps)
        assert failures_of(pmain, ptables, psteps, *flags) == want
        calls.append((ptables, psteps, want))
        if success:
            if want:
                first = min(want)
                raise AssertionError(f"step {first}: {want[first]}")
        else:
            assert want, "expected verification to fail, but all steps passed"

    for m in (module, *also):
        monkeypatch.setattr(m, "Tables", _Recorded(m.Tables))
        monkeypatch.setattr(m, "verify_steps", verify_steps)
    fn(**kwargs)
    assert calls, "the test body verified nothing"
    return calls


def replay_fails(ptables, psteps, lanes=REPLAY_LANES):
    """The failing lanes of a vector's first step pair, its lane ``lanes``
    times over, replayed by the port's ``CompiledGroupVerifier`` on the CPU."""
    curr, nxt = [psteps[0]] * lanes, [psteps[1]] * lanes
    v = CompiledGroupVerifier(ptables, psteps[0].execution_state, curr, nxt, device="cpu")
    return torch.nonzero(v(*v.prepare_inputs(curr, nxt))).flatten().tolist()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gadget_vectors_match_jax(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    run_case(module, fn, kwargs, monkeypatch)


# the first vector of each new execution state
REPLAYED = [
    ("DUP", "test_stack_family.test_dup[0]"), ("JUMPDEST", "test_stack_family.test_jumpdest[0]"),
    ("PC", "test_stack_family.test_pc[0]"), ("SWAP", "test_stack_family.test_swap[0]"),
    ("JUMP", "test_flow_family.test_jump[0]"), ("JUMPI", "test_flow_family.test_jumpi[0]"),
    ("GAS", "test_flow_family.test_gas_opcode[0]"), ("MSIZE", "test_flow_family.test_msize[0]"),
    ("ADDRESS", "test_context_family.test_address[0]"),
    ("BALANCE", "test_context_family.test_balance[0]"),
    ("BlockCtx", "test_context_family.test_blockctx[0]"),
    ("BLOCKHASH", "test_context_family.test_blockhash[0]"),
    ("CALLDATALOAD", "test_context_family.test_calldataload[0]"),
    ("CALLDATASIZE", "test_context_family.test_calldatasize[0]"),
    ("CALLER", "test_context_family.test_caller[0]"),
    ("CALLVALUE", "test_context_family.test_callvalue[0]"),
    ("CODESIZE", "test_context_family.test_codesize[0]"),
    ("GASPRICE", "test_context_family.test_gasprice[0]"),
    ("ORIGIN", "test_context_family.test_origin[0]"),
    ("RETURNDATASIZE", "test_context_family.test_returndatasize[0]"),
    ("SELFBALANCE", "test_context_family.test_selfbalance[0]"),
    ("EXTCODESIZE", "test_copy_log_exp_extcode.test_extcodesize[0]"),
    ("EXTCODEHASH", "test_copy_log_exp_extcode.test_extcodehash[0]"),
    ("CODECOPY", "test_copy_log_exp_extcode.test_codecopy[0]"),
    ("EXTCODECOPY", "test_copy_log_exp_extcode.test_extcodecopy[0]"),
    ("RETURNDATACOPY", "test_copy_log_exp_extcode.test_returndatacopy[0]"),
    ("LOG", "test_copy_log_exp_extcode.test_log[0]"),
    ("CALLDATACOPY", "test_calldatacopy_sweep.test_calldatacopy_sweep[0]"),
]


def test_replay_covers_every_new_state():
    assert {c[0] for c in CASES} >= {case for _, case in REPLAYED}
    assert {s for s, _ in REPLAYED} == {
        "DUP", "SWAP", "PC", "JUMPDEST", "JUMP", "JUMPI", "GAS", "MSIZE", "ADDRESS", "CALLER",
        "CALLVALUE", "CALLDATASIZE", "RETURNDATASIZE", "CODESIZE", "ORIGIN", "GASPRICE",
        "SELFBALANCE", "BlockCtx", "BLOCKHASH", "BALANCE", "CALLDATALOAD", "EXTCODESIZE",
        "EXTCODEHASH", "CODECOPY", "EXTCODECOPY", "RETURNDATACOPY", "LOG", "CALLDATACOPY"}


@pytest.mark.parametrize("state,case", REPLAYED)
def test_replay_matches_spec_and_runs_the_hint_loop_once(state, case, monkeypatch):
    """The vector's lane, eight times over, replayed by the port's
    ``CompiledGroupVerifier``: the lanes spec mode fails, and the gadget's
    host hint loops run once in the replay (one placeholder, not a list of
    lanes) where the eager trace gave them one int a lane."""
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    (ptables, psteps, want), = [c for c in run_case(module, fn, kwargs, monkeypatch)
                                if c[1][0].execution_state.name == state][:1]
    monkeypatch.undo()
    lengths = []
    ints_of = Instruction.ints_of

    def record(self, v):
        out = ints_of(self, v)
        lengths.append((self.ctx.mode, len(out)))
        return out

    monkeypatch.setattr(Instruction, "ints_of", record)
    curr, nxt = [psteps[0]] * REPLAY_LANES, [psteps[1]] * REPLAY_LANES
    v = CompiledGroupVerifier(ptables, psteps[0].execution_state, curr, nxt, device="cpu")
    traced = [n for mode, n in lengths if mode == "eager"]
    lengths.clear()
    fail = v(*v.prepare_inputs(curr, nxt))
    assert torch.nonzero(fail).flatten().tolist() == (list(range(REPLAY_LANES)) if want else [])
    assert set(lengths) <= {("replay", 1)}
    assert set(traced) <= {REPLAY_LANES}
    if state == "CALLDATALOAD":
        assert traced and lengths
