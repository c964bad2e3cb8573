"""The port's tracer (zkevm_specs_tpu_torch.witness.tracer, the ALU subset
with SIGNEXTEND, ADDMOD, MULMOD and EXP, memory, storage and SHA3) against
the JAX package's ``trace_block``, unsigned and signed, tolerance 0: every
field of every step (its ``aux_data`` too), every rw row, the tables'
rows, the exp and copy circuits' rows, the ecc circuit's ops and
capacities, the sig rows, the prologue's memory setups, the per-tx outcome
bookkeeping and, signed, the caller
addresses and every field of ``signed_txs`` are equal on the same
transactions (the default callers, one shared caller, calldata, an account
pinned to the pre-signing sender, a small SSTORE-mix block).  Also the
host witness classes it emits through (``Transaction``, ``Account``,
``RWDictionary``'s rows, the copy circuit's), the blocks' builders, the
error halts the tracer emits (a CREATE, a stack underflow, an invalid
opcode and the out-of-gas cases, each held against the JAX tracer and
verifier) and what it still refuses to trace (SELFDESTRUCT)."""
import dataclasses

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.tables import schemas as js
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.tables import schemas as ps
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

torch.set_num_threads(1)

STEP_FIELDS = ("rw_counter", "call_id", "is_root", "is_create", "code_hash", "program_counter",
               "stack_pointer", "gas_left", "memory_word_size", "reversible_write_counter",
               "log_id")


def txs_of(Y, n_txs=2, n_ops=6, shared_caller=False, ops=("add",)):
    """``n_txs`` calls, each running ``n_ops`` rounds of PUSH1 j, PUSH1 j+1,
    <op>, POP then STOP (tests/test_block_jit.py:15-26), built with the
    package ``Y``'s classes; each tx has its own caller unless
    ``shared_caller`` (then txs 2.. carry a stale nonce)."""
    txs = []
    for i in range(n_txs):
        bc = Y.Bytecode()
        for j in range(n_ops):
            op = ops[j % len(ops)]
            getattr(bc.push1(j).push1(j + 1), op)().pop()
        bc.stop()
        caller = 0xFE if shared_caller else 0xFE + 0x100 * i
        txs.append((Y.Transaction(id=i + 1, gas=100000, gas_price=int(2e9),
                                  caller_address=caller, callee_address=0xFF + i), bc))
    return txs


def plain(x):
    """A value with both packages' classes taken apart: a dataclass (the
    ``PrecompileAuxData`` of ecRecover's steps) as its field values, a
    tuple or list as a tuple, recursively."""
    if dataclasses.is_dataclass(x):
        return tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    return x


def ecc_ops(circuit):
    """An ecc circuit's capacities and ops as plain tuples (None: none)."""
    if circuit is None:
        return None
    return ((circuit.max_add_ops, circuit.max_mul_ops, circuit.max_pairing_ops),
            plain(circuit.add_ops), plain(circuit.mul_ops), plain(circuit.pairing_ops))


def assert_same_witness(jw, pw):
    assert len(jw.steps) == len(pw.steps)
    for i, (a, b) in enumerate(zip(jw.steps, pw.steps)):
        assert a.execution_state.name == b.execution_state.name, i
        for f in STEP_FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        assert plain(a.aux_data) == plain(b.aux_data), (i, "aux_data")
    assert ecc_ops(pw.ecc_circuit) == ecc_ops(jw.ecc_circuit)
    assert [r.table_row() for r in pw.sig_rows] == [r.table_row() for r in jw.sig_rows]
    assert [r.pub_key for r in pw.sig_rows] == [r.pub_key for r in jw.sig_rows]
    assert pw.memory_setups == jw.memory_setups
    assert pw.rw.rws == jw.rw.rws
    assert pw.tables_kwargs() == {k: v for k, v in jw.tables_kwargs().items()
                                  if k in pw.tables_kwargs()}
    assert pw.tx_success == jw.tx_success and pw.tx_rwceor == jw.tx_rwceor
    assert pw.tx_code_hashes == jw.tx_code_hashes
    assert [bytes(b.code) for b in pw.bytecodes] == [bytes(b.code) for b in jw.bytecodes]
    assert pw.block.table_assignments() == jw.block.table_assignments()
    assert pw.sha3_preimages == jw.sha3_preimages
    assert (pw.copy_circuit is None) == (jw.copy_circuit is None)
    if pw.copy_circuit is not None:
        assert pw.copy_circuit.rows == jw.copy_circuit.rows
    assert (pw.signed_txs is None) == (jw.signed_txs is None)
    if pw.signed_txs is not None:
        assert [tuple(t) for t in pw.signed_txs] == [tuple(t) for t in jw.signed_txs]


CASES = {
    "2x6": dict(),
    "1x3": dict(n_txs=1, n_ops=3),
    "3x5": dict(n_txs=3, n_ops=5),
    "shared_caller": dict(shared_caller=True),
    "arith": dict(n_ops=8, ops=("add", "sub", "mul", "div", "mod", "lt", "and_", "shl")),
    "empty": dict(n_txs=0),
    # the last eight ALU gadgets' opcodes (ISZERO and NOT leave one word each)
    "alu_gadgets": dict(n_ops=16, ops=("gt", "sgt", "eq", "slt", "iszero", "not", "or", "xor",
                                       "byte", "signextend", "sar", "and_", "lt", "shr")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_jax(case):
    kw = CASES[case]
    jw = JT.trace_block(JY.Block(base_fee=int(1e9)), txs_of(JY, **kw), sign=False)
    pw = PT.trace_block(PY.Block(base_fee=int(1e9)), txs_of(PY, **kw), sign=False)
    assert_same_witness(jw, pw)


@pytest.mark.parametrize("index,value", [
    (0, 0xFF), (0, 0x7F), (1, 0xFF80), (15, 0x80 << 120), (30, (1 << 255) - 1),
    (30, 1 << 247), (31, (1 << 256) - 2), (32, 1 << 255), (1 << 255, 0x1234),
])
def test_signextend_rows_match_jax(index, value):
    """The tracer's SIGNEXTEND (``op_signextend``): the step, its three
    stack rows and the pushed word equal the JAX tracer's, for indexes
    below, at and past 31 and both signs of the selected byte."""
    def trace(T, Y):
        bc = Y.Bytecode().signextend(index, value).pop().stop()
        tx = Y.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF)
        return T.trace_block(Y.Block(base_fee=int(1e9)), [(tx, bc)], sign=False)

    jw, pw = trace(JT, JY), trace(PT, PY)
    assert_same_witness(jw, pw)
    step = next(s for s in pw.steps if s.execution_state.name == "SIGNEXTEND")
    pushed = next(r for r in pw.rw.rws if r["rw_counter"] == step.rw_counter + 2)
    bit = 8 * index + 7
    want = value if index >= 31 else (
        value | ((1 << 256) - (1 << (bit + 1))) if (value >> bit) & 1
        else value & ((1 << (bit + 1)) - 1))
    assert pushed["value"] == want


def test_alu_block_builder_is_bench_mix_traced_unsigned():
    """``workloads.build_alu_block`` is ``bench.py:_alu_heavy_txs``'s
    bytecodes, gas and caller 0xFE under ``Block(base_fee=10**9,
    gas_limit=30*10**6)``, traced signed as bench.py traces it (each tx's
    caller becomes its own key's address)."""
    n_txs, n_ops = 3, 70           # j & 0xFF wraps nothing here; the codes are bench's
    jtxs = []
    for i, (ptx, pbc) in enumerate(workloads.alu_block_txs(n_txs, n_ops)):
        bc = JY.Bytecode()
        for j in range(n_ops):
            bc.push1(j & 0xFF).push1((j + 1) & 0xFF).add().pop()
        bc.stop()
        assert bytes(bc.code) == bytes(pbc.code)
        assert ptx.gas == 21000 + 11 * n_ops + 1000 and ptx.id == i + 1
        jtxs.append((JY.Transaction(id=ptx.id, gas=ptx.gas, gas_price=ptx.gas_price,
                                    caller_address=ptx.caller_address,
                                    callee_address=ptx.callee_address), bc))
    assert {t.caller_address for t, _ in jtxs} == {0xFE}
    jw = JT.trace_block(JY.Block(base_fee=10**9, gas_limit=30 * 10**6), jtxs)
    pw = workloads.build_alu_block(n_txs, n_ops)
    assert_same_witness(jw, pw)
    assert workloads.receipt_gas_used(pw) == n_txs * (21000 + 11 * n_ops) > 0
    assert [t.caller_address for t in pw.txs] == [PT.tx_sender_address(i + 1)
                                                  for i in range(n_txs)]


def _jax_txs(ptxs):
    """The JAX package's classes carrying the port's txs and codes."""
    return [(JY.Transaction(id=t.id, gas=t.gas, gas_price=t.gas_price,
                            caller_address=t.caller_address, callee_address=t.callee_address),
             JY.Bytecode(bytearray(bytes(bc.code)))) for t, bc in ptxs]


@pytest.mark.parametrize("n_txs,cycles,seed", [(2, 2, 0), (3, 1, 5)])
def test_arith_block_matches_jax(n_txs, cycles, seed):
    """``workloads.build_arith_block`` traced by both tracers: the same
    steps, rw rows and tables, and the same exp circuit row for row (one
    event per EXP, its identifier the EXP step's rw counter + 3)."""
    jw = JT.trace_block(JY.Block(base_fee=10**9, gas_limit=30 * 10**6),
                        _jax_txs(workloads.arith_block_txs(n_txs, cycles, seed)))
    pw = workloads.build_arith_block(n_txs, cycles, seed)
    assert_same_witness(jw, pw)
    assert pw.exp_circuit.rows == jw.exp_circuit.rows
    exps = [s for s in pw.steps if s.execution_state.name == "EXP"]
    assert len(exps) == n_txs * cycles
    assert {r["identifier"] for r in pw.exp_circuit.rows} == {s.rw_counter + 3 for s in exps}
    names = {s.execution_state.name for s in pw.steps}
    assert {"MUL", "SDIV_SMOD", "ADDMOD", "MULMOD", "EXP", "SHL_SHR"} <= names
    assert workloads.receipt_gas_used(pw) == n_txs * (21000 + workloads.ARITH_CYCLE_GAS * cycles)


def test_arith_block_size():
    """One cycle is 653 code bytes and 42 steps; 37 cycles fit under
    EIP-170's 24576-byte code limit."""
    (_, bc), = workloads.arith_block_txs(1, 1)
    assert len(bc.code) == 653 + 1
    (_, bc), = workloads.arith_block_txs(1, workloads.ARITH_BLOCK_CYCLES)
    assert len(bc.code) == 653 * 37 + 1 <= 24576 < 653 * 38 + 1
    w = workloads.build_arith_block(1, 1)
    assert len(w.steps) == 42 + 1 + 3          # the cycle, STOP, BeginTx, EndTx, EndBlock


def test_exp_without_an_event_leaves_no_exp_circuit():
    bc = PY.Bytecode().push1(1).push1(5).exp().pop().push1(0).push1(5).exp().pop().stop()
    tx = PY.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF)
    assert PT.trace_block(PY.Block(), [(tx, bc)], sign=False).exp_circuit is None


def assert_parity(code, gas, state=None):
    """The one-tx block of ``code(Y)`` (a Bytecode of the package ``Y``) with
    ``gas``, traced by both packages (equal witnesses) and verified by both
    (equal failure dicts, and none); ``state`` is a step the block must
    reach."""
    from test_torch_block_calls import verify_both

    def txs(Y):
        return [(Y.Transaction(id=1, gas=gas, caller_address=0xFE, callee_address=0xFF),
                 code(Y))]

    jw = JT.trace_block(JY.Block(), txs(JY), sign=False)
    pw = PT.trace_block(PY.Block(), txs(PY), sign=False)
    assert_same_witness(jw, pw)
    if state is not None:
        assert state in [s.execution_state.name for s in pw.steps]
    assert verify_both(jw, pw) == {}


def test_exp_out_of_gas_raises():
    """21000 + two PUSHes (6) leave 49 gas, under EXP's 50 for a 1-byte
    exponent: an ErrorOutOfGasEXP halt, traced and verified as the JAX
    package does."""
    assert_parity(lambda Y: Y.Bytecode().push1(3).push1(2).exp().stop(), 21000 + 6 + 49,
                  "ErrorOutOfGasEXP")


def test_signed_block_is_not_ported():
    """Signing is ported: the default ``sign=True`` gives the JAX signed
    witness, and ``sign=False`` still traces the callers as given."""
    jw = JT.trace_block(JY.Block(), txs_of(JY))
    pw = PT.trace_block(PY.Block(), txs_of(PY))
    assert_same_witness(jw, pw)
    assert len(pw.signed_txs) == 2
    unsigned = PT.trace_block(PY.Block(), txs_of(PY), sign=False)
    assert unsigned.signed_txs is None
    assert [t.caller_address for t in unsigned.txs] == [0xFE, 0x1FE]


@pytest.mark.parametrize("code,what", [
    (lambda Y: Y.Bytecode().push1(0).push1(0).push1(0).create(), "CREATE"),
    (lambda Y: Y.Bytecode().pop().stop(), "ErrorStack"),
    (lambda Y: Y.Bytecode(bytearray([0x0C])), "ErrorInvalidOpcode"),
])
def test_what_the_subset_does_not_trace_raises(code, what):
    """An empty-initcode CREATE, a POP on an empty stack and an invalid
    opcode, once refused, now traced and verified as the JAX package does."""
    assert_parity(code, 100000, what)


def test_selfdestruct_is_refused():
    """SELFDESTRUCT has no handler in either tracer: the port refuses it."""
    tx = PY.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF)
    with pytest.raises(NotImplementedError, match="SELFDESTRUCT"):
        PT.trace_block(PY.Block(), [(tx, PY.Bytecode().push1(0).selfdestruct())], sign=False)


def test_out_of_gas_raises():
    """A PUSH1 with 2 gas left: ErrorOutOfGasConstant, as in the JAX
    package."""
    assert_parity(lambda Y: Y.Bytecode().push1(1).stop(), 21000 + 2, "ErrorOutOfGasConstant")


# -- the host witness classes ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(id=3, nonce=7, gas=90000, gas_price=3, caller_address=0xAB, callee_address=None,
         value=10**18, call_data=bytes([0, 1, 0, 255, 7]), invalid_tx=1),
    dict(callee_address=0x1234, call_data=bytes(40), access_list="two"),
])
def test_transaction_rows_match_jax(kw):
    def build(Y):
        k = dict(kw)
        if k.get("access_list") == "two":
            k["access_list"] = [Y.AccessTuple(0x10, [1, 2, 3]), Y.AccessTuple(0x20, [])]
        return Y.Transaction(**k)

    jt, pt = build(JY), build(PY)
    assert pt.table_assignments() == jt.table_assignments()
    assert pt.call_data_gas_cost() == jt.call_data_gas_cost()
    assert pt.access_list_gas_cost() == jt.access_list_gas_cost()


def test_account_matches_jax():
    for kw in (dict(), dict(address=5, nonce=1), dict(balance=3),
               dict(code_ops=True)):
        def build(Y):
            k = dict(kw)
            if k.pop("code_ops", False):
                k["code"] = Y.Bytecode().push1(1).stop()
            return Y.Account(**k)

        ja, pa = build(JY), build(PY)
        assert pa.code_hash() == ja.code_hash() and pa.is_empty() == ja.is_empty()


def _rw_calls(Y, s):
    rw = Y.RWDictionary(9)
    CC, A, TR = s.CallContextFieldTag, s.AccountFieldTag, s.TxReceiptFieldTag
    rw.call_context_read(3, CC.TxId, 1).call_context_write(3, CC.IsSuccess, 1)
    rw.account_read(0xAB, A.CodeHash, 1 << 200).account_write(0xAB, A.Balance, 5, 9)
    rw.account_write(0xAB, A.Nonce, 1, 0, rw_counter_of_reversion=77)
    rw.tx_access_list_account_write(1, 0xAB, True, False)
    rw.tx_access_list_account_write(1, 0xAC, True, True, rw_counter_of_reversion=80)
    rw.tx_refund_read(1, 4).tx_receipt_read(1, TR.CumulativeGasUsed, 21000)
    rw.tx_receipt_write(2, TR.LogLength, 0).stack_write(3, 1023, 5).stack_read(3, 1023, 5)
    return rw.rws, rw.rw_counter


def test_rw_dictionary_rows_match_jax():
    assert _rw_calls(PY, ps) == _rw_calls(JY, js)


def test_block_witness_carries_nothing_unported():
    """The ALU block carries its signed txs and no ecc circuit or
    ecRecover sig rows (the unported precompiles' witnesses)."""
    w = workloads.build_alu_block(1, 2)
    assert len(w.signed_txs) == 1 and w.copy_circuit is None and w.exp_circuit is None
    assert w.ecc_circuit is None and w.sig_rows == [] and w.withdrawals == []
    assert np.array_equal([s.execution_state.name for s in w.steps[:2]], ["BeginTx", "PUSH"])


def test_prefunded_accounts_match_jax():
    """An account given to ``trace_block`` sets its caller's balance and
    nonce, and its code joins the bytecodes."""
    def trace(T, Y):
        bc = Y.Bytecode().push1(2).push1(3).add().pop().stop()
        tx = Y.Transaction(id=1, nonce=3, gas=100000, caller_address=0xFE, callee_address=0xFF)
        accounts = {0xFE: Y.Account(address=0xFE, nonce=3, balance=10**19),
                    0x77: Y.Account(address=0x77, code=Y.Bytecode().push1(9).stop())}
        return T.trace_block(Y.Block(base_fee=int(1e9)), [(tx, bc)], accounts=accounts,
                             sign=False)

    assert_same_witness(trace(JT, JY), trace(PT, PY))


# -- signed blocks and the storage subset -----------------------------------------------

def _sstore_txs(Y, n_txs=2):
    """``bench.py:_sstore_heavy_txs``'s pattern in the package ``Y``'s
    classes (``workloads.sstore_block_txs``)."""
    ptxs = workloads.sstore_block_txs(n_txs)
    return ptxs if Y is PY else _jax_txs(ptxs)


def _storage_memory_txs(Y):
    """MSTORE, MSTORE8, MLOAD across word boundaries, SSTORE over a
    prefilled slot (clear, dirty re-set, restore), warm and cold SLOADs and
    SHA3s of zero, one and several words."""
    bc = Y.Bytecode()
    bc.push32((1 << 256) - 5).push1(3).mstore().push1(0xAB).push1(40).mstore8()
    bc.push1(31).mload().pop().push2(0x200).mload().pop()
    bc.push1(0).push1(7).sstore().push1(9).push1(8).sstore().push1(0).push1(8).sstore()
    bc.push1(5).push1(8).sstore().push1(7).sload().pop().push1(99).sload().pop()
    bc.push1(0).push1(0).sha3().pop().push1(1).push1(40).sha3().pop()
    bc.push1(100).push1(3).sha3().pop().stop()
    tx = Y.Transaction(id=1, gas=300000, gas_price=int(2e9), caller_address=0xFE,
                       callee_address=0xFF)
    acct = Y.Account(address=0xFF, storage={7: 1234, 8: 5})
    return [(tx, bc)], {0xFF: acct}


SIGNED_CASES = {
    "default_callers": lambda Y: (txs_of(Y), None),
    "shared_caller": lambda Y: (txs_of(Y, n_txs=3, shared_caller=True), None),
    "calldata": lambda Y: ([(tx, bc) for (tx, bc), data in zip(
        txs_of(Y, n_txs=3, n_ops=2), (bytes([0, 1, 2, 0]), b"", bytes(range(1, 40))))
        if setattr(tx, "call_data", data) is None], None),
    "pinned_account": lambda Y: (txs_of(Y, n_txs=1, shared_caller=True),
                                 {0xFE: Y.Account(address=0xFE, nonce=0, balance=10**19)}),
    "sstore_mix": lambda Y: (_sstore_txs(Y), None),
    "storage_memory": _storage_memory_txs,
}


@pytest.mark.parametrize("case", sorted(SIGNED_CASES))
def test_signed_trace_matches_jax(case):
    (jtxs, jacc), (ptxs, pacc) = SIGNED_CASES[case](JY), SIGNED_CASES[case](PY)
    jw = JT.trace_block(JY.Block(base_fee=int(1e9)), jtxs, accounts=jacc)
    pw = PT.trace_block(PY.Block(base_fee=int(1e9)), ptxs, accounts=pacc)
    assert_same_witness(jw, pw)
    assert [t.caller_address for t in pw.txs] == [PT.tx_sender_address(t.id) for t in pw.txs]
    assert [t.caller_address for t, _ in ptxs] == [t.caller_address for t, _ in jtxs]
    assert PT.tx_sender_address(1) == JT.tx_sender_address(1)
    assert len(pw.signed_txs) == len(ptxs)
    if case == "pinned_account":
        # the account pinned to 0xFE followed its tx to the key's address
        assert list(pacc) == [pw.txs[0].caller_address] and list(jacc) == list(pacc)
        balance = next(r for r in pw.rw.rws if r["key0"] == int(ps.Target.Account)
                       and r["field_tag"] == int(ps.AccountFieldTag.Balance))
        assert balance["value_prev"] == 10**19
    if case in ("sstore_mix", "storage_memory"):
        assert pw.copy_circuit is not None and pw.copy_circuit.rows
        names = {s.execution_state.name for s in pw.steps}
        assert {"SSTORE", "SLOAD", "SHA3"} <= names


def test_sstore_block_builder_is_bench_mix():
    """``workloads.build_sstore_block`` is ``bench.py:_sstore_heavy_txs``
    traced signed under bench's header: 154379 gas a tx, so its 7 txs are
    about 1.08 M gas."""
    n = 2
    jw = JT.trace_block(JY.Block(base_fee=10**9, gas_limit=30 * 10**6), _sstore_txs(JY, n))
    pw = workloads.build_sstore_block(n)
    assert_same_witness(jw, pw)
    per_tx = workloads.receipt_gas_used(pw) // n
    assert per_tx == 154379
    assert len(pw.copy_circuit.rows) == 2 * 32 * n


def test_storage_errors_raise():
    """The dynamic out-of-gas cases of the storage, memory and SHA3
    handlers: error halts, traced and verified as the JAX package does."""
    assert_parity(lambda Y: Y.Bytecode().push1(1).push1(0).sstore().stop(), 21000 + 6 + 2300,
                  "ErrorOutOfGasSloadSstore")
    assert_parity(lambda Y: Y.Bytecode().push1(0).sload().stop(), 21000 + 3 + 2000,
                  "ErrorOutOfGasSloadSstore")
    assert_parity(lambda Y: Y.Bytecode().push2(0x4000).mload().stop(), 21000 + 3 + 100,
                  "ErrorOutOfGasStaticMemoryExpansion")
    assert_parity(lambda Y: Y.Bytecode().push2(0x4000).push1(0).sha3().stop(), 21000 + 6 + 100,
                  "ErrorOutOfGasSHA3")


def _rw_storage_calls(Y, s):
    rw = Y.RWDictionary(5)
    rw.memory_write(3, 40, 0xAB).memory_read(3, 41, 0)
    rw.account_storage_read(0xCAFE, 1 << 200, 7, 1, 7)
    rw.account_storage_write(0xCAFE, 3, 9, 7, 1, 5)
    rw.account_storage_write(0xCAFE, 3, 0, 9, 1, 5, rw_counter_of_reversion=90)
    rw.tx_access_list_account_storage_write(1, 0xCAFE, 3, True, False)
    rw.tx_access_list_account_storage_write(1, 0xCAFE, 4, True, True, rw_counter_of_reversion=91)
    rw.tx_refund_write(1, 4800, 0).tx_refund_write(1, 0, 4800, rw_counter_of_reversion=92)
    rw.tx_log_write(1, 2, s.TxLogFieldTag.Data, 5, 0x11)
    return rw.rws, rw.rw_counter


def test_rw_dictionary_storage_rows_match_jax():
    assert _rw_storage_calls(PY, ps) == _rw_storage_calls(JY, js)
