"""The port's tracer (zkevm_specs_tpu_torch.witness.tracer, the ALU subset
with ADDMOD, MULMOD and EXP) against the JAX package's ``trace_block(...,
sign=False)``, tolerance 0: every field of every step, every rw row, the
tables' rows, the exp circuit's rows and the per-tx outcome bookkeeping are
equal on the same transactions.  Also the host
witness classes it emits through (``Transaction``, ``Account``,
``RWDictionary``'s call-context, account, access-list, refund and receipt
rows), the ALU block's builder, and what the subset refuses to trace."""
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


def assert_same_witness(jw, pw):
    assert len(jw.steps) == len(pw.steps)
    for i, (a, b) in enumerate(zip(jw.steps, pw.steps)):
        assert a.execution_state.name == b.execution_state.name, i
        for f in STEP_FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
    assert pw.rw.rws == jw.rw.rws
    assert pw.tables_kwargs() == {k: v for k, v in jw.tables_kwargs().items()
                                  if k in pw.tables_kwargs()}
    assert pw.tx_success == jw.tx_success and pw.tx_rwceor == jw.tx_rwceor
    assert pw.tx_code_hashes == jw.tx_code_hashes
    assert [bytes(b.code) for b in pw.bytecodes] == [bytes(b.code) for b in jw.bytecodes]
    assert pw.block.table_assignments() == jw.block.table_assignments()


CASES = {
    "2x6": dict(),
    "1x3": dict(n_txs=1, n_ops=3),
    "3x5": dict(n_txs=3, n_ops=5),
    "shared_caller": dict(shared_caller=True),
    "arith": dict(n_ops=8, ops=("add", "sub", "mul", "div", "mod", "lt", "and_", "shl")),
    "empty": dict(n_txs=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_jax(case):
    kw = CASES[case]
    jw = JT.trace_block(JY.Block(base_fee=int(1e9)), txs_of(JY, **kw), sign=False)
    pw = PT.trace_block(PY.Block(base_fee=int(1e9)), txs_of(PY, **kw), sign=False)
    assert_same_witness(jw, pw)


def test_alu_block_builder_is_bench_mix_traced_unsigned():
    """``workloads.build_alu_block`` is ``bench.py:_alu_heavy_txs``'s
    bytecodes and gas under ``Block(base_fee=10**9, gas_limit=30*10**6)``,
    with a caller per tx (unsigned, a shared caller's nonces go stale)."""
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
    jw = JT.trace_block(JY.Block(base_fee=10**9, gas_limit=30 * 10**6), jtxs, sign=False)
    pw = workloads.build_alu_block(n_txs, n_ops)
    assert_same_witness(jw, pw)
    assert workloads.receipt_gas_used(pw) == n_txs * (21000 + 11 * n_ops) > 0


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
                        _jax_txs(workloads.arith_block_txs(n_txs, cycles, seed)), sign=False)
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


def test_exp_out_of_gas_raises():
    # 21000 + two PUSHes (6) leave 49 gas, under EXP's 50 for a 1-byte exponent
    bc = PY.Bytecode().push1(3).push1(2).exp().stop()
    tx = PY.Transaction(id=1, gas=21000 + 6 + 49, caller_address=0xFE, callee_address=0xFF)
    with pytest.raises(NotImplementedError, match="ErrorOutOfGasEXP"):
        PT.trace_block(PY.Block(), [(tx, bc)], sign=False)


def test_signed_block_is_not_ported():
    with pytest.raises(NotImplementedError, match="sign"):
        PT.trace_block(PY.Block(), txs_of(PY))


@pytest.mark.parametrize("code,what", [
    (lambda: PY.Bytecode().push1(1).push1(0).sstore().stop(), "no handler"),
    (lambda: PY.Bytecode().pop().stop(), "ErrorStack"),
    (lambda: PY.Bytecode(bytearray([0x0C])), "ErrorInvalidOpcode"),
])
def test_what_the_subset_does_not_trace_raises(code, what):
    tx = PY.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF)
    with pytest.raises(NotImplementedError, match=what):
        PT.trace_block(PY.Block(), [(tx, code())], sign=False)


def test_out_of_gas_raises():
    tx = PY.Transaction(id=1, gas=21000 + 2, caller_address=0xFE, callee_address=0xFF)
    with pytest.raises(NotImplementedError, match="ErrorOutOfGasConstant"):
        PT.trace_block(PY.Block(), [(tx, PY.Bytecode().push1(1).stop())], sign=False)


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
    w = workloads.build_alu_block(1, 2)
    assert w.signed_txs is None and w.copy_circuit is None and w.exp_circuit is None
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
