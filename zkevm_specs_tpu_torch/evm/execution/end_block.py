"""EndBlock gadget, the block-level totality proofs A-F (reference:
evm_circuit/execution/end_block.py:11-183).

The block totals (tx counts, withdrawal counts, sorted withdrawal rows) are
host scalars derived from the lookup tables; they go through
``Instruction.table_scalar``, so the eager trace records them in the
control signature and the replay takes them from it, against the same
shipped tables.
"""
from ...dsl.value import Word
from ...ops import limbs as L
from ...tables.schemas import (
    BlockContextFieldTag,
    CallContextFieldTag,
    TxContextFieldTag,
    TxReceiptFieldTag,
)
from ...utils.param import N_BYTES_GAS
from ..instruction import Instruction, Transition


def _col_ints(table, col):
    v = table.data[col]
    if isinstance(v, Word):
        los = L.limbs_to_ints(v.lo.limbs)
        his = L.limbs_to_ints(v.hi.limbs)
        return [lo + (hi << 128) for lo, hi in zip(los, his)]
    return L.limbs_to_ints(v.limbs)


def get_tx_table_max_txs(tx_table) -> int:
    tags = _col_ints(tx_table, "field_tag")
    return sum(1 for t in tags if t == int(TxContextFieldTag.CallerAddress))


def _count_total_txs(tx_table) -> int:
    tags = _col_ints(tx_table, "field_tag")
    values = _col_ints(tx_table, "value")
    return sum(1 for t, v in zip(tags, values)
               if t == int(TxContextFieldTag.CallerAddress) and v != 0)


def _count_invalid_txs(tx_table) -> int:
    tags = _col_ints(tx_table, "field_tag")
    values = _col_ints(tx_table, "value")
    return sum(1 for t, v in zip(tags, values)
               if t == int(TxContextFieldTag.TxInvalid) and v == 1)


def end_block(instruction: Instruction):
    tables = instruction.tables
    ts = instruction.table_scalar
    max_rws = tables.rw.n_rows
    max_withdrawals = tables.withdrawal.n_rows
    max_txs = ts(lambda: get_tx_table_max_txs(tables.tx))
    total_txs = ts(lambda: _count_total_txs(tables.tx))
    total_valid_txs = total_txs - ts(lambda: _count_invalid_txs(tables.tx))

    total_withdrawals = (
        ts(lambda: sum(1 for a in _col_ints(tables.withdrawal, "amount") if a != 0))
        if max_withdrawals else 0
    )

    is_empty_block = instruction.is_zero(instruction.curr.rw_counter - 1)
    total_rws = (1 - is_empty_block) * (instruction.curr.rw_counter - 1 + 2)

    if instruction.is_last_step:
        if instruction.branch(is_empty_block):
            # 1a. empty block
            instruction.constrain_equal(instruction.fq(total_valid_txs), 0)
            instruction.constrain_equal(instruction.fq(total_withdrawals), 0)
        else:
            # 1b. total_txs matches the final step's tx_id
            instruction.constrain_equal(
                instruction.call_context_lookup(CallContextFieldTag.TxId),
                instruction.fq(total_txs),
            )

            # 4. CumulativeGasUsed <= block gas limit
            gas_limit = instruction.block_context_lookup(BlockContextFieldTag.GasLimit)
            cumulative_gas = instruction.tx_receipt_read(
                instruction.fq(total_txs), TxReceiptFieldTag.CumulativeGasUsed)
            limit_exceeded, _ = instruction.compare(gas_limit, cumulative_gas, N_BYTES_GAS)
            instruction.constrain_equal(limit_exceeded, 0)

            # 5. withdrawal balance updates, sorted by id
            padding_wds = 0
            if max_withdrawals:
                # host rows at trace time; each consumed value replays
                # through the signature
                if instruction.ctx.eager:
                    rows_host = sorted(zip(
                        _col_ints(tables.withdrawal, "id"),
                        _col_ints(tables.withdrawal, "address"),
                        _col_ints(tables.withdrawal, "amount"),
                    ))
                else:
                    rows_host = None
                for k in range(max_withdrawals):
                    addr = ts(lambda: rows_host[k][1])
                    amount = ts(lambda: rows_host[k][2])
                    if amount != 0:
                        instruction.add_balance(instruction.fq(addr),
                                                [instruction.word(amount * int(1e9))])
                    else:
                        padding_wds += 1
            instruction.constrain_equal(
                instruction.fq(padding_wds),
                instruction.fq(max_withdrawals - total_withdrawals),
            )

        # 2. remaining txs in the table must be padding
        if total_txs != max_txs:
            instruction.constrain_equal_word(
                instruction.tx_context_lookup_word(
                    instruction.fq(total_txs + 1), TxContextFieldTag.CallerAddress),
                instruction.word(0),
            )

        # 3. rw-table padding count argument
        instruction.rw_table_start_lookup(1)
        instruction.rw_table_start_lookup(max_rws - total_rws - total_withdrawals)
    else:
        instruction.constrain_step_state_transition(
            rw_counter=Transition.same(),
            call_id=Transition.same(),
        )
