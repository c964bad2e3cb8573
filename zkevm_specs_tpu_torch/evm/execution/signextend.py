"""SIGNEXTEND gadget (reference: evm_circuit/execution/signextend.py:5-59).

Note the reference computes several byte relations with ``is_equal`` (which
does NOT constrain) — that behavior is mirrored for verdict parity."""
from ...dsl.value import F
from ..instruction import Instruction, Transition


def signextend(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    index = instruction.stack_pop()
    value = instruction.stack_pop()
    result = instruction.stack_push()

    index_le_bytes = index.to_le_bytes()
    value_le_bytes = value.to_le_bytes()
    result_le_bytes = result.to_le_bytes()

    is_msb_sum_zero = instruction.is_zero(instruction.sum(index_le_bytes[1:32]))

    # witness: the sign byte of the selected byte (data-dependent index)
    idx0 = instruction.ints_of(index_le_bytes[0])
    val_ints = instruction.ints_of(value)
    sign_byte_hint = []
    for i0, v in zip(idx0, val_ints):
        if i0 < 31:
            b = (v >> (8 * i0)) & 0xFF
            sign_byte_hint.append((b >> 7) * 0xFF)
        else:
            sign_byte_hint.append(0)
    sign_byte = instruction.f_hint(sign_byte_hint, 8)

    selectors = []
    is_byte_selected = []
    for i in range(31):
        ge = ~index_le_bytes[0].lt_mask(instruction.fq(i))
        selectors.append(F.from_bool(instruction.ctx, ge))
        is_byte_selected.append(instruction.is_equal(index_le_bytes[0], i))

    selected_byte = instruction.fq(0)
    for i in range(31):
        is_selected = is_byte_selected[i] * is_msb_sum_zero
        selected_byte = selected_byte + value_le_bytes[i] * is_selected
        # reference calls is_equal here without constraining (signextend.py:40)
        instruction.is_equal(
            is_selected + (selectors[i - 1] if i > 0 else instruction.fq(0)), selectors[i]
        )

    instruction.sign_byte_lookup(selected_byte, sign_byte)

    for idx in range(32):
        if idx == 0:
            instruction.is_equal(result_le_bytes[idx], value_le_bytes[idx])
        else:
            # reference selects per concrete selector value then is_equal
            expected = instruction.select(
                selectors[idx - 1], sign_byte, value_le_bytes[idx]
            )
            instruction.is_equal(result_le_bytes[idx], expected)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
