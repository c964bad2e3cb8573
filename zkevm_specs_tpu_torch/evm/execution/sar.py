"""SAR gadget (reference: evm_circuit/execution/sar.py:12-193)."""
from ...dsl.value import Word
from ...utils.param import MAX_U64, N_BYTES_U64
from ..instruction import Instruction, Transition


def sar(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    shift = instruction.stack_pop()
    a = instruction.stack_pop()
    b = instruction.stack_push()

    wit = _gen_witness(instruction, shift, a)
    _check_witness(instruction, shift, a, b, *wit)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )


def _check_witness(instruction, shift, a, b, a64s, b64s, a64s_lo, a64s_hi,
                   shf_div64, shf_mod64, p_lo, p_hi, p_top):
    a_le_bytes = a.to_le_bytes()
    b_le_bytes = b.to_le_bytes()
    shift_le_bytes = shift.to_le_bytes()
    is_neg, _ = instruction.compare(instruction.fq(127), a_le_bytes[31], 1)
    shf_lt256 = instruction.is_zero(instruction.sum(shift_le_bytes[1:]))

    for idx in range(4):
        offset = idx * N_BYTES_U64
        instruction.constrain_equal(
            a64s[idx], instruction.bytes_to_fq(a_le_bytes[offset:offset + N_BYTES_U64])
        )
        instruction.constrain_equal(
            b64s[idx], instruction.bytes_to_fq(b_le_bytes[offset:offset + N_BYTES_U64])
        )
        instruction.constrain_equal(a64s[idx], a64s_lo[idx] + a64s_hi[idx] * p_lo)
        a64s_lo_lt_p_lo, _ = instruction.compare(a64s_lo[idx], p_lo, 16)
        instruction.constrain_equal(a64s_lo_lt_p_lo, 1)
        a64s_hi_lt_p_hi, _ = instruction.compare(a64s_hi[idx], p_hi, 16)
        instruction.constrain_equal(a64s_hi_lt_p_hi, 1)

    shf_div64_eq0 = shf_lt256 * instruction.is_zero(shf_div64)
    shf_div64_eq1 = shf_lt256 * instruction.is_zero(shf_div64 - 1)
    shf_div64_eq2 = shf_lt256 * instruction.is_zero(shf_div64 - 2)
    shf_div64_eq3 = shf_lt256 * instruction.is_zero(shf_div64 - 3)
    instruction.constrain_equal(
        b64s[0],
        (a64s_hi[0] + a64s_lo[1] * p_hi) * shf_div64_eq0
        + (a64s_hi[1] + a64s_lo[2] * p_hi) * shf_div64_eq1
        + (a64s_hi[2] + a64s_lo[3] * p_hi) * shf_div64_eq2
        + (a64s_hi[3] + p_top) * shf_div64_eq3
        + is_neg * MAX_U64 * (1 - shf_div64_eq0 - shf_div64_eq1 - shf_div64_eq2 - shf_div64_eq3),
    )
    instruction.constrain_equal(
        b64s[1],
        (a64s_hi[1] + a64s_lo[2] * p_hi) * shf_div64_eq0
        + (a64s_hi[2] + a64s_lo[3] * p_hi) * shf_div64_eq1
        + (a64s_hi[3] + p_top) * shf_div64_eq2
        + is_neg * MAX_U64 * (1 - shf_div64_eq0 - shf_div64_eq1 - shf_div64_eq2),
    )
    instruction.constrain_equal(
        b64s[2],
        (a64s_hi[2] + a64s_lo[3] * p_hi) * shf_div64_eq0
        + (a64s_hi[3] + p_top) * shf_div64_eq1
        + is_neg * MAX_U64 * (1 - shf_div64_eq0 - shf_div64_eq1),
    )
    instruction.constrain_equal(
        b64s[3],
        (a64s_hi[3] + p_top) * shf_div64_eq0 + is_neg * MAX_U64 * (1 - shf_div64_eq0),
    )

    shf_div64_lt_4, _ = instruction.compare(shf_div64, instruction.fq(4), 1)
    instruction.constrain_equal(shf_div64_lt_4, 1)
    shf_mod64_lt_64, _ = instruction.compare(shf_mod64, instruction.fq(64), 1)
    instruction.constrain_equal(shf_mod64_lt_64, 1)
    instruction.constrain_equal(shift_le_bytes[0], shf_mod64 + shf_div64 * 64)

    instruction.constrain_bool(is_neg)
    instruction.sign_byte_lookup(
        instruction.bytes_to_fq(a_le_bytes[31:]),
        instruction.select(is_neg, instruction.fq(255), instruction.fq(0)),
    )

    instruction.constrain_equal(p_top, is_neg * (MAX_U64 + 1 - p_hi))

    instruction.pow2_lookup(shf_mod64, p_lo, instruction.fq(0))
    instruction.pow2_lookup(64 - shf_mod64, p_hi, instruction.fq(0))


def _gen_witness(instruction: Instruction, shift: Word, a: Word):
    a_ints = instruction.ints_of(a)
    sh_ints = instruction.ints_of(shift)

    M64 = (1 << 64) - 1
    a64s_i = [[(v >> (64 * k)) & M64 for k in range(4)] for v in a_ints]
    rows = []
    for v, s in zip(a_ints, sh_ints):
        is_neg = v >> 255
        shf0 = s & 0xFF
        shf_div64, shf_mod64 = divmod(shf0, 64)
        p_lo = 1 << shf_mod64
        p_hi = 1 << (64 - shf_mod64)
        p_top = is_neg * (M64 + 1 - p_hi)
        shf_lt256 = s >> 8  # nonzero if any higher byte set
        limbs = [(v >> (64 * k)) & M64 for k in range(4)]
        lo = [x % p_lo for x in limbs]
        hi = [x // p_lo for x in limbs]
        b64s = [M64 if is_neg else 0] * 4
        if shf_lt256 == 0 and shf_div64 < 4:
            b64s[3 - shf_div64] = hi[3] + p_top
            for k in range(3 - shf_div64):
                b64s[k] = hi[k + shf_div64] + lo[k + shf_div64 + 1] * p_hi
        rows.append((limbs, b64s, lo, hi, shf_div64, shf_mod64, p_lo, p_hi, p_top))

    def col(j, i, bits=66):
        return instruction.f_hint([r[j][i] for r in rows], bits)

    def scalar(j, bits=66):
        return instruction.f_hint([r[j] for r in rows], bits)

    a64s = [col(0, i) for i in range(4)]
    b64s = [col(1, i) for i in range(4)]
    a64s_lo = [col(2, i) for i in range(4)]
    a64s_hi = [col(3, i) for i in range(4)]
    return (
        a64s, b64s, a64s_lo, a64s_hi,
        scalar(4, 8), scalar(5, 8), scalar(6, 65), scalar(7, 65), scalar(8, 65),
    )
