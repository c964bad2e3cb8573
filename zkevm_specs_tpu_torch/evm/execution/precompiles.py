"""Precompile-call gadgets: ECRECOVER, DATACOPY (identity), BN254 ADD / MUL /
PAIRING (reference: evm_circuit/execution/precompiles/*.py, dataCopy.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/precompiles.py``.  The
curve results come as hints from the step's ``aux_data`` (the tracer's);
ecRecover looks its signature up in the sig table, the bn254 gadgets their
op in the ecc table, identity its two copies in the copy table.  The
ecRecover RLCs of the eager pass are host work that runs once a prepare
(``Instruction.host_ints``), never in a replay."""
from dataclasses import dataclass

from ...dsl.value import F, Word
from ...tables.schemas import RW, CallContextFieldTag, CopyDataTypeTag, EccOpTag, FixedTableTag
from ...utils.param import (
    Bn254AddGas,
    Bn254PairingBaseGas,
    Bn254PairingPerPointGas,
    Bn254ScalarMulGas,
    EcrecoverGas,
    IdentityBaseGas,
    IdentityPerWordGas,
)
from ...witness.rlc import RLC
from ..instruction import Instruction

SECP256K1N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
BYTES_PER_PAIRING = 192


@dataclass(frozen=True)
class PrecompileAuxData:
    msg_hash: int
    sig_v: int
    sig_r: int
    sig_s: int
    recovered_addr: int
    input_rlc: int
    output_rlc: int


def _aux_words(instruction: Instruction, idx: int) -> Word:
    return instruction.word_hint(instruction.aux_ints(lambda a: int(a[idx])))


def _aux_f(instruction: Instruction, idx: int, bits: int = 254) -> F:
    return instruction.f_hint(instruction.aux_ints(lambda a: int(a[idx])), bits)


def _precompile_info(instruction: Instruction, base_gas: int, address: F):
    instruction.fixed_lookup(
        FixedTableTag.PrecompileInfo,
        instruction.fq(int(instruction.curr.execution_state_static)),
        address,
        instruction.fq(base_gas),
    )


def _input_rlc(a: PrecompileAuxData, keccak_rand: int) -> int:
    """The RLC of (hash, v, r, s), 32 little-endian bytes each, reversed."""
    ib = b"".join(int(v).to_bytes(32, "little") for v in (a.msg_hash, a.sig_v, a.sig_r, a.sig_s))
    return RLC(bytes(reversed(ib)), keccak_rand, n_bytes=128).expr()


def _output_rlc(a: PrecompileAuxData, keccak_rand: int) -> int:
    return RLC(bytes(reversed(int(a.recovered_addr).to_bytes(32, "little"))), keccak_rand,
               n_bytes=32).expr()


def ecRecover(instruction: Instruction):
    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess, RW.Read)
    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    _precompile_info(instruction, EcrecoverGas, address)

    aux = instruction.aux_ints(lambda a: a[0])
    keccak_rand = instruction.aux_scalar(lambda ad: int(ad[0][1]), default=255)
    msg_hash = instruction.word_hint([a.msg_hash for a in aux])
    sig_v = instruction.word_hint([a.sig_v for a in aux])
    sig_r = instruction.word_hint([a.sig_r for a in aux])
    sig_s = instruction.word_hint([a.sig_s for a in aux])
    recovered_addr = instruction.f_hint([a.recovered_addr for a in aux], 160)

    is_recovered = 1 - instruction.is_zero(recovered_addr)

    # the input and output RLCs against the host's commitments
    input_rlcs = instruction.host_ints(lambda: [_input_rlc(a, keccak_rand) for a in aux])
    output_rlcs = instruction.host_ints(lambda: [_output_rlc(a, keccak_rand) for a in aux])
    instruction.constrain_equal(instruction.f_hint([a.input_rlc for a in aux]),
                                instruction.f_hint(input_rlcs))
    instruction.constrain_equal(instruction.f_hint([a.output_rlc for a in aux]),
                                instruction.f_hint(output_rlcs))

    instruction.constrain_equal(is_success, 1)

    n_word = instruction.word(SECP256K1N)
    sig_r_upper_bound, _ = instruction.compare_word(sig_r, n_word)
    sig_s_upper_bound, _ = instruction.compare_word(sig_s, n_word)
    sig_r_is_non_zero = 1 - instruction.is_zero_word(sig_r)
    sig_s_is_non_zero = 1 - instruction.is_zero_word(sig_s)
    valid_r_s = instruction.is_equal(
        sig_r_upper_bound + sig_s_upper_bound + sig_r_is_non_zero + sig_s_is_non_zero, 4)
    is_equal_27 = instruction.is_equal_word(sig_v, instruction.word(27))
    is_equal_28 = instruction.is_equal_word(sig_v, instruction.word(28))
    valid_v = instruction.is_equal(is_equal_27 + is_equal_28, 1)

    valid = instruction.mask_of(instruction.is_equal(valid_r_s + valid_v, 2))
    with instruction.masked(valid):
        instruction.sig_lookup(msg_hash, sig_v.lo - 27, sig_r, sig_s, recovered_addr,
                               is_recovered)
    with instruction.masked(~valid):
        instruction.constrain_zero(is_recovered)
        instruction.constrain_zero(recovered_addr)

    instruction.step_state_transition_to_restored_context(
        rw_counter_delta=instruction.rw_counter_offset,
        return_data_offset=instruction.fq(0),
        return_data_length=instruction.select(is_recovered, instruction.fq(32),
                                              instruction.fq(0)),
        gas_left=instruction.curr.gas_left - EcrecoverGas,
    )


def ecAdd(instruction: Instruction):
    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess)
    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    _precompile_info(instruction, Bn254AddGas, address)

    px = _aux_words(instruction, 0)
    py = _aux_words(instruction, 1)
    qx = _aux_words(instruction, 2)
    qy = _aux_words(instruction, 3)
    outx = _aux_f(instruction, 4)
    outy = _aux_f(instruction, 5)

    with instruction.masked(instruction.mask_of(1 - is_success)):
        instruction.constrain_zero(outx)
        instruction.constrain_zero(outy)

    instruction.ecc_lookup(instruction.fq(EccOpTag.Add), px, py, qx, qy, instruction.fq(0),
                           outx, outy, is_success)

    gas_left = instruction.select(is_success, instruction.curr.gas_left - Bn254AddGas,
                                  instruction.fq(0))
    instruction.step_state_transition_to_restored_context(
        rw_counter_delta=instruction.rw_counter_offset,
        return_data_offset=instruction.fq(0),
        return_data_length=instruction.select(is_success, instruction.fq(64), instruction.fq(0)),
        gas_left=gas_left,
    )


def ecMul(instruction: Instruction):
    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess, RW.Read)
    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    _precompile_info(instruction, Bn254ScalarMulGas, address)

    px = _aux_words(instruction, 0)
    py = _aux_words(instruction, 1)
    s = _aux_words(instruction, 2)
    outx = _aux_f(instruction, 3)
    outy = _aux_f(instruction, 4)

    zero_out = (instruction.mask_of(1 - is_success) | s.is_zero_mask()
                | (px.is_zero_mask() & py.is_zero_mask()))
    with instruction.masked(zero_out):
        instruction.constrain_zero(outx)
        instruction.constrain_zero(outy)

    instruction.ecc_lookup(instruction.fq(EccOpTag.Mul), px, py, s, instruction.word(0),
                           instruction.fq(0), outx, outy, is_success)

    gas_left = instruction.select(is_success, instruction.curr.gas_left - Bn254ScalarMulGas,
                                  instruction.fq(0))
    instruction.step_state_transition_to_restored_context(
        rw_counter_delta=instruction.rw_counter_offset,
        return_data_offset=instruction.fq(0),
        return_data_length=instruction.select(is_success, instruction.fq(64), instruction.fq(0)),
        gas_left=gas_left,
    )


def ecPairing(instruction: Instruction):
    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess)
    calldata_len = instruction.call_context_lookup(CallContextFieldTag.CallDataLength)
    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    _precompile_info(instruction, Bn254PairingBaseGas, address)

    input_rlc = _aux_f(instruction, 0)
    input_pairs = _aux_f(instruction, 1, 32)
    is_valid_input = _aux_f(instruction, 2, 1)
    output = _aux_f(instruction, 3, 1)

    instruction.constrain_equal(is_success, is_valid_input)

    _, rem = instruction.constant_divmod_nocheck(calldata_len, BYTES_PER_PAIRING)
    if instruction.branch(1 - instruction.is_zero(rem)):
        instruction.constrain_equal(output, 0)
        instruction.constrain_equal(is_valid_input, 0)
    else:
        instruction.constrain_equal(calldata_len, input_pairs * BYTES_PER_PAIRING)
        empty = instruction.mask_of(instruction.is_zero(calldata_len))
        with instruction.masked(empty):
            instruction.constrain_zero(input_pairs)
            instruction.constrain_zero(input_rlc)
            instruction.constrain_equal(output, 1)

    instruction.ecc_lookup(
        instruction.fq(EccOpTag.Pairing),
        instruction.word(0), instruction.word(0), instruction.word(0), instruction.word(0),
        input_rlc, instruction.fq(0), output, is_valid_input,
    )

    gas_left = instruction.select(
        is_success,
        instruction.curr.gas_left - Bn254PairingBaseGas - input_pairs * Bn254PairingPerPointGas,
        instruction.fq(0),
    )
    instruction.step_state_transition_to_restored_context(
        rw_counter_delta=instruction.rw_counter_offset,
        return_data_offset=instruction.fq(0),
        return_data_length=instruction.select(is_valid_input, instruction.fq(32),
                                              instruction.fq(0)),
        gas_left=gas_left,
    )


def dataCopy(instruction: Instruction):
    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    _precompile_info(instruction, IdentityBaseGas, address)

    CC = CallContextFieldTag
    caller_id = instruction.call_context_lookup(CC.CallerId, RW.Read)
    call_data_offset = instruction.call_context_lookup(CC.CallDataOffset, RW.Read)
    call_data_length = instruction.call_context_lookup(CC.CallDataLength, RW.Read)
    return_data_offset = instruction.call_context_lookup(CC.ReturnDataOffset, RW.Read)
    return_data_length = instruction.call_context_lookup(CC.ReturnDataLength, RW.Read)

    size = call_data_length
    gas_cost = IdentityBaseGas + instruction.memory_copier_gas_cost(
        call_data_length, instruction.fq(0), IdentityPerWordGas)

    copy_rwc_inc, _ = instruction.copy_lookup(
        caller_id, CopyDataTypeTag.Memory, caller_id, CopyDataTypeTag.Memory,
        call_data_offset, call_data_offset + size,
        return_data_offset, return_data_offset + return_data_length,
        instruction.curr.rw_counter + instruction.rw_counter_offset,
    )
    instruction.copy_lookup(
        caller_id, CopyDataTypeTag.Memory, instruction.curr.call_id, CopyDataTypeTag.Memory,
        call_data_offset, call_data_offset + size,
        instruction.fq(0), return_data_length,
        instruction.curr.rw_counter + instruction.rw_counter_offset + copy_rwc_inc,
    )
    instruction.add_rw_counter_dyn(size * 4)

    instruction.step_state_transition_to_restored_context(
        rw_counter_delta=instruction.rw_offset_f(),
        return_data_offset=instruction.fq(0),
        return_data_length=size,
        gas_left=instruction.curr.gas_left - gas_cost,
        caller_id=caller_id,
    )
