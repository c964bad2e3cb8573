"""Each precompile's calldata and return-length constraints (reference:
evm_circuit/util/precompile_gadget.py:6-38).

Counterpart of ``zkevm_specs_tpu/evm/gadgets/precompile_gadget.py``."""
from ...dsl.value import F
from ..instruction import Instruction
from ..precompile import Precompile


class PrecompileGadget:
    def __init__(self, instruction: Instruction, callee_addr: F, precompile_return_len: F,
                 calldata_len: F):
        instruction.constrain_equal(instruction.precompile(callee_addr), 1)

        # the reference resolves Precompile(callee_addr) on one value; here
        # the address selects each precompile's constraints lane-uniformly
        for p in Precompile:
            if not instruction.branch(instruction.is_equal(callee_addr, int(p))):
                continue
            if p == Precompile.DATACOPY:
                instruction.constrain_equal(precompile_return_len, calldata_len)
            elif p == Precompile.ECRECOVER:
                is_32 = instruction.is_equal(precompile_return_len, 32)
                is_zero = instruction.is_equal(precompile_return_len, 0)
                instruction.constrain_equal(is_32 + is_zero, 1)
            elif p == Precompile.BN254ADD:
                instruction.constrain_equal(calldata_len, 128)
            elif p == Precompile.BN254SCALARMUL:
                instruction.constrain_equal(calldata_len, 96)
            elif p == Precompile.BN254PAIRING:
                _, rem = instruction.constant_divmod_nocheck(calldata_len, 192)
                instruction.constrain_zero(rem)
            break
