"""DUP1..16 / SWAP1..16 / PC / JUMPDEST gadgets.

Counterpart of ``zkevm_specs_tpu/evm/execution/stack_family.py``.  These
four states exist in the reference enum (evm_circuit/execution_state.py)
with no gadget registered there (execution/__init__.py:86-171); the JAX
package implements them from EVM semantics, and so does the port:

- DUPx   duplicates the x-th stack item:   1 read + 1 push   (rw +2, sp -1)
- SWAPx  swaps top with the (x+1)-th item: 2 reads + 2 writes (rw +4, sp 0)
- PC     pushes the current program counter (rw +1, sp -1)
- JUMPDEST is a no-op marker               (rw +0, sp 0)

Constant gas comes from the OpcodeConstantGas fixed table (DUP/SWAP = 3,
PC = 2, JUMPDEST = 1) through ``step_state_transition_in_same_context``.
"""
from ...tables.schemas import RW
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def dup(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    # DUP1 reads offset 0 (the top), DUPx reads offset x-1.
    position = opcode - int(Opcode.DUP1)
    value = instruction.stack_lookup(RW.Read, position)
    instruction.constrain_equal_word(value, instruction.stack_push())

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def swap(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    # SWAPx exchanges the top with the item at depth x (offset x from top).
    n = opcode - int(Opcode.SWAP1) + 1
    top = instruction.stack_lookup(RW.Read, 0)
    deep = instruction.stack_lookup(RW.Read, n)
    instruction.constrain_equal_word(deep, instruction.stack_lookup(RW.Write, 0))
    instruction.constrain_equal_word(top, instruction.stack_lookup(RW.Write, n))

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(4),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
    )


def pc(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal_word(
        Word.from_lo(instruction.curr.program_counter),
        instruction.stack_push(),
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(1),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def jumpdest(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.JUMPDEST))

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.same(),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
    )
