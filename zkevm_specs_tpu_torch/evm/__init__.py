"""Public EVM-circuit API of the port (the ported part of the JAX
package's ``zkevm_specs_tpu/evm/__init__.py``)."""
from ..tables.container import Tables
from ..tables.schemas import RW, BytecodeFieldTag, CallContextFieldTag, FixedTableTag, Target
from ..witness.typing import Block, Bytecode, RWDictionary
from .execution_state import ExecutionState
from .instruction import Instruction, Transition
from .main import verify_steps
from .opcode import Opcode
from .step import StepState
