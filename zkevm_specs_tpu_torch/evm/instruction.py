"""The batched EVM-step constraint builder (the part the ported gadgets use:
ADD/SUB, MUL/DIV/MOD, SDIV/SMOD, ADDMOD, MULMOD, EXP, SHL/SHR, SAR,
LT/GT/EQ, SLT/SGT, ISZERO, NOT, AND/OR/XOR, BYTE, SIGNEXTEND, MLOAD/MSTORE/
MSTORE8, SLOAD, SSTORE, SHA3, PUSH, POP, STOP, BeginTx, EndTx, EndBlock,
DUP/SWAP/PC/JUMPDEST, JUMP/JUMPI, GAS, MSIZE, the context queries, BALANCE,
EXTCODESIZE/EXTCODEHASH, CALLDATALOAD, CALLDATACOPY/CODECOPY/EXTCODECOPY/
RETURNDATACOPY, LOG0-LOG4, the CALL family and RETURN/REVERT, with the
return to a caller's restored context, CREATE/CREATE2 and the error
states).

Counterpart of ``zkevm_specs_tpu/evm/instruction.py`` (reference:
src/zkevm_specs/evm_circuit/instruction.py:116-1452).  The same constraint
semantics are evaluated over a whole *group* of steps at once: values are
batched ``F``/``Word`` tensors, constraints are boolean tensors ORed per
lane in the ConstraintSystem, and data-dependent control flow goes through
``branch()``, which is lane-uniform by group splitting (eager) or
signature replay (replay).  The offset bookkeeping is Python-side and
static per control path, exactly as in the reference.
"""
from __future__ import annotations

from enum import IntEnum, auto
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem, LaneSplit
from ..dsl.value import Ctx, F, Word, WordOrValue, trim, width_for_bits
from ..ops import limbs as L
from ..ops import word_mul
from ..utils.param import (
    GAS_COST_COPY,
    MAX_N_BYTES,
    MAX_U64,
    MEMORY_EXPANSION_LINEAR_COEFF,
    MEMORY_EXPANSION_QUAD_DENOMINATOR,
    N_BYTES_ACCOUNT_ADDRESS,
    N_BYTES_GAS,
    N_BYTES_MEMORY_ADDRESS,
    N_BYTES_MEMORY_WORD_SIZE,
)
from ..tables.container import Tables
from ..tables.schemas import (
    RW,
    AccountFieldTag,
    BlockContextFieldTag,
    BytecodeFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
    FixedTableTag,
    Target,
    TxContextFieldTag,
    TxLogFieldTag,
    TxReceiptFieldTag,
)
from .execution_state import ExecutionState
from .opcode import Opcode, constant_gas_cost, valid_opcodes
from .precompile import Precompile
from .step import StepStateBatch

IntOrF = Union[int, F]


class _HintDummy:
    """Inert stand-in for a host int in the replay.

    ``ints_of`` returns these outside the eager pass: the gadget's Python
    hint arithmetic still executes structurally (every operation yields
    another dummy, every comparison is False), but the values never matter
    because ``f_hint`` / ``word_hint`` replay the recorded hint stream."""

    __slots__ = ()

    def _op(self, *a):
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __floordiv__ = __rfloordiv__ = __truediv__ = __rtruediv__ = _op
    __mod__ = __rmod__ = __pow__ = __rpow__ = _op
    __lshift__ = __rlshift__ = __rshift__ = __rrshift__ = _op
    __and__ = __rand__ = __or__ = __ror__ = __xor__ = __rxor__ = _op
    __neg__ = __pos__ = __invert__ = __abs__ = _op

    def __divmod__(self, other):
        return (self, self)

    def __rdivmod__(self, other):
        return (self, self)

    __call__ = _op
    __getitem__ = _op

    def __getattr__(self, name):
        return self

    def __len__(self):
        return 0

    def __bool__(self):
        return False

    def __eq__(self, other):
        return False

    def __ne__(self, other):
        return True

    __lt__ = __le__ = __gt__ = __ge__ = __eq__

    def __int__(self):
        return 0

    __index__ = __int__
    __hash__ = object.__hash__

    def __repr__(self):
        return "<hint>"


_DUMMY = _HintDummy()


class TransitionKind(IntEnum):
    Same = auto()
    SameWord = auto()
    Delta = auto()
    To = auto()
    ToWord = auto()


class Transition:
    def __init__(self, kind: TransitionKind, value=0):
        self.kind = kind
        self.value = value

    @staticmethod
    def same() -> "Transition":
        return Transition(TransitionKind.Same)

    @staticmethod
    def same_word() -> "Transition":
        return Transition(TransitionKind.SameWord)

    @staticmethod
    def delta(delta) -> "Transition":
        return Transition(TransitionKind.Delta, delta)

    @staticmethod
    def to(to) -> "Transition":
        return Transition(TransitionKind.To, to)

    @staticmethod
    def to_word(to: Word) -> "Transition":
        return Transition(TransitionKind.ToWord, to)


class ReversionInfo:
    def __init__(self, rw_counter_end_of_reversion: F, is_persistent: F,
                 reversible_write_counter: F):
        self.rw_counter_end_of_reversion = rw_counter_end_of_reversion
        self.is_persistent = is_persistent
        self.reversible_write_counter = reversible_write_counter

    def rw_counter_of_reversion(self) -> F:
        out = self.rw_counter_end_of_reversion - self.reversible_write_counter
        self.reversible_write_counter = self.reversible_write_counter + 1
        return out


# host gas table for the per-lane constant-gas gather
_GAS_TABLE = np.zeros((256,), dtype=np.int64)
for _op in valid_opcodes():
    _GAS_TABLE[int(_op)] = constant_gas_cost(_op)
_GAS_TABLES = {}


def _gas_table(device: torch.device) -> torch.Tensor:
    t = _GAS_TABLES.get(str(device))
    if t is None:
        t = torch.from_numpy(_GAS_TABLE).to(device)
        _GAS_TABLES[str(device)] = t
    return t


class Instruction:
    def __init__(
        self,
        ctx: Ctx,
        cs: ConstraintSystem,
        tables: Tables,
        curr: StepStateBatch,
        next: StepStateBatch,
        is_first_step: bool,
        is_last_step: bool,
    ):
        self.ctx = ctx
        self.cs = cs
        self.tables = tables
        self.curr = curr
        self.next = next
        self.is_first_step = is_first_step
        self.is_last_step = is_last_step
        self.rw_counter_offset = 0
        # the per-lane offset added by looked-up copy-event sizes (the
        # reference's ``rw_counter_offset += int(copy_rwc_inc)``,
        # return_revert.py:66): a tensor addend for batched lanes
        self.rw_counter_dyn: Union[int, F] = 0
        self.program_counter_offset = 0
        self.stack_pointer_offset = 0

    def add_rw_counter_dyn(self, inc: F):
        self.rw_counter_dyn = self._f(self.rw_counter_dyn) + inc

    def rw_offset_f(self) -> F:
        return self._f(self.rw_counter_offset) + self._f(self.rw_counter_dyn)

    # -- small helpers -----------------------------------------------------

    def _f(self, v: IntOrF) -> F:
        return v if isinstance(v, F) else F.const(self.ctx, int(v))

    def fq(self, v: int) -> F:
        return F.const(self.ctx, int(v))

    def word(self, v: int) -> Word:
        return Word.const(self.ctx, int(v))

    # -- constraints -------------------------------------------------------

    def constrain_zero(self, value: F):
        self.cs.constrain_zero(self._f(value))

    def constrain_not_zero(self, value: F):
        self.cs.constrain_not_zero(self._f(value))

    def constrain_zero_word(self, value: Word):
        self.cs.constrain_zero_word(value)

    def constrain_not_zero_word(self, value: Word):
        self.cs.constrain_not_zero_word(value)

    def constrain_equal(self, lhs: IntOrF, rhs: IntOrF):
        self.cs.constrain_equal(self._f(lhs), self._f(rhs))

    def constrain_equal_word(self, lhs: Word, rhs: Word):
        self.cs.constrain_equal_word(lhs, rhs)

    def constrain_in(self, lhs: F, rhs: List[int]):
        self.cs.constrain_in_consts(self._f(lhs), [int(v) for v in rhs])

    def constrain_bool(self, num: F):
        self.cs.constrain_bool(self._f(num))

    def constrain_gas_left_not_underflow(self, gas_left: F):
        self.range_check(gas_left, N_BYTES_GAS)

    def range_check(self, value: F, n_bytes: int):
        assert n_bytes <= MAX_N_BYTES
        self.cs.range_check(self._f(value), n_bytes)

    def range_lookup(self, value: F, rng: int):
        self.fixed_lookup(FixedTableTag.range_table_tag(rng), value)

    # -- branching ---------------------------------------------------------

    def branch(self, cond) -> bool:
        """Lane-uniform bool of a data-dependent condition."""
        mask = cond if not isinstance(cond, F) else ~cond.is_zero_mask()
        return self.cs.branch(mask)

    def table_scalar(self, compute: Callable[[], int]) -> int:
        """A group-uniform host int derived from the lookup tables (EndBlock's
        tx and withdrawal counts, reference end_block.py:72-105): computed
        and recorded in the control signature by the eager trace, taken
        from the signature in the replay, which is fed the same tables."""
        cs = self.cs
        if cs._decision_idx < len(cs.decisions):
            decided = cs.decisions[cs._decision_idx]
            cs._decision_idx += 1
            return int(decided)
        assert self.ctx.eager, "the replay requires a full control signature"
        val = int(compute())
        cs.decisions.append(val)
        cs._decision_idx += 1
        return val

    def uniform_int(self, value: F) -> int:
        """A lane-uniform host int of a witness value (a loop bound): the
        eager trace records it in the control signature, as ``branch``
        records a decision (a lane that differs splits the group), and the
        replay takes it from the signature with an equality check."""
        value = self._f(value)
        cs = self.cs
        if cs._decision_idx < len(cs.decisions):
            decided = cs.decisions[cs._decision_idx]
            cs._decision_idx += 1
            cs.check(value.eq_mask(F.const(self.ctx, int(decided))),
                     lambda: f"Value diverged from signature {decided}")
            return int(decided)
        assert self.ctx.eager, "the replay requires a full control signature"
        vals = self.ints_of(value)
        first = vals[0]
        if all(v == first for v in vals):
            cs.decisions.append(first)
            cs._decision_idx += 1
            return first
        raise LaneSplit(np.array([v == first for v in vals]))

    def masked(self, mask):
        """Context manager: constraints and lookups inside are enforced only
        on lanes where ``mask`` holds (the body must not change the offset
        bookkeeping; use branch() for that)."""
        inst = self

        class _Masked:
            def __enter__(self_inner):
                self_inner.prev = inst.cs.push_mask(mask)
                return self_inner

            def __exit__(self_inner, *exc):
                inst.cs.pop_mask(self_inner.prev)
                return False

        return _Masked()

    def mask_of(self, condition: F):
        """Bool mask of a 0/1 condition value."""
        return ~self._f(condition).is_zero_mask()

    # -- host witness hints (two-phase hint protocol) ----------------------

    def ints_of(self, v: Union[F, Word]) -> list:
        """Per-lane Python ints of a value, broadcast to the batch size.

        In the replay the host arithmetic cannot run, so one inert
        ``_HintDummy`` placeholder is returned, not one a lane: a gadget's
        per-lane hint loop then runs once in each replay (the JAX package
        traces it once under jit), and ``word_hint`` / ``f_hint`` replay
        the arrays recorded by the eager hint pass."""
        if not self.ctx.eager:
            return [_DUMMY]
        vals = v.to_ints()
        if len(vals) == 1 and self.ctx.batch > 1:
            vals = vals * self.ctx.batch
        return vals

    def aux_ints(self, extract: Callable) -> list:
        """Per-lane host values taken from the steps' ``aux_data`` in the
        eager pass; one inert placeholder in the replay, which takes the
        real values from the hint stream (see ``ints_of``)."""
        if self.ctx.eager:
            return [extract(a) for a in self.curr.aux_data]
        return [_DUMMY]

    def aux_scalar(self, extract: Callable, default=0):
        """A group-uniform host scalar from the steps' ``aux_data`` (the
        keccak randomness of ecRecover's RLCs) in the eager pass;
        ``default`` in the replay, where it only feeds placeholder work
        whose values the hint stream replaces."""
        if self.ctx.eager:
            return extract(self.curr.aux_data)
        return default

    def host_ints(self, values: Callable[[], list]) -> list:
        """Per-lane host values that only feed hints: computed in the eager
        pass, one inert placeholder in the replay (which takes the values
        from the hint stream), so a host loop over the lanes runs once a
        prepare and never in a replay."""
        if self.ctx.eager:
            return values()
        return [_DUMMY]

    def word_hint(self, values: Sequence[int]) -> Word:
        """A 256-bit witness hint column: built from host ints in the eager
        pass (and recorded), replayed from the hint stream otherwise."""
        cs = self.cs
        if cs.hint_replay is not None:
            entry = cs.hint_replay[cs._hint_idx]
            bits = cs.hint_bits[cs._hint_idx]
            cs._hint_idx += 1
            return Word(F(self.ctx, entry["lo"], bits[0]), F(self.ctx, entry["hi"], bits[1]))
        w = Word.from_ints(self.ctx, [v % (1 << 256) for v in values])
        if cs.hint_record is not None:
            cs.hint_record.append({"lo": w.lo.limbs, "hi": w.hi.limbs})
            cs.hint_bits.append((w.lo.bits, w.hi.bits))
        return w

    def f_hint(self, values: Sequence[int], bits: int = 254) -> F:
        """A field witness hint column (see word_hint)."""
        cs = self.cs
        if cs.hint_replay is not None:
            entry = cs.hint_replay[cs._hint_idx]
            b = cs.hint_bits[cs._hint_idx]
            cs._hint_idx += 1
            return F(self.ctx, entry["f"], b)
        f = F.from_ints(self.ctx, values, bits)
        if cs.hint_record is not None:
            cs.hint_record.append({"f": f.limbs})
            cs.hint_bits.append(f.bits)
        return f

    # -- execution-state machine ------------------------------------------

    def constrain_execution_state_transition(self):
        curr = self.curr.execution_state_static
        next_f = self.next.execution_state
        ES = ExecutionState
        if curr == ES.EndTx:
            self.constrain_in(next_f, [int(ES.BeginTx), int(ES.EndBlock)])
        elif curr == ES.EndBlock:
            self.constrain_equal(next_f, int(ES.EndBlock))
        # negation rules, with curr static the masks collapse to constants
        if curr != ES.EndTx:
            self.cs.check(~next_f.eq_mask(int(ES.BeginTx)),
                          lambda: f"BeginTx must follow EndTx, curr={curr!r}")
        if not (curr.halts() or curr == ES.BeginTx):
            self.cs.check(~next_f.eq_mask(int(ES.EndTx)),
                          lambda: f"EndTx must follow a halt or BeginTx, curr={curr!r}")
        if curr not in (ES.EndTx, ES.EndBlock):
            self.cs.check(~next_f.eq_mask(int(ES.EndBlock)),
                          lambda: f"EndBlock must follow EndTx/EndBlock, curr={curr!r}")

    _STEP_KEYS = (
        "rw_counter", "call_id", "is_root", "is_create", "code_hash",
        "program_counter", "stack_pointer", "gas_left", "memory_word_size",
        "reversible_write_counter", "log_id",
    )

    def constrain_step_state_transition(self, **kwargs: Transition):
        assert set(self._STEP_KEYS).issuperset(kwargs.keys()), (
            f"Invalid keys {set(kwargs) - set(self._STEP_KEYS)}")
        for key, transition in kwargs.items():
            curr, next = getattr(self.curr, key), getattr(self.next, key)
            k = transition.kind
            if k == TransitionKind.Same:
                self.cs.constrain_equal(next, curr, name=f"state {key} (same)")
            elif k == TransitionKind.SameWord:
                self.cs.constrain_equal_word(next, curr, name=f"state {key} (same)")
            elif k == TransitionKind.Delta:
                self.cs.constrain_equal(next, curr + self._f(transition.value),
                                        name=f"state {key} (delta)")
            elif k == TransitionKind.To:
                self.cs.constrain_equal(next, self._f(transition.value), name=f"state {key} (to)")
            elif k == TransitionKind.ToWord:
                self.cs.constrain_equal_word(next, transition.value, name=f"state {key} (to)")
            else:
                raise ValueError("Unreachable")

    def step_state_transition_to_new_context(
        self, rw_counter, call_id, is_root, is_create, code_hash, gas_left,
        reversible_write_counter, log_id,
    ):
        self.constrain_step_state_transition(
            rw_counter=rw_counter,
            call_id=call_id,
            is_root=is_root,
            is_create=is_create,
            code_hash=code_hash,
            gas_left=gas_left,
            reversible_write_counter=reversible_write_counter,
            log_id=log_id,
            program_counter=Transition.to(0),
            stack_pointer=Transition.to(1024),
            memory_word_size=Transition.to(0),
        )

    def step_state_transition_to_restored_context(
        self,
        rw_counter_delta: IntOrF,
        return_data_offset: F,
        return_data_length: F,
        gas_left: F,
        caller_id: Optional[F] = None,
        accumulated_reversible: Optional[F] = None,
    ):
        """The caller's context restored at a callee's halt (reference
        instruction.py:316-365): its saved fields read back, its last-callee
        fields written, and the step moved to them."""
        rw_counter_delta = rw_counter_delta + 11 + int(caller_id is None)
        if caller_id is None:
            caller_id = self.call_context_lookup(CallContextFieldTag.CallerId)

        (
            caller_is_root, caller_is_create, caller_code_hash,
            caller_program_counter, caller_stack_pointer, caller_gas_left,
            caller_memory_size, caller_reversible_write_counter,
        ) = [
            self.call_context_lookup_word(tag, call_id=caller_id)
            for tag in (
                CallContextFieldTag.IsRoot,
                CallContextFieldTag.IsCreate,
                CallContextFieldTag.CodeHash,
                CallContextFieldTag.ProgramCounter,
                CallContextFieldTag.StackPointer,
                CallContextFieldTag.GasLeft,
                CallContextFieldTag.MemorySize,
                CallContextFieldTag.ReversibleWriteCounter,
            )
        ]

        for field_tag, expected in (
            (CallContextFieldTag.LastCalleeId, self.curr.call_id),
            (CallContextFieldTag.LastCalleeReturnDataOffset, return_data_offset),
            (CallContextFieldTag.LastCalleeReturnDataLength, return_data_length),
        ):
            self.constrain_equal(
                self.call_context_lookup(field_tag, RW.Write, call_id=caller_id), expected)

        # the callee's reversible writes accumulate into the caller only on a
        # halt in success; RETURN/REVERT pass the per-lane amount (a REVERT
        # lane's writes are already mirrored), as the JAX package does
        if accumulated_reversible is not None:
            reversible_write_counter = accumulated_reversible
        else:
            reversible_write_counter = self.fq(0)
            if self.curr.execution_state_static.halts_in_success():
                reversible_write_counter = self.curr.reversible_write_counter

        self.constrain_step_state_transition(
            rw_counter=Transition.delta(rw_counter_delta),
            call_id=Transition.to(caller_id),
            is_root=Transition.to(caller_is_root.value()),
            is_create=Transition.to(caller_is_create.value()),
            code_hash=Transition.to_word(caller_code_hash),
            program_counter=Transition.to(caller_program_counter.value()),
            stack_pointer=Transition.to(caller_stack_pointer.value()),
            gas_left=Transition.to(caller_gas_left.value() + self._f(gas_left)),
            memory_word_size=Transition.to(caller_memory_size.value()),
            reversible_write_counter=Transition.to(
                caller_reversible_write_counter.value() + reversible_write_counter),
        )

    def step_state_transition_in_same_context(
        self,
        opcode: F,
        rw_counter: Transition = None,
        program_counter: Transition = None,
        stack_pointer: Transition = None,
        memory_word_size: Transition = None,
        reversible_write_counter: Transition = None,
        dynamic_gas_cost: IntOrF = 0,
        log_id: Transition = None,
    ):
        self.responsible_opcode_lookup(opcode)

        gas_cost = self.opcode_constant_gas(opcode) + self._f(dynamic_gas_cost)
        self.constrain_gas_left_not_underflow(self.curr.gas_left - gas_cost)

        self.constrain_step_state_transition(
            rw_counter=rw_counter or Transition.same(),
            program_counter=program_counter or Transition.same(),
            stack_pointer=stack_pointer or Transition.same(),
            gas_left=Transition.delta(-gas_cost),
            memory_word_size=memory_word_size or Transition.same(),
            reversible_write_counter=reversible_write_counter or Transition.same(),
            log_id=log_id or Transition.same(),
            call_id=Transition.same(),
            is_root=Transition.same(),
            is_create=Transition.same(),
            code_hash=Transition.same_word(),
        )

    def opcode_constant_gas(self, opcode: F) -> F:
        """Per-lane constant gas cost (reference instruction.py:378)."""
        idx = opcode.limbs[..., 0].clamp(max=255)
        gas = _gas_table(opcode.limbs.device)[idx]
        return F(self.ctx, gas[..., None], 16)

    # -- math gadgets ------------------------------------------------------

    def sum(self, values: Sequence[IntOrF]) -> F:
        acc = self.fq(0)
        for v in values:
            acc = acc + self._f(v)
        return acc

    def is_zero(self, value: F) -> F:
        return F.from_bool(self.ctx, self._f(value).is_zero_mask())

    def is_equal(self, lhs: IntOrF, rhs: IntOrF) -> F:
        return F.from_bool(self.ctx, self._f(lhs).eq_mask(self._f(rhs)))

    def is_zero_word(self, word: Word) -> F:
        return self.is_zero(self.sum([word.lo, word.hi]))

    def is_equal_word(self, lhs: Word, rhs: Word) -> F:
        return F.from_bool(self.ctx, lhs.eq_mask(rhs))

    def is_u64_overflow(self, v: F) -> F:
        return F.from_bool(self.ctx, ~self._f(v).le_bits_mask(64))

    def continuous_selectors(self, value: F, n: int) -> List[F]:
        return [F.from_bool(self.ctx, F.const(self.ctx, i).lt_mask(self._f(value)))
                for i in range(n)]

    def select(self, condition: F, when_true, when_false):
        mask = ~condition.is_zero_mask()
        if isinstance(when_true, Word):
            return when_true.select(mask, when_false)
        return self._f(when_true).select(mask, self._f(when_false))

    def select_word(self, condition: F, when_true: Word, when_false: Word) -> Word:
        return when_true.select(~condition.is_zero_mask(), when_false)

    def pair_select(self, value: F, lhs: IntOrF, rhs: IntOrF) -> Tuple[F, F]:
        return self.is_equal(value, lhs), self.is_equal(value, rhs)

    def multiple_select(self, value: F, options) -> Tuple[F, ...]:
        return tuple(self.is_equal(value, o) for o in options)

    def compare(self, lhs: F, rhs: F, n_bytes: int) -> Tuple[F, F]:
        assert n_bytes <= MAX_N_BYTES
        lhs, rhs = self._f(lhs), self._f(rhs)
        # reference asserts operands fit n_bytes (instruction.py:449-450)
        self.cs.check(lhs.le_bits_mask(8 * n_bytes), lambda: f"lhs {lhs!r} exceeds {n_bytes} bytes")
        self.cs.check(rhs.le_bits_mask(8 * n_bytes), lambda: f"rhs {rhs!r} exceeds {n_bytes} bytes")
        return (F.from_bool(self.ctx, lhs.lt_mask(rhs)), F.from_bool(self.ctx, lhs.eq_mask(rhs)))

    def constant_divmod(self, numerator: IntOrF, denominator: int, n_bytes: int) -> Tuple[F, F]:
        """(numerator // d, numerator % d) for a static d, the quotient
        range-checked to n_bytes (reference instruction.py:466-477)."""
        num = self._f(numerator)
        q_arr, r_arr = L.divmod_small(num.limbs, int(denominator))
        q = F(self.ctx, q_arr, num.bits)
        r = F(self.ctx, r_arr[..., None], 16)
        self.range_check(q, n_bytes)
        return q, r

    def constant_divmod_nocheck(self, numerator: IntOrF, denominator: int) -> Tuple[F, F]:
        """``constant_divmod`` without the quotient's range check."""
        num = self._f(numerator)
        q_arr, r_arr = L.divmod_small(num.limbs, int(denominator))
        return F(self.ctx, q_arr, num.bits), F(self.ctx, r_arr[..., None], 16)

    def min(self, lhs: F, rhs: F, n_bytes: int) -> F:
        lt, _ = self.compare(lhs, rhs, n_bytes)
        return self.select(lt, lhs, rhs)

    def max(self, lhs: F, rhs: F, n_bytes: int) -> F:
        lt, _ = self.compare(lhs, rhs, n_bytes)
        return self.select(lt, rhs, lhs)

    def precompile(self, address: F) -> F:
        """1 where the address is a precompile's (0x01-0x09)."""
        mask = None
        for p in Precompile:
            m = self._f(address).eq_mask(int(p))
            mask = m if mask is None else (mask | m)
        return F.from_bool(self.ctx, mask)

    def word_to_fq(self, word: Word, n_bytes: int) -> F:
        """Constrain the word to fit n_bytes and return its value
        (reference instruction.py:480-484)."""
        if n_bytes <= 16:
            ok = word.hi.is_zero_mask() & word.lo.le_bits_mask(8 * n_bytes)
            self.cs.check(ok, lambda: f"Word {word!r} has too many bytes to fit {n_bytes} bytes")
            return F(self.ctx, trim(word.lo.limbs, width_for_bits(8 * n_bytes)),
                     min(8 * n_bytes, word.lo.bits))
        ok = word.hi.le_bits_mask(8 * (n_bytes - 16))
        self.cs.check(ok, lambda: f"Word {word!r} has too many bytes to fit {n_bytes} bytes")
        full = word.lo + word.hi * F.const(self.ctx, 1 << 128)
        return F(self.ctx, trim(full.widen(16).limbs, width_for_bits(8 * n_bytes)), 8 * n_bytes)

    def word_to_address(self, word: Word) -> F:
        return self.word_to_fq(word, N_BYTES_ACCOUNT_ADDRESS)

    def word_to_address_truncated(self, word: Word) -> F:
        """The word's low 160 bits, its high bits left unconstrained: the
        EVM truncates an address operand, so a stack word with bits above
        160 keys the access list by its low 160 bits (the JAX package's
        deviation for the error gadgets that derive an access-list key)."""
        lo32_hi = F(self.ctx, trim(word.hi.limbs, 2), min(32, word.hi.bits))
        full = word.lo + lo32_hi * F.const(self.ctx, 1 << 128)
        return F(self.ctx, trim(full.widen(16).limbs, width_for_bits(8 * N_BYTES_ACCOUNT_ADDRESS)),
                 8 * N_BYTES_ACCOUNT_ADDRESS)

    def word_to_u64(self, word: Word) -> F:
        return self.word_to_fq(word, 8)

    def address_to_word(self, addr: F) -> Word:
        """Verify 160 bits and split into lo/hi (reference instruction.py:509-513)."""
        addr = self._f(addr)
        self.cs.check(addr.le_bits_mask(8 * N_BYTES_ACCOUNT_ADDRESS),
                      lambda: f"address {addr!r} exceeds 160 bits")
        hi, lo = addr.split_pow2(128, 32)
        return Word(lo, hi)

    def compare_word(self, lhs: Word, rhs: Word) -> Tuple[F, F]:
        hi_lt, hi_eq = self.compare(lhs.hi, rhs.hi, 16)
        lo_lt, lo_eq = self.compare(lhs.lo, rhs.lo, 16)
        return hi_lt + hi_eq * lo_lt, hi_eq * lo_eq

    def add_words(self, addends: Sequence[Word]) -> Tuple[Word, F]:
        """Multi-addend 256-bit add with carry (reference arithmetic.py:236-242)."""
        lo_sum = self.sum([w.lo for w in addends])
        carry_lo, sum_lo = lo_sum.split_pow2(128, 8)
        hi_sum = self.sum([w.hi for w in addends]) + carry_lo
        carry_hi, sum_hi = hi_sum.split_pow2(128, 8)
        return Word(sum_lo, sum_hi), carry_hi

    def sub_word(self, minuend: Word, subtrahend: Word) -> Tuple[Word, F]:
        borrow_lo = minuend.lo.lt_mask(subtrahend.lo)
        diff_lo = (minuend.lo - subtrahend.lo
                   + F.from_bool(self.ctx, borrow_lo) * F.const(self.ctx, 1 << 128))
        min_hi_adj = subtrahend.hi + F.from_bool(self.ctx, borrow_lo)
        borrow_hi = minuend.hi.lt_mask(min_hi_adj)
        diff_hi = (minuend.hi - min_hi_adj
                   + F.from_bool(self.ctx, borrow_hi) * F.const(self.ctx, 1 << 128))
        return Word(diff_lo, diff_hi), F.from_bool(self.ctx, borrow_hi)

    def mul_word_by_u64(self, multiplicand: Word, multiplier: F) -> Word:
        prod_lo_full = multiplicand.lo * self._f(multiplier)  # <=192 bits exact
        quotient_lo, product_lo = prod_lo_full.split_pow2(128, 64)
        prod_hi_full = multiplicand.hi * self._f(multiplier) + quotient_lo
        quotient_hi, product_hi = prod_hi_full.split_pow2(128, 64)
        self.constrain_zero(quotient_hi)
        return Word(product_lo, product_hi)

    def _word_product(self, words: Sequence[Word], wide: bool):
        """One K11 launch over the words' lo/hi rows; records the chain's
        checks in its order (the carries' 9-byte range checks, then the
        equalities) with its messages, whose values the eager pass
        recomputes only for a failing lane.  Returns the overflow limbs
        (variant 256) or None."""
        rows = [p.limbs for w in words for p in (w.lo, w.hi)]
        ok, overflow = word_mul.mul_add_words(rows, wide)
        steps = {}

        def value(name: str) -> F:
            if not steps:
                steps.update(word_mul.chain_values(rows, wide))
            return F(self.ctx, steps[name], 254)

        n_carries = 3 if wide else 2
        for h in range(n_carries):
            self.cs.check(ok[h], lambda h=h: f"Value {value(f'carry{h}')!r} has too many "
                                             f"bytes to fit 9 bytes")
        for h in range(ok.shape[0] - n_carries):
            self.cs.check(ok[n_carries + h],
                          lambda h=h: f"Expected values to be equal, but got "
                                      f"{value(f'lhs{h}')!r} and {value(f'rhs{h}')!r}")
        return overflow

    def mul_add_words(self, a: Word, b: Word, c: Word, d: Word) -> F:
        """Constrain a*b + c == d (mod 2^256); returns overflow, a field
        value (reference instruction.py:599-632; kernel K11)."""
        return F(self.ctx, self._word_product((a, b, c, d), wide=False), 254)

    def mul_add_words_512(self, a: Word, b: Word, c: Word, d: Word, e: Word):
        """Constrain a*b + c == d*2^256 + e (reference instruction.py:634-665;
        kernel K11)."""
        self._word_product((a, b, c, d, e), wide=True)

    def is_neg_word(self, word: Word) -> F:
        return self.compare(self.fq(0x7FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF), word.hi, 16)[0]

    def byte_size(self, word: Word) -> F:
        """Witness: number of significant bytes (reference instruction.py:492-494)."""
        size = None
        for i, b in enumerate(word.to_le_bytes()):
            nz = (~b.is_zero_mask()).to(L.DTYPE) * (i + 1)
            size = nz if size is None else torch.maximum(size, nz)
        return F(self.ctx, size[..., None], 8)

    def bytes_to_fq(self, value: Sequence[F]) -> F:
        """The little-endian bytes as one field value, the last byte most
        significant (the JAX package's ``bytes_to_fq``)."""
        assert len(value) <= MAX_N_BYTES
        acc = self.fq(0)
        for i in reversed(range(len(value))):
            acc = acc * 256 + self._f(value[i])
        return acc

    def abs_word(self, x: Word) -> Tuple[Word, F]:
        """(abs(x), x_is_neg) as in reference instruction.py:539-571."""
        is_neg = self.is_neg_word(x)
        # witness: 2^256 - x (two's complement over 256 bits; 0 stays 0)
        zero = self.word(0)
        neg_lo_arr, borrow_lo = L.sub(zero.lo.widen(8).limbs, x.lo.widen(8).limbs)
        neg_hi_base, _ = L.sub(zero.hi.widen(8).limbs, x.hi.widen(8).limbs)
        neg_hi_arr, _ = L.sub(neg_hi_base, borrow_lo[..., None])
        x_neg = Word(F(self.ctx, neg_lo_arr, 128), F(self.ctx, neg_hi_arr, 128))
        x_abs = self.select_word(is_neg, x_neg, x)

        x_abs_lo, x_abs_hi = x_abs.to_lo_hi()
        x_lo, x_hi = x.to_lo_hi()
        one_minus_neg = 1 - is_neg
        self.constrain_zero((x_abs_lo - x_lo) * one_minus_neg)
        self.constrain_zero((x_abs_hi - x_hi) * one_minus_neg)

        # witness carries of x + x_abs
        s_lo = x_lo + x_abs_lo
        carry_lo, sum_lo = s_lo.split_pow2(128, 2)
        s_hi = x_hi + x_abs_hi + carry_lo
        carry_hi, sum_hi = s_hi.split_pow2(128, 2)

        self.constrain_zero(sum_lo + carry_lo * F.const(self.ctx, 1 << 128)
                            - self.sum([x_lo, x_abs_lo]))
        self.constrain_zero(sum_hi + carry_hi * F.const(self.ctx, 1 << 128) - carry_lo
                            - self.sum([x_hi, x_abs_hi]))
        self.constrain_zero((sum_lo + sum_hi) * is_neg)
        self.constrain_zero((1 - carry_hi) * is_neg)
        return x_abs, is_neg

    # -- typed lookups -----------------------------------------------------

    def fixed_lookup(self, tag: FixedTableTag, value0: F, value1: F = None, value2: F = None):
        self.tables.fixed_lookup(self.cs, tag, self._f(value0),
                                 None if value1 is None else self._f(value1),
                                 None if value2 is None else self._f(value2))

    def block_context_lookup(self, field_tag: BlockContextFieldTag, block_number: IntOrF = 0) -> F:
        return self.block_context_lookup_word(field_tag, block_number).value()

    def block_context_lookup_word(self, field_tag: BlockContextFieldTag,
                                  block_number: IntOrF = 0) -> WordOrValue:
        row = self.tables.block_lookup(self.cs, self.fq(field_tag), self._f(block_number))
        return WordOrValue(row.value)

    def tx_context_lookup(self, tx_id: F, field_tag: TxContextFieldTag) -> F:
        return self.tx_context_lookup_word(tx_id, field_tag).value()

    def tx_context_lookup_word(self, tx_id: F, field_tag: TxContextFieldTag) -> WordOrValue:
        row = self.tables.tx_lookup(self.cs, self._f(tx_id), self.fq(field_tag), self.fq(0))
        return WordOrValue(row.value)

    def tx_calldata_lookup(self, tx_id: F, call_data_index: F) -> F:
        row = self.tables.tx_lookup(self.cs, self._f(tx_id), self.fq(TxContextFieldTag.CallData),
                                    self._f(call_data_index))
        return WordOrValue(row.value).value()

    def tx_gas_price(self, tx_id: F) -> Word:
        return self.tx_context_lookup_word(tx_id, TxContextFieldTag.GasPrice)

    def tx_log_lookup(self, tx_id: F, log_id: F, field_tag: TxLogFieldTag, index: int = 0) -> F:
        return self.tx_log_lookup_word(tx_id, log_id, field_tag, index).value()

    def tx_log_lookup_word(self, tx_id: F, log_id: F, field_tag: TxLogFieldTag,
                           index: int = 0) -> WordOrValue:
        """A TxLog row: the address packs (log_id, field_tag, index) as
        index + field_tag * 2^32 + log_id * 2^48."""
        address = (self._f(log_id) * F.const(self.ctx, 1 << 48)
                   + self.fq((int(field_tag) << 32) + index))
        row = self.rw_lookup(RW.Write, Target.TxLog, id=self._f(tx_id), address=address,
                             field_tag=self.fq(0), storage_key=self.word(0))
        return WordOrValue(row.value)

    def tx_receipt_read(self, tx_id: F, field_tag: TxReceiptFieldTag,
                        rw_counter: Optional[F] = None) -> F:
        row = self.rw_lookup(RW.Read, Target.TxReceipt, id=self._f(tx_id), address=self.fq(0),
                             field_tag=self.fq(field_tag), storage_key=self.word(0),
                             rw_counter=rw_counter)
        return WordOrValue(row.value).value()

    def tx_receipt_write(self, tx_id: F, field_tag: TxReceiptFieldTag) -> F:
        row = self.rw_lookup(RW.Write, Target.TxReceipt, id=self._f(tx_id), address=self.fq(0),
                             field_tag=self.fq(field_tag), storage_key=self.word(0))
        return WordOrValue(row.value).value()

    def bytecode_lookup(self, bytecode_hash: Word, index: F, is_code: Optional[F] = None) -> F:
        row = self.tables.bytecode_lookup(
            self.cs, bytecode_hash, self.fq(BytecodeFieldTag.Byte), self._f(index),
            None if is_code is None else self._f(is_code),
        )
        return row.value

    def bytecode_lookup_pair(self, bytecode_hash: Word, index: F) -> Tuple[F, F]:
        """(byte, is_code) of a Byte row, is_code left free."""
        row = self.tables.bytecode_lookup(
            self.cs, bytecode_hash, self.fq(BytecodeFieldTag.Byte), self._f(index), None)
        return row.value, row.is_code

    def bytecode_length(self, bytecode_hash: Word) -> F:
        row = self.tables.bytecode_lookup(
            self.cs, bytecode_hash, self.fq(BytecodeFieldTag.Header), self.fq(0), self.fq(0))
        return row.value

    def copy_lookup(self, src_id, src_tag: CopyDataTypeTag, dst_id, dst_tag: CopyDataTypeTag,
                    src_addr: F, src_addr_end: F, dst_addr: F, length: F,
                    rw_counter: F, log_id: Optional[F] = None) -> Tuple[F, F]:
        """The copy event's (rwc_inc, rlc_acc) from the copy table."""
        if dst_tag == CopyDataTypeTag.TxLog:
            assert log_id is not None
            dst_addr = (self._f(dst_addr) + self.fq(int(TxLogFieldTag.Data) << 32)
                        + self._f(log_id) * F.const(self.ctx, 1 << 48))
        row = self.tables.copy_lookup(
            self.cs, src_id, self.fq(src_tag), dst_id, self.fq(dst_tag),
            self._f(src_addr), self._f(src_addr_end), self._f(dst_addr),
            self._f(length), self._f(rw_counter))
        return row.rwc_inc, row.rlc_acc

    def keccak_lookup(self, length: F, value_rlc: F) -> Word:
        row = self.tables.keccak_lookup(self.cs, self._f(length), self._f(value_rlc))
        return row.output

    def exp_lookup(self, identifier: F, is_last: F, base_limbs, exponent: Word) -> Word:
        row = self.tables.exp_lookup(self.cs, self._f(identifier), self._f(is_last), base_limbs,
                                     exponent)
        return row.exponentiation

    def sig_lookup(self, msg_hash: Word, sig_v: F, sig_r: Word, sig_s: Word,
                   recovered_addr: F, is_valid: F):
        self.tables.sig_lookup(self.cs, msg_hash, sig_v, sig_r, sig_s, recovered_addr, is_valid)

    def ecc_lookup(self, op_type: F, px: Word, py: Word, qx: Word, qy: Word,
                   input_rlc: F, outx: F, outy: F, is_valid: F):
        self.tables.ecc_lookup(self.cs, op_type, px, py, qx, qy, input_rlc, outx, outy, is_valid)

    def pow2_lookup(self, value: F, pow_lo128: F, pow_hi128: F):
        self.fixed_lookup(FixedTableTag.Pow2, value, pow_lo128, pow_hi128)

    def sign_byte_lookup(self, value: F, sign_byte: F):
        self.fixed_lookup(FixedTableTag.SignByte, value, sign_byte, self.fq(0))

    def responsible_opcode_lookup(self, opcode: F, aux: IntOrF = 0):
        self.fixed_lookup(
            FixedTableTag.ResponsibleOpcode,
            self.fq(int(self.curr.execution_state_static)),
            self._f(opcode),
            self._f(aux),
        )

    def opcode_lookup(self, is_code: bool) -> F:
        index = self.curr.program_counter + self.program_counter_offset
        self.program_counter_offset += 1
        return self.opcode_lookup_at(index, is_code)

    def opcode_lookup_at(self, index: F, is_code: bool) -> F:
        return self.bytecode_lookup(self.curr.code_hash, index, self.fq(is_code))

    def rw_lookup(
        self,
        rw: RW,
        tag: Target,
        id: Optional[F] = None,
        address: Optional[F] = None,
        field_tag: Optional[F] = None,
        storage_key: Optional[Word] = None,
        value=None,
        value_prev=None,
        aux0: Optional[Word] = None,
        rw_counter: Optional[F] = None,
    ):
        if rw_counter is None:
            rw_counter = self.curr.rw_counter + self.rw_counter_offset
            if not (isinstance(self.rw_counter_dyn, int) and self.rw_counter_dyn == 0):
                rw_counter = rw_counter + self.rw_counter_dyn
            self.rw_counter_offset += 1
        return self.tables.rw_lookup(
            self.cs, self._f(rw_counter), self.fq(rw), self.fq(tag),
            id=id, address=address, field_tag=field_tag,
            storage_key=storage_key, value=value, value_prev=value_prev,
            aux0=aux0,
        )

    def state_write(self, tag: Target, id=None, address=None, field_tag=None,
                    storage_key=None, value=None, value_prev=None, aux0=None,
                    reversion_info: Optional[ReversionInfo] = None):
        assert tag.write_with_reversion()
        row = self.rw_lookup(RW.Write, tag, id, address, field_tag, storage_key, value,
                             value_prev, aux0)
        if reversion_info is not None and self.branch(self.is_zero(reversion_info.is_persistent)):
            self.tables.rw_lookup(
                self.cs,
                rw_counter=reversion_info.rw_counter_of_reversion(),
                rw=self.fq(RW.Write),
                tag=self.fq(tag),
                id=row.id,
                address=row.address,
                field_tag=row.field_tag,
                storage_key=row.storage_key,
                value=row.value_prev,
                value_prev=row.value,
                aux0=row.aux0,
            )
        return row

    def call_context_lookup(self, field_tag: CallContextFieldTag, rw: RW = RW.Read,
                            call_id: Optional[F] = None) -> F:
        return self.call_context_lookup_word(field_tag, rw, call_id).value()

    def call_context_lookup_word(self, field_tag: CallContextFieldTag, rw: RW = RW.Read,
                                 call_id: Optional[F] = None) -> WordOrValue:
        if call_id is None:
            call_id = self.curr.call_id
        row = self.rw_lookup(rw, Target.CallContext, self._f(call_id), self.fq(field_tag))
        return WordOrValue(row.value)

    def rw_table_start_lookup(self, counter: IntOrF):
        self.rw_lookup(RW.Read, Target.Start, rw_counter=self._f(counter))

    def reversion_info(self, call_id: Optional[F] = None) -> ReversionInfo:
        rw_counter_end_of_reversion, is_persistent = [
            self.call_context_lookup(tag, call_id=call_id)
            for tag in (CallContextFieldTag.RwCounterEndOfReversion,
                        CallContextFieldTag.IsPersistent)
        ]
        return ReversionInfo(
            rw_counter_end_of_reversion,
            is_persistent,
            self.curr.reversible_write_counter if call_id is None else self.fq(0),
        )

    def tx_refund_read(self, tx_id: F) -> F:
        row = self.rw_lookup(RW.Read, Target.TxRefund, self._f(tx_id))
        return WordOrValue(row.value).value()

    def tx_refund_write(self, tx_id: F,
                        reversion_info: Optional[ReversionInfo] = None) -> Tuple[F, F]:
        row = self.state_write(Target.TxRefund, self._f(tx_id), reversion_info=reversion_info)
        return WordOrValue(row.value).value(), WordOrValue(row.value_prev).value()

    def memory_lookup(self, rw: RW, memory_address: F, call_id: Optional[F] = None) -> F:
        if call_id is None:
            call_id = self.curr.call_id
        row = self.rw_lookup(rw, Target.Memory, self._f(call_id), self._f(memory_address))
        return WordOrValue(row.value).value()

    def account_storage_read(self, account_address: F, storage_key: Word, tx_id: F) -> Word:
        row = self.rw_lookup(RW.Read, Target.AccountStorage, self._f(tx_id),
                             self._f(account_address), field_tag=None, storage_key=storage_key)
        return row.value

    def account_storage_write(self, account_address: F, storage_key: Word, tx_id: F,
                              reversion_info: Optional[ReversionInfo] = None
                              ) -> Tuple[Word, Word, Word]:
        row = self.state_write(Target.AccountStorage, self._f(tx_id), self._f(account_address),
                               storage_key=storage_key, reversion_info=reversion_info)
        return row.value, row.value_prev, row.aux0

    def account_read(self, account_address: F, account_field_tag: AccountFieldTag) -> F:
        return self.account_read_word(account_address, account_field_tag).value()

    def account_read_word(self, account_address: F,
                          account_field_tag: AccountFieldTag) -> WordOrValue:
        row = self.rw_lookup(RW.Read, Target.Account, address=self._f(account_address),
                             field_tag=self.fq(account_field_tag))
        return WordOrValue(row.value)

    def account_write(self, account_address: F, account_field_tag: AccountFieldTag,
                      reversion_info: Optional[ReversionInfo] = None) -> Tuple[F, F]:
        pair = self.account_write_word(account_address, account_field_tag, reversion_info)
        return pair[0].value(), pair[1].value()

    def account_write_word(self, account_address: F, account_field_tag: AccountFieldTag,
                           reversion_info: Optional[ReversionInfo] = None):
        row = self.state_write(Target.Account, address=self._f(account_address),
                               field_tag=self.fq(account_field_tag),
                               reversion_info=reversion_info)
        return WordOrValue(row.value), WordOrValue(row.value_prev)

    def add_balance(self, account_address: F, values: Sequence[Word],
                    reversion_info: Optional[ReversionInfo] = None) -> Tuple[Word, Word]:
        balance, balance_prev = self.account_write_word(
            account_address, AccountFieldTag.Balance, reversion_info)
        result, carry = self.add_words([balance_prev, *values])
        self.constrain_equal_word(balance, result)
        self.constrain_zero(carry)
        return balance, balance_prev

    def sub_balance(self, account_address: F, values: Sequence[Word],
                    reversion_info: Optional[ReversionInfo] = None) -> Tuple[Word, Word]:
        balance, balance_prev = self.account_write_word(
            account_address, AccountFieldTag.Balance, reversion_info)
        result, carry = self.add_words([balance, *values])
        self.constrain_equal_word(balance_prev, result)
        self.constrain_zero(carry)
        return balance, balance_prev

    def add_account_to_access_list(self, tx_id: F, account_address: F,
                                   reversion_info: Optional[ReversionInfo] = None) -> F:
        row = self.state_write(Target.TxAccessListAccount, self._f(tx_id),
                               self._f(account_address), value=self.fq(1),
                               reversion_info=reversion_info)
        return WordOrValue(row.value_prev).value()

    def add_account_storage_to_access_list(self, tx_id: F, account_address: F,
                                           storage_key: Word,
                                           reversion_info: Optional[ReversionInfo] = None) -> F:
        row = self.state_write(Target.TxAccessListAccountStorage, self._f(tx_id),
                               self._f(account_address), storage_key=storage_key,
                               value=self.fq(1), reversion_info=reversion_info)
        return WordOrValue(row.value_prev).value()

    def read_account_to_access_list(self, tx_id: F, account_address: F) -> F:
        row = self.rw_lookup(RW.Read, Target.TxAccessListAccount, self._f(tx_id),
                             self._f(account_address))
        return WordOrValue(row.value_prev).value()

    def read_account_storage_to_access_list(self, tx_id: F, account_address: F,
                                            storage_key: Word) -> F:
        row = self.rw_lookup(RW.Read, Target.TxAccessListAccountStorage, self._f(tx_id),
                             self._f(account_address), storage_key=storage_key)
        return WordOrValue(row.value).value()

    def transfer_with_gas_fee(self, sender_address: F, receiver_address: F, value: Word,
                              gas_fee: Word, reversion_info: Optional[ReversionInfo] = None):
        sender = self.sub_balance(sender_address, [value, gas_fee], reversion_info)
        receiver = self.add_balance(receiver_address, [value], reversion_info)
        return sender, receiver

    def transfer(self, sender_address: F, receiver_address: F, value: Word,
                 reversion_info: Optional[ReversionInfo] = None):
        sender = self.sub_balance(sender_address, [value], reversion_info)
        receiver = self.add_balance(receiver_address, [value], reversion_info)
        return sender, receiver

    def stack_pop(self) -> Word:
        offset = self.stack_pointer_offset
        self.stack_pointer_offset += 1
        return self.stack_lookup(RW.Read, offset)

    def stack_push(self) -> Word:
        self.stack_pointer_offset -= 1
        return self.stack_lookup(RW.Write, self.stack_pointer_offset)

    def stack_lookup(self, rw: RW, stack_pointer_offset: IntOrF) -> Word:
        stack_pointer = self.curr.stack_pointer + self._f(stack_pointer_offset)
        row = self.rw_lookup(rw, Target.Stack, self.curr.call_id, stack_pointer)
        return row.value

    # -- memory sizing and gas (go-ethereum's, reference instruction.py:
    # 1122-1336) ------------------------------------------------------------

    def memory_offset_and_length(self, offset_word: Word, length_word: Word) -> Tuple[F, F]:
        length = self.word_to_fq(length_word, N_BYTES_MEMORY_ADDRESS)
        if self.branch(self.is_zero(length)):
            return self.fq(0), self.fq(0)
        offset = self.word_to_fq(offset_word, N_BYTES_MEMORY_ADDRESS)
        return offset, length

    def memory_gas_cost(self, memory_size: F) -> F:
        memory_size = self._f(memory_size)
        quadratic_cost, _ = self.constant_divmod(
            memory_size * memory_size, MEMORY_EXPANSION_QUAD_DENOMINATOR, N_BYTES_GAS)
        return quadratic_cost + memory_size * MEMORY_EXPANSION_LINEAR_COEFF

    def memory_expansion(self, offset: F, length: F) -> Tuple[F, F]:
        if self.branch(~self._f(length).is_zero_mask()):
            memory_size, _ = self.constant_divmod(
                self._f(length) + self._f(offset) + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
        else:
            memory_size = self.fq(0)
        next_memory_size = self.max(self.curr.memory_word_size, memory_size,
                                    N_BYTES_MEMORY_WORD_SIZE)
        gas_now = self.memory_gas_cost(self.curr.memory_word_size)
        gas_next = self.memory_gas_cost(next_memory_size)
        return next_memory_size, gas_next - gas_now

    def memory_expansion_dynamic_length(self, cd_offset: F, cd_length: F,
                                        rd_offset: Optional[F] = None,
                                        rd_length: Optional[F] = None) -> Tuple[F, F]:
        cd_memory_size, _ = self.constant_divmod(
            self._f(cd_offset) + self._f(cd_length) + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
        next_memory_size = self.max(self.curr.memory_word_size, cd_memory_size,
                                    N_BYTES_MEMORY_WORD_SIZE)
        if rd_offset is not None and rd_length is not None:
            rd_memory_size, _ = self.constant_divmod(
                self._f(rd_offset) + self._f(rd_length) + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
            next_memory_size = self.max(next_memory_size, rd_memory_size,
                                        N_BYTES_MEMORY_WORD_SIZE)
        gas_now = self.memory_gas_cost(self.curr.memory_word_size)
        gas_next = self.memory_gas_cost(next_memory_size)
        return next_memory_size, gas_next - gas_now

    def memory_copier_gas_cost(self, length: F, memory_expansion_gas_cost: F,
                               gas_cost_copy: int = GAS_COST_COPY) -> F:
        word_size, _ = self.constant_divmod(self._f(length) + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
        gas_cost = word_size * gas_cost_copy + self._f(memory_expansion_gas_cost)
        self.range_check(gas_cost, N_BYTES_GAS)
        return gas_cost

    def memory_size(self, opcode: F) -> Tuple[F, F]:
        """(memory size, u64 overflow) of an opcode's memory operands, as
        go-ethereum's memorySize computes it (reference instruction.py:
        1198-1305).  The pops depend on the opcode, which is resolved
        lane-uniformly."""
        ops = (
            Opcode.SHA3, Opcode.CALLDATACOPY, Opcode.RETURNDATACOPY,
            Opcode.CODECOPY, Opcode.EXTCODECOPY, Opcode.MLOAD, Opcode.MSTORE8,
            Opcode.MSTORE, Opcode.CREATE, Opcode.CREATE2, Opcode.CALL,
            Opcode.DELEGATECALL, Opcode.STATICCALL, Opcode.CALLCODE,
            Opcode.RETURN, Opcode.REVERT, Opcode.LOG0, Opcode.LOG1,
            Opcode.LOG2, Opcode.LOG3, Opcode.LOG4,
        )
        sel = {op: self.branch(self.is_equal(opcode, int(op))) for op in ops}
        if (sel[Opcode.SHA3] or sel[Opcode.RETURN] or sel[Opcode.REVERT] or sel[Opcode.LOG0]
                or sel[Opcode.LOG1] or sel[Opcode.LOG2] or sel[Opcode.LOG3] or sel[Opcode.LOG4]):
            return self.calc_mem_size64(self.stack_pop(), self.stack_pop())
        if sel[Opcode.CALLDATACOPY] or sel[Opcode.RETURNDATACOPY] or sel[Opcode.CODECOPY]:
            self.stack_pop()
            return self.calc_mem_size64(self.stack_pop(), self.stack_pop())
        if sel[Opcode.EXTCODECOPY]:
            self.stack_pop()
            self.stack_pop()
            return self.calc_mem_size64(self.stack_pop(), self.stack_pop())
        if sel[Opcode.MLOAD]:
            return self.calc_mem_size64_with_uint(self.stack_pop(), self.fq(32))
        if sel[Opcode.MSTORE8] or sel[Opcode.MSTORE]:
            offset = self.stack_pop()
            self.stack_pop()
            return self.calc_mem_size64_with_uint(offset, self.fq(32))
        if sel[Opcode.CREATE] or sel[Opcode.CREATE2]:
            self.stack_pop()
            offset = self.stack_pop()
            size = self.stack_pop()
            if sel[Opcode.CREATE2]:
                self.stack_pop()
            return self.calc_mem_size64(offset, size)
        if (sel[Opcode.DELEGATECALL] or sel[Opcode.STATICCALL] or sel[Opcode.CALL]
                or sel[Opcode.CALLCODE]):
            if sel[Opcode.CALL] or sel[Opcode.CALLCODE]:
                self.stack_pop()
            self.stack_pop()
            self.stack_pop()
            cd_offset = self.stack_pop()
            cd_length = self.stack_pop()
            x, overflow = self.calc_mem_size64(self.stack_pop(), self.stack_pop())
            if self.branch(overflow):
                return self.fq(0), self.fq(1)
            y, overflow = self.calc_mem_size64(cd_offset, cd_length)
            if self.branch(overflow):
                return self.fq(0), self.fq(1)
            if self.branch(F.from_bool(self.ctx, y.lt_mask(x))):
                return x, self.fq(0)
            return y, self.fq(0)
        # no listed opcode: not a memory-sizing opcode, the lanes fail
        self.cs.check(torch.zeros((self.ctx.batch,), dtype=torch.bool, device=self.ctx.device),
                      lambda: "memory_size: unexpected opcode")
        return self.fq(0), self.fq(0)

    def calc_mem_size64(self, offset: Word, length: Word) -> Tuple[F, F]:
        length_v = self.word_to_fq(length, MAX_N_BYTES)
        if self.branch(self.is_u64_overflow(length_v)):
            return self.fq(0), self.fq(1)
        return self.calc_mem_size64_with_uint(offset, length_v)

    def calc_mem_size64_with_uint(self, offset_word: Word, length64: F) -> Tuple[F, F]:
        if self.branch(self.is_zero(length64)):
            return self.fq(0), self.fq(0)
        offset = self.word_to_fq(offset_word, MAX_N_BYTES)
        if self.branch(self.is_u64_overflow(offset)):
            return self.fq(0), self.fq(1)
        offset64 = self.word_to_fq(offset_word, N_BYTES_MEMORY_ADDRESS)
        val = offset64 + length64
        return val, F.from_bool(self.ctx, val.lt_mask(offset64))

    def safe_mul(self, x: F, y: F) -> Tuple[F, F]:
        mul = self._f(x) * self._f(y)
        return mul, self.is_u64_overflow(mul)

    def to_word_size(self, size: F) -> F:
        """ceil(size / 32), saturating at u64 (reference instruction.py:
        1333-1336)."""
        size = self._f(size)
        over = F.const(self.ctx, MAX_U64 - 31).lt_mask(size)
        q, _ = self.constant_divmod_nocheck(size + 31, 32)
        return q.select(~over, F.const(self.ctx, MAX_U64 // 32 + 1))

    # -- CREATE address derivation (host hint) ------------------------------

    def generate_contract_address(self, address: F, nonce: F) -> F:
        """keccak(rlp([address, nonce]))[-20:] per lane, a 160-bit hint built
        on the host by the eager trace (numpy keccak) and replayed from the
        hint stream (reference instruction.py:1356-1371)."""
        addrs = self.ints_of(self._f(address))
        nonces = self.ints_of(self._f(nonce))
        if self.ctx.eager:
            from ..ops.keccak import keccak256_batch
            from ..witness.rlp import rlp_encode

            digests = keccak256_batch([rlp_encode([a.to_bytes(20, "big"), n])
                                       for a, n in zip(addrs, nonces)])
            outs = [int.from_bytes(d[-20:], "big") for d in digests]
        else:
            outs = addrs  # dummies; f_hint replays the recorded stream
        return self.f_hint(outs, 160)

    def generate_CREAET2_contract_address(self, address: F, salt: Word, code_hash: Word) -> F:
        """keccak(0xff ++ address ++ salt ++ code_hash)[-20:] per lane, a
        160-bit hint (see ``generate_contract_address``); the salt and the
        code hash are packed little-endian, as the JAX package packs them
        (reference instruction.py:1373-1393)."""
        addrs = self.ints_of(self._f(address))
        salts = self.ints_of(salt)
        hashes = self.ints_of(code_hash)
        if self.ctx.eager:
            from ..ops.keccak import keccak256_batch

            digests = keccak256_batch([b"\xff" + a.to_bytes(20, "big") + s.to_bytes(32, "little")
                                       + h.to_bytes(32, "little")
                                       for a, s, h in zip(addrs, salts, hashes)])
            outs = [int.from_bytes(d[-20:], "big") for d in digests]
        else:
            outs = addrs  # dummies; f_hint replays the recorded stream
        return self.f_hint(outs, 160)

    # -- the error states' shared epilogue (reference instruction.py:
    # 1426-1452) -------------------------------------------------------------

    def constrain_error_state(self, rw_counter_delta: IntOrF):
        """IsSuccess is 0, a root error ends the tx, and a sub-call's
        error restores its caller's context with no return data and no
        gas."""
        rw_counter_delta = rw_counter_delta + 1
        is_success = self.call_context_lookup(CallContextFieldTag.IsSuccess)
        self.constrain_equal(is_success, self.fq(0))

        is_to_end_tx = self.is_equal(self.next.execution_state, int(ExecutionState.EndTx))
        self.constrain_equal(self.curr.is_root, is_to_end_tx)

        if self.branch(self.curr.is_root):
            self.constrain_step_state_transition(
                rw_counter=Transition.delta(rw_counter_delta),
                call_id=Transition.same(),
            )
        else:
            self.step_state_transition_to_restored_context(
                rw_counter_delta=rw_counter_delta,
                return_data_offset=self.fq(0),
                return_data_length=self.fq(0),
                gas_left=self.fq(0),
            )
