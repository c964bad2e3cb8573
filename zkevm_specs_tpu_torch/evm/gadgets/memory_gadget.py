"""Bounded buffer-read selectors (reference: evm_circuit/util/memory_gadget.py:5-40).

Counterpart of ``zkevm_specs_tpu/evm/gadgets/memory_gadget.py``.  The
distance of each byte to the buffer's end is a host hint, recorded by the
eager pass and replayed on the card."""
from ...dsl.value import F
from ...utils.param import N_BYTES_MEMORY_ADDRESS
from ..instruction import Instruction


class BufferReaderGadget:
    def __init__(self, inst: Instruction, max_bytes: int, addr_start: F, addr_end: F,
                 bytes_left: F):
        self.instruction = inst
        self.selectors = inst.continuous_selectors(bytes_left, max_bytes)
        # witness: the distance to the buffer's end, saturating at 0
        starts = inst.ints_of(addr_start)
        ends = inst.ints_of(addr_end)
        self.bound_dist = [
            inst.f_hint([max(0, e - s - i) for s, e in zip(starts, ends)], 64)
            for i in range(max_bytes)
        ]
        self.bound_dist_is_zero = [inst.is_zero(bd) for bd in self.bound_dist]

        inst.constrain_equal(
            self.bound_dist[0],
            addr_end - inst.min(addr_end, addr_start, N_BYTES_MEMORY_ADDRESS),
        )
        for i in range(1, max_bytes):
            diff = self.bound_dist[i - 1] - self.bound_dist[i]
            inst.constrain_equal(
                diff, inst.select(self.bound_dist_is_zero[i - 1], inst.fq(0), inst.fq(1)))

    def constrain_byte(self, idx: int, byte: F):
        self.instruction.constrain_zero(byte * (1 - self.selectors[idx]))
        self.instruction.constrain_zero(byte * self.bound_dist_is_zero[idx])

    def num_bytes(self) -> F:
        return self.instruction.sum(self.selectors)

    def has_data(self, idx: int) -> F:
        return self.selectors[idx]

    def read_flag(self, idx: int) -> F:
        return self.selectors[idx] * (1 - self.bound_dist_is_zero[idx])
