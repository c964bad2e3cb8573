"""Analytic communication-volume model of the sharded block verifier.

Counterpart of ``zkevm_specs_tpu/parallel/comm_model.py``, with its
constants restated for the port on NVIDIA H100 cards.  Given a traced
block witness and a number of ranks, it computes, from the quantities the
sharded paths move (``parallel/block_shard.py``, ``parallel/logup_shard.py``,
``parallel/shard.py``), the bytes that cross between ranks in one
verification pass and the work of each rank, and from them the
compute-to-communication ratio that bounds weak-scaling efficiency.  One
card cannot measure that efficiency; this is the analytic leg.

Run it:

    python -m zkevm_specs_tpu_torch.parallel.comm_model

The legs (each per verification pass of one block):

- EVM groups: lanes split, tables replicated: the per-lane verdicts
  gathered (1 byte a lane).
- state circuit: one packed row a rank boundary (the halo of the
  sorted-adjacency checks) and 1 byte a row of verdicts.
- logUp families: one ``all_reduce`` of both raw partial sums a family
  and rank, whatever the table's size.
- producer circuits: 1 byte a row of verdicts; the replicated ones move
  nothing.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict

from ..runtime.bounds import INT32_OPS_PER_S, fr_product_ops

# one logUp all_reduce: both sides' raw partial sums, [2, 16] int64 limbs
# (parallel/logup_shard.py:logup_sums)
LOGUP_PSUM_BYTES = 2 * 16 * 8
# int32 operations of one BN254-Fr product on the card (K1's Montgomery
# product of two 8-word operands, runtime/bounds.py:fr_product_ops)
U32_OPS_PER_FR_MUL = fr_product_ops()
# average Fr products a constraint (the JAX model's count)
FR_MULS_PER_CONSTRAINT = 2
# NVLink 4 on an H100 SXM card: 18 links, 900 GB/s both directions, so
# 450 GB/s each way (NVIDIA H100 data sheet)
NVLINK_BYTES_PER_S = 4.5e11
# the latency of one small NCCL collective between two cards: an
# assumption, not measured (the machine this port runs on has one card);
# a 2-card machine should measure it
COLLECTIVE_LATENCY_S = 1e-5


@functools.lru_cache(maxsize=1)
def state_row_bytes() -> int:
    """The bytes of one row of ``circuits/state.py:pack_state_inputs`` (its
    int64 limb columns), as a halo row carries them."""
    from ..circuits.state import StartOp, assign_state_circuit, mpt_table_from_ops, pack_state_inputs
    from ..tables.schemas import RW

    ops = [StartOp(rw_counter=1, rw=RW.Read, lexicographic_ordering_selector=0)]
    cols, _, _ = pack_state_inputs(assign_state_circuit(ops), mpt_table_from_ops(ops))
    return sum(t.shape[1] * t.element_size() for t in cols.values())


@dataclass
class CommModel:
    n_devices: int
    n_steps: int
    n_rw_rows: int
    n_constraints_per_step: int
    n_logup_families: int
    producer_rows: Dict[str, int] = field(default_factory=dict)

    # -- communication legs (bytes per pass) -------------------------------

    @property
    def evm_verdict_bytes(self) -> int:
        return self.n_steps  # 1 B a lane, gathered

    @property
    def state_halo_bytes(self) -> int:
        return (self.n_devices - 1) * state_row_bytes() + self.n_rw_rows

    @property
    def logup_bytes(self) -> int:
        return self.n_logup_families * LOGUP_PSUM_BYTES * self.n_devices

    @property
    def producer_verdict_bytes(self) -> int:
        return sum(self.producer_rows.values())

    @property
    def total_comm_bytes(self) -> int:
        return (self.evm_verdict_bytes + self.state_halo_bytes
                + self.logup_bytes + self.producer_verdict_bytes)

    # -- compute ------------------------------------------------------------

    @property
    def total_u32_ops(self) -> float:
        evm = (self.n_steps * self.n_constraints_per_step
               * FR_MULS_PER_CONSTRAINT * U32_OPS_PER_FR_MUL)
        state = self.n_rw_rows * 40 * U32_OPS_PER_FR_MUL  # ~40 products a row
        return float(evm + state)

    @property
    def ops_per_device(self) -> float:
        return self.total_u32_ops / self.n_devices

    @property
    def compute_to_comm_ratio(self) -> float:
        """int32 operations a byte between ranks, which bounds weak
        scaling: efficiency ~ 1 / (1 + (bytes / B_link) / (ops / F_card))."""
        return self.total_u32_ops / max(1, self.total_comm_bytes)

    def predicted_weak_efficiency(self, chip_u32_ops_per_s: float = INT32_OPS_PER_S,
                                  link_bytes_per_s: float = NVLINK_BYTES_PER_S,
                                  latency_s: float = COLLECTIVE_LATENCY_S,
                                  n_collectives: int = 40) -> float:
        """Roofline-style bound: the compute time against the time of the
        bytes and of the collectives' latency.

        Defaults, for NVIDIA H100 SXM cards: the int32 issue rate
        (``runtime/bounds.py``, 1.673e13 op/s), NVLink 4 at 450 GB/s each
        way, and ``COLLECTIVE_LATENCY_S`` a collective (assumed)."""
        t_compute = self.ops_per_device / chip_u32_ops_per_s
        t_comm = (self.total_comm_bytes / self.n_devices) / link_bytes_per_s
        t_lat = latency_s * n_collectives
        return t_compute / (t_compute + t_comm + t_lat)


def model_from_witness(witness, n_devices: int, n_logup_families: int = 10) -> CommModel:
    """The model of a traced block witness's own sizes."""
    producer_rows = {
        "bytecode": sum(len(bc.code) + 1 for bc in witness.bytecodes),
        "copy": len(witness.copy_circuit.rows) if witness.copy_circuit else 0,
        "exp": len(witness.exp_circuit.rows) if witness.exp_circuit else 0,
        "tx": len(witness.txs),
        "withdrawal": max(1, len(witness.withdrawals)),
    }
    return CommModel(
        n_devices=n_devices,
        n_steps=len(witness.steps),
        n_rw_rows=len(witness.rw.rws),
        n_constraints_per_step=29,  # the ADD group's constraints a lane
        n_logup_families=n_logup_families,
        producer_rows=producer_rows,
    )


def row(m: CommModel, label: str) -> dict:
    return {
        "workload": label,
        "devices": m.n_devices,
        "steps": m.n_steps,
        "rw_rows": m.n_rw_rows,
        "comm_bytes": m.total_comm_bytes,
        "u32_ops_per_device": round(m.ops_per_device),
        "ops_per_comm_byte": round(m.compute_to_comm_ratio, 1),
        "predicted_efficiency": round(m.predicted_weak_efficiency(), 4),
    }


def main() -> None:
    import json

    from ..witness.tracer import trace_block
    from ..witness.typing import Block, Bytecode, Transaction

    # a step-dense block (the ALU mix, cut down)
    txs = []
    for i in range(4):
        bc = Bytecode()
        for j in range(500):
            bc.push1(j & 0xFF).push1((j + 1) & 0xFF).add().pop()
        bc.stop()
        txs.append((Transaction(id=i + 1, gas=50000, gas_price=int(2e9), caller_address=0xFE,
                                callee_address=0xFF + i), bc))
    w = trace_block(Block(base_fee=int(1e9)), txs, sign=False)
    base = model_from_witness(w, 1)

    # strong scaling of the small block: latency-bound at many ranks
    for n in (2, 8, 64):
        print(json.dumps(row(model_from_witness(w, n), "traced-8k-steps (strong)")))

    # weak scaling: one ~350k-step ALU block a rank, the traced block's
    # step / rw / producer ratios scaled up
    scale = 352_000 / base.n_steps
    for n in (2, 8, 64):
        m = CommModel(
            n_devices=n,
            n_steps=int(base.n_steps * scale) * n,
            n_rw_rows=int(base.n_rw_rows * scale) * n,
            n_constraints_per_step=base.n_constraints_per_step,
            n_logup_families=base.n_logup_families,
            producer_rows={k: v * n for k, v in base.producer_rows.items()},
        )
        print(json.dumps(row(m, "1M-gas-ALU-per-device (weak)")))


if __name__ == "__main__":
    main()
