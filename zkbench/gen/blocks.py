"""The one generator of the benchmark's blocks: a configuration's tx
template (``round`` repeated ``rounds`` times, then ``tail``) made into a
block spec, its operands drawn from the seed.

Operand kinds: a number is a constant; ``"byte"`` a byte in 0..255 and
``"nonzero_byte"`` one in 1..255; ``"slot"`` a fresh 16-bit storage slot,
distinct from every other in the block; ``"same_slot"`` the round's last
slot again.  With ``"code": "shared"`` the operands are drawn once a round
and every tx runs the same code (one bytecode in the block), with
``"per_tx"`` a tx at a time.  Sizes never depend on the seed: only the
operands do.

Copied and seeded from ``zkevm_specs_tpu_torch/workloads.py``:
``alu_block_txs`` (:274-288, ``bench.py:_alu_heavy_txs``) and
``sstore_block_txs`` (:367-383, ``bench.py:_sstore_heavy_txs``)."""
from __future__ import annotations

import random
from typing import List

from ..reference.evm import MNEMONIC, Tx

PUSH_BYTES = {"PUSH1": 1, "PUSH2": 2}


def _operand(kind, rng: random.Random, slots: set, state: dict) -> int:
    if isinstance(kind, int):
        return kind
    if kind == "byte":
        return rng.randrange(256)
    if kind == "nonzero_byte":
        return rng.randrange(1, 256)
    if kind == "slot":
        while True:
            s = rng.randrange(1 << 16)
            if s not in slots:
                slots.add(s)
                state["slot"] = s
                return s
    if kind == "same_slot":
        return state["slot"]
    raise ValueError(f"unknown operand kind {kind!r}")


def _code(config: dict, rng: random.Random, slots: set) -> bytes:
    out = bytearray()
    state: dict = {}
    for part, times in ((config["round"], config["rounds"]), (config["tail"], 1)):
        for _ in range(times):
            for ins in part:
                name = ins[0]
                out.append(MNEMONIC[name])
                if name in PUSH_BYTES:
                    out += _operand(ins[1], rng, slots, state).to_bytes(PUSH_BYTES[name], "big")
    return bytes(out)


def block_spec(config: dict, seed: int) -> List[Tx]:
    """The block's txs for ``seed``: tx i (ids from 1) calls ``callee_base``
    + i - 1 with ``tx_gas`` at ``gas_price``."""
    rng = random.Random(f"{config['name']}/{seed}")
    slots: set = set()
    shared = _code(config, rng, slots) if config["code"] == "shared" else None
    return [Tx(id=i + 1, gas=config["tx_gas"], gas_price=config["gas_price"],
               callee=config["callee_base"] + i, code=shared or _code(config, rng, slots))
            for i in range(config["txs"])]


def instructions_per_tx(config: dict) -> int:
    """The steps a tx runs between its BeginTx and its EndTx."""
    return len(config["round"]) * config["rounds"] + len(config["tail"])
