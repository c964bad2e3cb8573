"""The reference against the port on the CPU (the kernels' plain
versions), on tiny blocks of each mix: the port's witness equal to the
reference's trace row for row, and the port's verdicts equal to the ones
the reference owes the block, clean and with each kind of planted fault."""
import json
from pathlib import Path

import pytest
import torch

from zkbench import faults
from zkbench.gen.blocks import block_spec
from zkbench.reference import evm, verdicts
from zkbench.reference.keccak import keccak_int
from zkbench.run import compare_trace, program_block

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parents[1]
SMALL = {
    "sstore_heavy_30m": {"txs": 3},
    "alu_heavy_1m": {"txs": 3, "rounds": 12, "tx_gas": 21000 + 11 * 12 + 1000},
}
CHECKS = ("prologue", "bytecode", "keccak", "sig", "withdrawal", "pi")
KINDS = {"sstore_heavy_30m": ("gas_left", "stack_value", "storage_value", "memory_value",
                              "end_tx_gas", "tx_signature") + CHECKS,
         "alu_heavy_1m": ("gas_left", "stack_value", "end_tx_gas", "tx_signature") + CHECKS}


def small(name, fault_kinds):
    """A small block of the mix with one fault of each kind named (two
    of a circuit check's, in each half of its rows, where it has them)."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    plan = {k: 1 for k in fault_kinds if k not in CHECKS}
    plan["check_rows"] = {k: min(2, cfg["faults"]["check_rows"][k])
                          for k in fault_kinds if k in CHECKS}
    cfg.update(SMALL[name], faults=plan)
    return cfg


def test_keccak_vectors():
    assert keccak_int(b"") == 0xC5D2460186F7233C927E7DB2DCC703C0E500B653CA82273B7BFAD8045D85A470
    assert keccak_int(b"abc") == 0x4E03657AEA45A94FC7D47BA826C8D667C0D1E6E33A64A036EC44F58FA12D6C45
    assert keccak_int(bytes(200))  # two blocks


@pytest.mark.parametrize("name,kind", [(n, k) for n in KINDS for k in (None,) + KINDS[n]])
def test_the_port_owes_what_the_reference_says(name, kind):
    from zkevm_specs_tpu_torch.circuits.tx import sign_tx
    from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

    cfg = small(name, () if kind is None else (kind,))
    seed = 2**32 + 17
    spec = block_spec(cfg, seed)
    planted = faults.choose(cfg, seed)
    witness = program_block(cfg, spec)
    faults.plant(witness, planted, sign_tx)
    bv = CompiledBlockVerifier(witness, device="cpu")
    rows = faults.plant_checks(bv, planted)
    got = set(bv.run_device(bv.prepare()))
    ref = evm.trace(spec, cfg["header"]["coinbase"], cfg["header"]["base_fee"],
                    cfg["caller_balance"])
    want = verdicts.expected_failures(ref, planted) | verdicts.check_failures(rows)
    if kind in CHECKS:
        assert {k[0] for k in want} == {kind}
    verdicts.plant(ref, planted)
    assert compare_trace(witness, ref) == 0
    assert got == want
    assert bool(want) == (kind is not None)
