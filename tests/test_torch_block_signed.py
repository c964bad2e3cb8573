"""The port's block verifier against the JAX package's on signed blocks
and the SSTORE-heavy mix, on the CPU, tolerance 0: ``test_torch_block``'s
checks (the group partition, every group's lane bits, every circuit's rows
and the failure dicts of both device passes) on its ``SIGNED_KINDS``:
the 2 x 6 block signed, one shared caller, calldata, tx 0 re-signed with
key 0xBAD, and ``bench.py``'s SSTORE-heavy pattern at 2 txs, clean, with
one SSTORE's written value + 1 and with one copy row's ``rlc_acc`` + 1.
The tx, sig and copy circuits run in the port's verifier exactly where the
JAX verifier runs them."""
import pytest

import test_torch_block as B


@pytest.mark.parametrize("kind", B.SIGNED_KINDS)
def test_partition_matches_jax(kind, monkeypatch):
    B.test_partition_matches_jax(kind, monkeypatch)


@pytest.mark.parametrize("kind", B.SIGNED_KINDS)
def test_group_lane_bits_match_jax(kind, monkeypatch):
    B.test_group_lane_bits_match_jax(kind, monkeypatch)


@pytest.mark.parametrize("circuit", ("state",) + B.CIRCUITS)
@pytest.mark.parametrize("kind", B.SIGNED_KINDS)
def test_circuit_rows_match_jax(kind, circuit, monkeypatch):
    B.test_circuit_rows_match_jax(kind, circuit, monkeypatch)


@pytest.mark.parametrize("kind", B.SIGNED_KINDS)
def test_failures_match_jax(kind, monkeypatch):
    B.test_failures_match_jax(kind, monkeypatch)


def test_circuit_order_matches_jax(monkeypatch):
    """The copy circuit runs after keccak, the tx and sig circuits before
    the withdrawal and pi circuits, as in the JAX verifier."""
    _, pbv, _, _ = B._sides("sstore", monkeypatch)
    assert [name for name, _ in pbv.circuit_kernels] == [
        "prologue", "bytecode", "keccak", "copy", "tx", "sig", "withdrawal", "pi"]


def test_sstore_block_state_rows_and_lookups(monkeypatch):
    """The SSTORE mix brings Storage, TxAccessListAccountStorage and
    TxRefund rows into the block's state circuit, and copy and keccak
    lookups into its logUp log; every family's argument holds on the clean
    block and the rw family's fails on the corrupted value."""
    from zkevm_specs_tpu_torch.tables.schemas import Target

    _, pbv, prepared, _ = B._sides("sstore", monkeypatch)
    keys = {r["key0"] for r in pbv.witness.rw.rws}
    assert {int(Target.AccountStorage), int(Target.TxAccessListAccountStorage),
            int(Target.TxRefund), int(Target.Memory)} <= keys
    assert {"copy", "keccak", "rw"} <= set(pbv.lookup_log)
    ok = pbv.verify_lookups(prepared)
    assert ok and all(ok.values()) and {"copy", "keccak"} <= set(ok)
