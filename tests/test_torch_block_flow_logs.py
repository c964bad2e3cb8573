"""tests/test_block_logs.py's blocks through the port's tracer and block
verifier, against the JAX package, on the CPU, tolerance 0: LOG0-LOG4 with
their data, several logs in one tx and across txs, a log without data, a
corrupted topic and a corrupted receipt LogLength, and a log in a frame that reverts, held by
``test_torch_block_flow_sweeps.check`` (equal witnesses row for row, and
the JAX verifier's failure dict in spec mode on both of the port's device
passes)."""
import pytest

import test_torch_block_flow_sweeps as S
from zkevm_specs_tpu_torch.tables.schemas import Target, TxReceiptFieldTag


@pytest.mark.parametrize("kind", sorted(S.LOGS))
def test_log_blocks_match_jax(kind, monkeypatch):
    S.check(kind, monkeypatch)


def test_reverted_log_is_not_traced(monkeypatch):
    """tests/test_block_logs.py:test_reverted_log_not_counted's block: the
    LOG1 of a frame that reverts leaves no TxLog row and a LogLength of 0,
    in the port as in the JAX package."""
    w = S.check("reverted_log", monkeypatch)
    assert w.tx_success == [False]
    assert not any(r["key0"] == int(Target.TxLog) for r in w.rw.rws)
    assert [r["value"] for r in w.rw.rws if r["key0"] == int(Target.TxReceipt)
            and r["field_tag"] == int(TxReceiptFieldTag.LogLength)] == [0]
