"""tests/test_block_logs.py's blocks through the port's tracer and block
verifier, against the JAX package, on the CPU, tolerance 0: LOG0-LOG4 with
their data, several logs in one tx and across txs, a log without data, a
corrupted topic and a corrupted receipt LogLength, held by
``test_torch_block_flow_sweeps.check`` (equal witnesses row for row, and
the JAX verifier's failure dict in spec mode on both of the port's device
passes).  The sweep's reverted frame needs REVERT, which the port does not
trace yet."""
import pytest

import test_torch_block_flow_sweeps as S
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY


@pytest.mark.parametrize("kind", sorted(S.LOGS))
def test_log_blocks_match_jax(kind, monkeypatch):
    S.check(kind, monkeypatch)


def test_reverted_log_is_not_traced():
    """tests/test_block_logs.py:test_reverted_log_not_counted ends its frame
    with REVERT, which is not ported: the tracer refuses it."""
    bc = PY.Bytecode().push32(0xAA).push1(0).mstore()
    bc = S._emit_log(bc, [0x030201], 0, 4).push1(0).push1(0).revert()
    with pytest.raises(NotImplementedError, match="no handler"):
        PT.trace_block(PY.Block(base_fee=int(1e9)), [(S._log_tx(PY, 1), bc)])
