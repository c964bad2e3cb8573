"""The benchmark's plain reference: an EVM tracer of its own for the block
mixes' opcodes, Keccak-256 and secp256k1 on Python ints, and the verdicts a
block verifier owes a witness with the benchmark's planted faults.

Nothing here imports ``jax``, ``zkevm_specs_tpu`` or
``zkevm_specs_tpu_torch``: the constants are the zkEVM specification's,
written out again, and every value is worked out from the transactions."""
