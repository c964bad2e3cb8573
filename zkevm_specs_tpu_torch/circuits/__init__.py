"""Standalone circuits of the port: the state, bytecode, keccak and
withdrawal circuits (counterparts of ``zkevm_specs_tpu/circuits/``)."""
