"""Standalone circuits of the port: the state circuit and the bytecode
circuit (counterparts of ``zkevm_specs_tpu/circuits/``)."""
