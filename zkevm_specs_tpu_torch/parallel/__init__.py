"""Verification over ranks (``torch.distributed``): the mesh, the sharded
EVM groups and state circuit (``shard``), the lookup argument over ranks
(``logup_shard``), the sharded block verifier (``block_shard``), the
communication model (``comm_model``) and the weak-scaling harness
(``scaling``): the counterpart of ``zkevm_specs_tpu/parallel/``."""
