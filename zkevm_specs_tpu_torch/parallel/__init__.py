"""Lookup argument of a block (``logup_shard``), at world size 1: the
counterpart of ``zkevm_specs_tpu/parallel/``'s logUp argument; the
multi-device layer is not ported."""
