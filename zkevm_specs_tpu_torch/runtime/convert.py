"""Carries a check's inputs onto a device.

``to_device`` takes a tree of dicts/lists of arrays, as the JAX package's
``CompiledGroupVerifier.prepare_inputs``, ``pack_state_inputs`` and
``CircuitKernel`` build them (numpy ``uint32`` limb arrays, ``int32`` hint
indexes, ``uint64`` fingerprints, ``int64`` orders, and a circuit's extra
arrays: ``bool`` masks, ``uint8`` byte columns, ``uint32`` words) or as the
port builds them (CPU tensors), and returns the port's tensors on the
device: ``uint32`` arrays (limbs, words) as ``int64`` of the same values,
``int32`` and ``int64`` arrays as they are, ``bool`` and ``uint8`` arrays as
they are (a byte column stays one byte an element), and u64 fingerprints
as the ``int64`` view of the same bits (their values are never converted).
``inputs_from_numpy`` is the group verifier's case.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint64:
        return torch.from_numpy(arr.view(np.int64))
    if arr.dtype in (np.int32, np.int64, np.bool_, np.uint8):
        return torch.from_numpy(arr)
    return torch.from_numpy(arr.astype(np.int64))


def to_device(tree, device):
    """Recursively move a tree of dicts/lists/tuples of arrays onto
    ``device``: int32, int64, bool and uint8 arrays keep their type, uint64
    arrays (fingerprints) become their int64 view, every other array (the
    uint32 limbs and words) becomes int64 of the same values."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return _leaf(tree).to(device).contiguous()


def inputs_from_numpy(curr_cols, next_cols, tables_tree, hints, device):
    """The JAX verifier's ``prepare_inputs`` output as the port's replay
    inputs on ``device``."""
    return (to_device(curr_cols, device), to_device(next_cols, device),
            to_device(tables_tree, device), to_device(list(hints), device))
