"""Carries a compiled group's inputs onto a device.

``inputs_from_numpy`` takes what the JAX package's
``CompiledGroupVerifier.prepare_inputs`` returns (step columns, the tables
tree and the hint stream, as numpy ``uint32`` limb arrays and ``int32``
hint indexes) and returns the port's tensors: limbs as ``int64``, hint
indexes as ``int32``.  The port's own ``prepare_inputs`` uses the same
conversion, so both packages' witnesses enter the replay the same way.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(tree, device):
    """Recursively move a tree of dicts/lists of arrays onto ``device``:
    int32 arrays (hint indexes) stay int32, every other array becomes an
    int64 limb tensor."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        arr = np.asarray(tree)
        t = torch.from_numpy(np.ascontiguousarray(
            arr if arr.dtype == np.int32 else arr.astype(np.int64)))
    return t.to(device).contiguous()


def inputs_from_numpy(curr_cols, next_cols, tables_tree, hints, device):
    """The JAX verifier's ``prepare_inputs`` output as the port's replay
    inputs on ``device``."""
    return (to_device(curr_cols, device), to_device(next_cols, device),
            to_device(tables_tree, device), to_device(list(hints), device))
