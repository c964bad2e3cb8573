"""The device runner of the standalone circuits.

Counterpart of ``zkevm_specs_tpu/runtime/kernels.py``.  Every standalone
circuit is a batched constraint body ``check(ctx, cs, cols, tables, static,
extra)`` over ``F``/``Word`` columns.  The same body runs

* eagerly on host tensors (``run_spec``: spec mode, exact failure
  messages), and
* on the card (``CircuitKernel``): the columns, the lookup tables and their
  prebuilt indexes are packed into flat limb trees and uploaded once, and
  each call runs the body in a "device" context, where lookups search the
  uploaded index with kernel K6, and returns the per-row fail bits.

PyTorch runs eagerly, so there is no compile step and no cache of compiled
programs: a call is one Python pass that launches the kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..tables.engine import Table
from .convert import to_device


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pack_value(v: Union[F, Word]):
    """An F/Word as (host limb arrays, static bits)."""
    if isinstance(v, Word):
        return ({"lo": _host(v.lo.limbs), "hi": _host(v.hi.limbs)},
                ("word", v.lo.bits, v.hi.bits))
    return {"f": _host(v.limbs)}, ("f", v.bits)


def unpack_value(ctx: Ctx, arrs, meta) -> Union[F, Word]:
    if meta[0] == "word":
        return Word(F(ctx, arrs["lo"], meta[1]), F(ctx, arrs["hi"], meta[2]))
    return F(ctx, arrs["f"], meta[1])


def pack_values(values: Dict[str, Union[F, Word]]):
    tree, meta = {}, {}
    for k, v in values.items():
        tree[k], meta[k] = pack_value(v)
    return tree, meta


def unpack_values(ctx: Ctx, tree, meta) -> Dict[str, Union[F, Word]]:
    return {k: unpack_value(ctx, tree[k], meta[k]) for k in tree}


def pack_table(t: Table):
    """An eagerly built table: its columns and every prebuilt sorted index
    (fingerprints as numpy ``uint64``, orders as ``int64``; the spans stay
    static, in the meta)."""
    cols_tree, cols_meta = pack_values(t.data)
    idx_tree = {"/".join(s): {"fps": np.asarray(fps), "order": np.asarray(order)}
                for s, (fps, order, _) in t._indexes.items()}
    spans = {"/".join(s): span for s, (_, _, span) in t._indexes.items()}
    meta = {"schema": t.schema, "n_rows": t.n_rows, "cols": cols_meta, "spans": spans}
    return {"cols": cols_tree, "idx": idx_tree}, meta


def unpack_table(ctx: Ctx, tree, meta) -> Table:
    data = unpack_values(ctx, tree["cols"], meta["cols"])
    t = Table(ctx, meta["schema"], data, meta["n_rows"])
    for key, d in tree["idx"].items():
        t._indexes[tuple(key.split("/"))] = (d["fps"], d["order"], meta["spans"][key])
    return t


def _ctx_of(cols) -> Ctx:
    v = next(iter(cols.values()))
    return (v.lo if isinstance(v, Word) else v).ctx


def require_device(device, name: str) -> torch.device:
    """``device`` as a torch device; raises for "cuda" without a CUDA device
    (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{name}: device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to check on the CPU")
    return device


class CircuitKernel:
    """One standalone circuit check on ``device`` ("cuda" unless the caller
    asks for "cpu"; there is no fallback).

    ``check``: fn(ctx, cs, cols: dict[str, F|Word], tables: dict[str, Table],
    static: dict, extra: dict) -> None, recording constraints into cs.
    ``cols`` share the batch dimension (the circuit's row count); tables
    are read-only lookup sides, packed with the indexes built on them.
    """

    def __init__(self, name: str, check: Callable,
                 cols: Dict[str, Union[F, Word]],
                 tables: Optional[Dict[str, Table]] = None,
                 static: Optional[dict] = None,
                 extra: Optional[dict] = None,
                 device="cuda"):
        self.device = require_device(device, f"CircuitKernel {name}")
        self.name = name
        self.check = check
        self.static = static or {}
        self.n = _ctx_of(cols).batch
        cols_tree, self.cols_meta = pack_values(cols)
        tbl_tree, self.tbl_meta = {}, {}
        for tname, t in (tables or {}).items():
            tbl_tree[tname], self.tbl_meta[tname] = pack_table(t)
        # extra: raw arrays passed through untyped (to_device keeps bool and
        # uint8 leaves, and carries uint32 ones as int64)
        extra_tree = {k: np.asarray(v) for k, v in (extra or {}).items()}
        self.args = (cols_tree, tbl_tree, extra_tree)
        self._device_args = None

    def device_args(self):
        """The packed inputs on the device, uploaded on the first call."""
        if self._device_args is None:
            self._device_args = to_device(self.args, self.device)
        return self._device_args

    def __call__(self, args=None, n: Optional[int] = None) -> torch.Tensor:
        """Run the check on the device; the ``[n]`` bool fail bits there.
        ``n``: the rows of ``args`` where they are a share of the circuit's
        rows (a rank's, ``parallel/block_shard.py``)."""
        cols_tree, tbl_tree, extra_tree = args if args is not None else self.device_args()
        ctx = Ctx(self.device, self.n if n is None else n, "device")
        cs = ConstraintSystem(ctx)
        cols = unpack_values(ctx, cols_tree, self.cols_meta)
        tables = {k: unpack_table(ctx, v, self.tbl_meta[k]) for k, v in tbl_tree.items()}
        self.check(ctx, cs, cols, tables, self.static, extra_tree)
        return cs.fail


def run_spec(name: str, check: Callable, cols, tables=None, static=None,
             extra=None, success: bool = True, label: str = "row"):
    """Eager evaluation of the same constraint body on host tensors, with
    the reference's verdict semantics (the earliest failing lane raises)."""
    ctx = _ctx_of(cols)
    cs = ConstraintSystem(ctx)
    extra_t = to_device({k: np.asarray(v) for k, v in (extra or {}).items()}, ctx.device)
    check(ctx, cs, cols, tables or {}, static or {}, extra_t)
    fail = cs.fail.numpy()
    if success:
        if fail.any():
            i = int(np.argmax(fail))
            raise AssertionError(f"{name} {label} {i}: {cs.first_failure_message()[i]}")
    else:
        assert fail.any(), f"expected {name} circuit to fail"
