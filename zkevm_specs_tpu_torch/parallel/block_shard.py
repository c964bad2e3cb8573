"""Whole-block verification over ranks: the sharded block verifier.

Counterpart of ``zkevm_specs_tpu/parallel/block_shard.py``.
``ShardedBlockVerifier`` runs a traced block witness over a mesh of
``torch.distributed`` ranks (``parallel/shard.py``: 1-D ``rows`` or 2-D
hosts x chips), so that no rank holds the whole rw table:

1. every EVM step group's lanes are split over the ranks
   (``shard_evm_group``: each rank replays its share, the tables
   replicated, the per-lane verdicts gathered); host groups run on the
   host, on every rank, as in the single-device verifier;
2. the state circuit proving the rw table runs on each rank's share of
   the rows with a one-row halo from its neighbours
   (``sharded_state_circuit``);
3. the lookup families are proven by the logUp argument with both sides
   split over the ranks (``parallel/logup_shard.py``): each rank
   fingerprints its own share of the table and of the queries, and one
   ``all_reduce`` a mesh axis combines the sums;
4. the producer circuits run each on its rows' shares where its body
   reads no row but its own, or only the rows after it that a halo
   supplies, and replicated on every rank otherwise
   (``PRODUCER_HALO``; ``producer_placement`` says which ran how).

``verify()`` raises with the failing step indexes, state rows, lookup
families and circuit rows, in the JAX message's format.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime.block import CompiledBlockVerifier
from ..runtime.convert import to_device
from .logup_shard import ALPHA, LOGUP_TABLES, verify_block_lookups_logup
from .shard import Mesh, halo_rows, shard_evm_group, sharded_state_circuit

# The producer circuits whose rows are split over the ranks, each with the
# rows after its own that its body reads (cyclically: row i reads rows i+1
# .. i+halo), which a halo from the next rank supplies.  The others run
# replicated: the prologue reads each row's own index and rows at arbitrary
# partner indexes; withdrawal reads its first and last rows by index and
# the row before each; pi gathers bytes at arbitrary indexes for its copy
# constraints and reads its rows' indexes; keccak, tx, sig and sig_trace
# keep per-row byte columns with the rows on their second axis.
PRODUCER_HALO: Dict[str, int] = {"ecc": 0, "bytecode": 1, "exp": 1, "copy": 2}


def _split_rows(tree, n: int, lo: int, hi: int):
    """The rows ``[lo, hi)`` of every leaf whose leading axis is the
    circuit's ``n`` rows (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _split_rows(v, n, lo, hi) for k, v in tree.items()}
    a = np.asarray(tree)
    return a[lo:hi] if a.ndim >= 1 and a.shape[0] == n else a


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _with_leaves(tree, it):
    if isinstance(tree, dict):
        return {k: _with_leaves(tree[k], it) for k in sorted(tree)}
    return next(it)


class ShardedBlockVerifier:
    """A block witness verified over the ranks of ``mesh``.  The port's
    ``CompiledBlockVerifier`` is built on every rank from the same witness
    (the SPMD idiom: tracing is deterministic, so every rank repeats the
    same build on the host); the checks then run on each rank's share on
    ``mesh.device``."""

    def __init__(self, witness, mesh: Mesh, axes: Tuple[str, ...] = ("rows",),
                 logup_tables: Tuple[str, ...] = LOGUP_TABLES, alpha: int = ALPHA):
        self.mesh = mesh
        self.axes = axes
        self.alpha = alpha
        self.logup_tables = logup_tables
        self.n_dev = mesh.size_of(axes)
        assert self.n_dev == mesh.size, "the axes must cover the mesh"
        self.inner = CompiledBlockVerifier(witness, device=mesh.device)
        self.witness = witness
        self._tables_dev = None
        self.producer_placement: Dict[str, str] = {}

    # -- pieces ---------------------------------------------------------------

    def _tables_tree(self):
        """The device groups' shared table tree, uploaded once (replicated)."""
        if self._tables_dev is None:
            g = next((g for g in self.inner.groups if g["verifier"] is not None), None)
            if g is not None:
                self._tables_dev = to_device(g["verifier"].tables_tree, self.mesh.device)
        return self._tables_dev

    def verify_evm_groups(self) -> Dict[int, bool]:
        """All step groups, lanes split over the ranks; returns
        ``{step_index: True}`` for the failing real lanes."""
        failures: Dict[int, bool] = {}
        for g in self.inner.groups:
            if g["verifier"] is None:
                # tiny subgroup, verified on the host (runtime/block.py)
                fail = self.inner._run_eager_group(g)
            else:
                fail = shard_evm_group(g["verifier"], g["curr"], g["next"], self.mesh,
                                       self._tables_tree()).cpu().numpy()
            for lane, i in enumerate(g["idxs"]):
                if fail[lane]:
                    failures[i] = True
        return failures

    def verify_state(self) -> np.ndarray:
        """The state circuit with its rows split over the ranks (padding
        rows, copies of the leading Start row, are masked out); the
        ``[rows]`` fail bits."""
        return sharded_state_circuit(self.inner._state_rows, self.inner._state_mpt,
                                     self.mesh).cpu().numpy()

    def verify_lookups(self, corrupt_table=None) -> Dict[str, bool]:
        """The logUp argument of every family the block looks up, both
        sides split over the ranks; ``corrupt_table(name, parts)`` may
        tamper with a copy of the table side (tests of the binding)."""
        return verify_block_lookups_logup(
            self.witness, tables_names=self.logup_tables, corrupt_table=corrupt_table,
            log=(self.inner.tables, self.inner.lookup_log), mesh=self.mesh, axes=self.axes,
            alpha=self.alpha)

    def _run_split(self, kernel, halo: int) -> torch.Tensor:
        """One circuit on this rank's share of its rows (which the mesh
        divides evenly) and the ``halo`` rows after it, the tables
        replicated; the halo rows' verdicts dropped, the rest gathered."""
        n, mesh = kernel.n, self.mesh
        lo, hi, size = mesh.share(n)
        cols, tbls, extra = kernel.args
        own = to_device({"cols": _split_rows(cols, n, lo, hi), "extra": _split_rows(extra, n, lo, hi)},
                        mesh.device)
        if halo:
            leaves = _leaves(own, [])
            _, after = halo_rows(mesh, leaves, 0, halo)
            own = _with_leaves(own, iter([torch.cat([t, q]) for t, q in zip(leaves, after)]))
        fail = kernel((own["cols"], to_device(tbls, mesh.device), own["extra"]), n=size + halo)
        return mesh.all_gather(fail[:size])

    def verify_producers(self) -> Dict[str, np.ndarray]:
        """Every producer circuit (prologue, bytecode, keccak, copy, exp,
        tx, sig, ecc, sig_trace, withdrawal, pi) on the mesh: split over
        the ranks where ``PRODUCER_HALO`` names it and its rows divide
        evenly into shares of at least its halo, replicated otherwise.
        Returns ``{circuit: per-row fail bits}``, the single-device
        verifier's verdict set; ``producer_placement`` records where each
        ran."""
        out: Dict[str, np.ndarray] = {}
        self.producer_placement = {}
        for name, kernel in self.inner.circuit_kernels:
            halo = PRODUCER_HALO.get(name)
            share = kernel.n // self.n_dev
            if halo is not None and kernel.n % self.n_dev == 0 and share >= max(halo, 1):
                out[name] = self._run_split(kernel, halo).cpu().numpy()
                self.producer_placement[name] = "sharded"
            else:
                out[name] = kernel(to_device(kernel.args, self.mesh.device)).cpu().numpy()
                self.producer_placement[name] = "replicated"
        return out

    def check(self) -> Tuple[Dict[object, bool], Dict[str, bool]]:
        """Every verdict of the block: the failures of the step groups, the
        state circuit and the producer circuits as
        ``CompiledBlockVerifier.run_device`` keys them (``{step index |
        ("state", row) | (circuit, row): True}``), and ``{family: ok}`` of
        the lookup argument."""
        failures: Dict[object, bool] = dict(self.verify_evm_groups())
        for r in np.flatnonzero(self.verify_state()):
            failures[("state", int(r))] = True
        lookups = self.verify_lookups()
        for name, fail in self.verify_producers().items():
            for r in np.flatnonzero(fail):
                failures[(name, int(r))] = True
        return failures, lookups

    @staticmethod
    def message(failures: Dict[object, bool], lookups: Dict[str, bool]) -> Optional[str]:
        """``verify``'s message for these verdicts (the JAX format), None
        where there is no failure."""
        problems = []
        steps = sorted(k for k in failures if isinstance(k, int))
        if steps:
            problems.append(f"steps {steps[:8]}")
        rows: Dict[str, list] = {}
        for k in failures:
            if isinstance(k, tuple):
                rows.setdefault(k[0], []).append(k[1])
        if "state" in rows:
            problems.append(f"state rows {sorted(rows.pop('state'))[:8]}")
        bad_tables = [k for k, ok in lookups.items() if not ok]
        if bad_tables:
            problems.append(f"lookup families {bad_tables}")
        for name, rs in rows.items():
            problems.append(f"{name} rows {sorted(rs)[:8]}")
        if not problems:
            return None
        return "sharded block verification failed: " + "; ".join(problems)

    def verify(self) -> None:
        msg = self.message(*self.check())
        if msg is not None:
            raise AssertionError(msg)
