#!/usr/bin/env python3
"""The control of ``correct``, and the faults it must catch.

    python3 zkbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the port with one guarantee of the configuration broken:
the host-scheduled step groups are skipped and reported passing (every
lane is no longer evaluated), the step a change that hurried the host
groups could take.  For each seed it runs a cell as ``run.py`` does, with
the control in place, and prints one JSON line of the numbers compared;
``correct`` has to come out false on every seed.  The tests
(``tests/test_zkbench_control.py``) drive the same runs on the CPU at a
small size, with these faults of the timed path too: ``unchanged`` (a
verification that returns without evaluating anything), ``half_batch``
(the second half of every device check's lanes reported passing),
``altered`` (one verdict flipped where it is produced), and, for each
circuit check alone, ``silence`` (every row reported passing) and
``halve`` (either half of its rows left out)."""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def skip_host_groups(bv):
    import numpy as np

    bv.host_group_fails = lambda timed=None: [np.zeros(len(g["idxs"]), dtype=bool)
                                              for g in bv.groups if g["verifier"] is None]


def unchanged(bv):
    bv.run_device = lambda prepared: {}


def half_batch(bv):
    orig = bv._device_pass

    def halved(prepared, timed=None):
        outs = orig(prepared) if timed is None else orig(prepared, timed)
        for v in outs:
            v[v.shape[0] // 2:] = False
        return outs

    bv._device_pass = halved


def altered(bv):
    orig = bv.run_device

    def flipped(prepared):
        failures = dict(orig(prepared))
        key = min(failures, key=str) if failures else 0
        if failures.pop(key, None) is None:
            failures[key] = True
        return failures

    bv.run_device = flipped


def _check_output(bv, name, alter):
    """``alter(fail bits)`` applied to the output of one device check of
    the pass: ``state`` or a circuit check's name."""
    order = ["state"] + [n for n, _k in bv.circuit_kernels]
    at = sum(g["verifier"] is not None for g in bv.groups) + order.index(name)
    orig = bv._device_pass

    def patched(prepared, timed=None):
        outs = orig(prepared) if timed is None else orig(prepared, timed)
        alter(outs[at])
        return outs

    bv._device_pass = patched


def silence(name):
    """One check that reports every row passing."""
    def patch(bv):
        _check_output(bv, name, lambda v: v.fill_(False))
    return patch


def halve(name, half):
    """One check whose first (0) or second (1) half of rows is left out,
    reported passing."""
    def patch(bv):
        def alter(v):
            n = v.shape[0] // 2
            (v[:n] if half == 0 else v[n:]).fill_(False)
        _check_output(bv, name, alter)
    return patch


PATCHES = {"control": skip_host_groups, "unchanged": unchanged, "half_batch": half_batch,
           "altered": altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from zkbench.run import run_cell

    for seed in args.seeds:
        result, _lines = run_cell(args.workload, seed, args.seconds, False,
                                  patch=skip_host_groups)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"],
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
