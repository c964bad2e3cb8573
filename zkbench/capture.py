"""Every hand-written kernel call of one verification, with its bound.

The wrappers are those ``chip_smoke.py:BLOCK_CAPTURES`` (:677-691) names:
(kernel, module, attribute).  While ``Capture`` is active each of them is
replaced by a wrapper that adds the call's bound (``costs.models``) to
``bound_ms`` and counts it, for calls on the card only (a host-scheduled
group calls the same wrappers on the CPU, where no kernel runs)."""
from __future__ import annotations

import importlib
from collections import Counter

import torch

from .costs.models import call_bound_ms

PKG = "zkevm_specs_tpu_torch"
CAPTURES = (
    ("fr_mul", f"{PKG}.ops.fr", "fr_mul"),
    ("limb_mul", f"{PKG}.ops.limbs", "limb_mul"),
    ("limb_reduce", f"{PKG}.ops.limbs", "limb_reduce"),
    ("limb_addsub", f"{PKG}.ops.limbs", "limb_addsub"),
    ("lookup_gather_eq", f"{PKG}.tables.engine", "lookup_gather_eq"),
    ("state_order_lt", f"{PKG}.circuits.state", "state_order_lt"),
    ("lookup_search_eq", f"{PKG}.tables.engine", "lookup_search_eq"),
    ("lookup_fingerprint", f"{PKG}.tables.engine", "lookup_fingerprint"),
    ("keccak_sponge", f"{PKG}.circuits.keccak", "keccak_sponge"),
    ("horner_rlc", f"{PKG}.circuits.keccak", "horner_rlc"),
    ("horner_rlc", f"{PKG}.circuits.withdrawal", "horner_rlc"),
    ("horner_rlc", f"{PKG}.circuits.sig", "horner_rlc"),
    ("mul_add_words", f"{PKG}.ops.word_mul", "mul_add_words"),
)


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


class Capture:
    """``on(tensor)`` says whether a call runs on the card (the tests count
    CPU calls)."""

    def __init__(self, clock_hz: float, on=lambda t: t.is_cuda):
        self.clock_hz, self.on = clock_hz, on
        self.bound_ms = 0.0
        self.calls: Counter = Counter()
        self._saved = []

    def _wrap(self, kernel, orig):
        def wrapper(*args, **kwargs):
            t = _first_tensor(args)
            if t is not None and self.on(t):
                self.bound_ms += call_bound_ms(kernel, args, kwargs, self.clock_hz)
                self.calls[kernel] += 1
            return orig(*args, **kwargs)
        return wrapper

    def __enter__(self):
        for kernel, module_name, attr in CAPTURES:
            module = importlib.import_module(module_name)
            orig = getattr(module, attr)
            self._saved.append((module, attr, orig))
            setattr(module, attr, self._wrap(kernel, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved = []
