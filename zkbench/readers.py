"""The readers of per-layer metrics.  A metric's file
``zkbench/metrics/<name>.json`` names its reader (``"reader"``) and the
reader's arguments; a reader takes them from the run's record and returns
a number, or None where the run has nothing to read.

The record (``run.py``): ``setup`` {phase: seconds}, ``spans`` {span:
[seconds, ...]} from the harness's host clock, ``profile`` (``profile.py``,
traced runs on the card) and ``bound_ms``, the summed bound of one
verification's hand-written kernel calls (``capture.py``)."""
from __future__ import annotations

import statistics
from typing import Optional


def setup_phase(rec, phase: str, scale: float = 1.0) -> Optional[float]:
    v = rec["setup"].get(phase)
    return None if v is None else v * scale


def span_mean(rec, span: str, scale: float = 1.0) -> Optional[float]:
    v = rec["spans"].get(span)
    return statistics.fmean(v) * scale if v else None


def span_median(rec, span: str, scale: float = 1.0) -> Optional[float]:
    v = rec["spans"].get(span)
    return statistics.median(v) * scale if v else None


def span_quantile(rec, span: str, q: float, scale: float = 1.0) -> Optional[float]:
    """The q-quantile (inclusive method) of all the span's samples."""
    v = rec["spans"].get(span)
    if not v or len(v) < 2:
        return None
    return statistics.quantiles(v, n=100, method="inclusive")[round(q * 100) - 1] * scale


def profile_value(rec, key: str) -> Optional[float]:
    return rec["profile"].get(key) if rec.get("profile") else None


def idle_share(rec) -> Optional[float]:
    p = rec.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def roofline(rec) -> Optional[float]:
    """Sum of bounds over sum of device time, across the hand-written
    kernels' launches of one verification (never 0: a run with no such
    time reads nothing)."""
    p = rec.get("profile")
    if not p or not p.get("own_ms") or not rec.get("bound_ms"):
        return None
    return 100.0 * rec["bound_ms"] / p["own_ms"]


READERS = {f.__name__: f for f in (setup_phase, span_mean, span_median, span_quantile,
                                   profile_value, idle_share, roofline)}


def read(rec, spec: dict) -> Optional[float]:
    args = {k: v for k, v in spec.items() if k not in ("reader", "unit")}
    return READERS[spec["reader"]](rec, **args)
