"""The device's side of a traced run, from ``torch.profiler`` (CUPTI) over
a few verifications after the window: the union of the device's busy
intervals, kernel time and launches by kind, and the idle gaps, each named
by the harness span that was open across it.

A hand-written kernel is one whose name holds a ``__global__`` function of
the port's ``csrc`` sources; memory copies and sets are named by CUPTI
``Memcpy ...`` / ``Memset ...``; every other device kernel is PyTorch's.
The profiler may drop a session's first kernels, so the first profiled
verification is left out of every reading."""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

PREFIX = "zkbench."
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_symbols(csrc: Path) -> List[str]:
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(GLOBAL.findall(src.read_text()))
    return sorted(names)


def short_name(name: str) -> str:
    name = re.sub(r"^void\s+", "", name)
    return name.split("(")[0][:120]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, symbols: List[str], verifications: int) -> Dict:
    """Readings of the last ``verifications`` profiled verifications from
    the profiler's events: each event needs ``name``, ``device_type``
    ("cuda" or "cpu") and ``start`` / ``end`` in microseconds."""
    own = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
    spans = sorted(((e["start"], e["end"], e["name"][len(PREFIX):]) for e in events
                    if e["device_type"] == "cpu" and e["name"].startswith(PREFIX)))
    preps = [s for s in spans if s[2] == "prepare"]
    if len(preps) < verifications or not spans:
        return {}
    lo = preps[-verifications][0]
    hi = max(s[1] for s in spans)
    spans = [s for s in spans if s[0] >= lo]
    # the spans' own ranges on the device's timeline are no device work
    device = [e for e in events if e["device_type"] == "cuda" and lo <= e["start"] < hi
              and not e["name"].startswith(PREFIX)]
    busy = _union([(max(e["start"], lo), min(e["end"], hi)) for e in device])
    by_name: Dict[str, List[float]] = {}
    own_n = own_us = lib_us = 0.0
    for e in device:
        d = e["end"] - e["start"]
        m = own.search(e["name"])
        if m:
            own_n += 1
            own_us += d
            key = m.group(1)
        else:
            key = short_name(e["name"])
            if not key.startswith(("Memcpy", "Memset")):
                lib_us += d
        by_name.setdefault(key, [0, 0.0])
        by_name[key][0] += 1
        by_name[key][1] += d
    gaps = []
    prev = lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            mid = (prev + a) / 2
            label = next((s[2] for s in spans if s[0] <= mid < s[1]), "between")
            gaps.append((label, (a - prev) * 1e-6))
        prev = max(prev, b)
    window_s = (hi - lo) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {
        "verifications": verifications,
        "window_s": window_s,
        "busy_s": busy_s,
        "own_launches": own_n / verifications,
        "own_ms": own_us * 1e-3 / verifications,
        "library_ms": lib_us * 1e-3 / verifications,
        "device_ops": sorted(([n, v[1] * 1e-6] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps), key=lambda x: -x[1])[:10],
    }


def events_of(prof) -> List[dict]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        kind = "cuda" if e.device_type == DeviceType.CUDA else "cpu"
        if kind == "cpu" and not e.name.startswith(PREFIX):
            continue
        out.append({"name": e.name, "device_type": kind, "start": e.time_range.start,
                    "end": e.time_range.end})
    return out
