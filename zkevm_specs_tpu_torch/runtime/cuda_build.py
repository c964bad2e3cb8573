"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, where
``<hash>`` hashes the source and the shared headers, so an edited source is rebuilt
and an unchanged one is reused.  ``build_all`` starts one nvcc per source,
all at once; ``library`` builds one on first use and loads it.  Nothing is
built or loaded at import time.  nvcc's output (ptxas's resource usage of
every kernel) is kept beside the library as ``lib<name>-<hash>.log``, and
``resource_usage`` reads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int

# C entry points and their argument types; every pointer (and the stream)
# is a c_void_p so ctypes never cuts it to 32 bits
SIGNATURES: Dict[str, Dict[str, List]] = {
    "fr_mul": {
        "fr_mul_launch": [_P, _I64, _I32, _P, _I64, _I32, _P, _I64, _P],
    },
    "limb_mul": {
        "limb_mul_launch": [_P, _I64, _I32, _P, _I64, _I32, _P, _I32, _I64, _P],
    },
    "limb_addsub": {
        "limb_addsub_launch": [_P, _I64, _I32, _P, _I64, _I32, _P, _I32, _P, _I32, _I64, _P],
    },
    "lookup_gather_eq": {
        "lookup_gather_eq_launch": [_I32, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I64, _P, _I64, _P, _I64, _P],
    },
    "state_order_lt": {
        "state_order_lt_launch": [_P, _I64] * 7 + [_P, _I64, _P],
    },
    "lookup_search_eq": {
        "lookup_search_eq_launch": [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I64, _I32, _P, _P, _I64, _P],
        "lookup_fingerprint_launch": [_I32, _P, _P, _P, _P, _P, _I64, _P],
    },
    "keccak_sponge": {
        "keccak_sponge_launch": [_P, _I64, _P, _P, _I64, _P],
    },
    "horner_rlc": {
        "horner_rlc_launch": [_P, _P, _I64, _I64, _P, _P, _P],
    },
    "leaf_unpack": {
        "leaf_unpack_launch": [_P, _P, _P, _P, _P, _P, _I64, _P, _P],
    },
    "verdict_pack": {
        "verdict_pack_launch": [_P, _I32, _I64, _P, _P],
    },
    "mul_add_words": {
        "mul_add_words_launch": [_I32, ctypes.POINTER(_I64), _P, _P, _I64, _P],
    },
    "fr_inv": {
        "fr_inv_launch": [_P, _I64, _I32, _P, _I64, _P],
    },
    "logup_sum": {
        "logup_up_launch": [_P, _I64, _I32, _P, _I64, _P, _I64, _P, _P],
        "logup_down_launch": [_P, _I64, _I32, _P, _I64, _P, _I64, _I32, _P, _I64, _P, _P, _I32,
                              _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile the named kernels in parallel; returns wall seconds per
    kernel (0.0 for one that was already built).  Raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def _kernel_name(mangled: str) -> str:
    """The kernel's own name (and its first template argument) from its
    Itanium-mangled name, past any anonymous namespace (nvcc names it
    ``_GLOBAL__N__<hash>_<file>...``), e.g.
    ``_ZN38_GLOBAL__N__adcf131a_9_fr_mul_cu_c_p1713fr_mul_kernelEPKx...``
    -> ``fr_mul_kernel``."""
    m = re.match(r"_ZN?", mangled)
    pos = m.end() if m else len(mangled)
    while True:
        n = re.match(r"\d+", mangled[pos:])
        if not n:
            return mangled
        start = pos + n.end()
        name = mangled[start:start + int(n.group())]
        pos = start + len(name)
        if not name.startswith("_GLOBAL__N"):
            break
    t = re.match(r"ILi(-?\d+)E", mangled[pos:])
    return f"{name}<{t.group(1)}>" if t else name


def resource_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of library ``name``: registers, stack frame and spill
    bytes, from the ptxas lines of its build log; empty when the library
    was built without one."""
    log = _so_path(name).with_suffix(".log")
    if not log.exists():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props].update(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"),
                                  map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return {_kernel_name(k): v for k, v in out.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        so = _so_path(name)
        if not so.exists():
            build_all([name])
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
