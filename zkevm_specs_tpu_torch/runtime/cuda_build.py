"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, where
``<hash>`` hashes the source and the shared headers, so an edited source is rebuilt
and an unchanged one is reused.  ``build_all`` starts one nvcc per source,
all at once; ``library`` builds one on first use and loads it.  Nothing is
built or loaded at import time.  nvcc's output (ptxas's resource usage of
every kernel) is kept beside the library as ``lib<name>-<hash>.log``, and
``resource_usage`` reads it.  ``build_variants`` builds a source again
with ``-D`` flags (a timing script's variants), and ``launching`` hands
such a variant to the wrappers for the length of a ``with`` block.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

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
        "limb_reduce_launch": [_P, _I64, _I32, _P, _I32, _I32, _I64, _P],
    },
    "limb_addsub": {
        "limb_addsub_launch": [_P, _I64, _I32, _P, _I64, _I32, _P, _I32, _P, _I32, _I64, _P],
        "limb_addsub_path_launches": [_P, _P],
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
        "lookup_search_eq_path_launches": [_P, _P, _P],
    },
    "keccak_sponge": {
        "keccak_sponge_launch": [_P, _I64, _P, _P, _I64, _P],
        "keccak_sponge_path_launches": [_P, _P],
    },
    "horner_rlc": {
        "horner_chunk_launch": [_P, _P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P, _P],
        "horner_combine_launch": [_P, _I64, _I64, _P, _P],
        "horner_blocks_per_sm": [_P, _P],
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
        "logup_up_launch": [_P, _I64, _I32, _P, _I64, _I32, _P, _I64, _P, _P],
        "logup_down_launch": [_I64, _P, _I64, _I32, _I32, _P, _I64, _P, _P, _I32, _P],
        "logup_device_launches": [_P, _P],
        "logup_blocks_per_sm": [_P, _P],
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


def _so_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    for define in defines:
        h.update(f"-D{define}".encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(jobs: Dict[str, tuple]) -> Dict[str, float]:
    """``{key: (name, defines)}`` compiled in parallel, one nvcc each;
    wall seconds per key (0.0 where already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for key, (name, defines) in jobs.items():
        so = _so_path(name, defines)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, so)
    seconds = {key: 0.0 for key in jobs}
    failures = []
    for key, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        seconds[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{key}: nvcc exited {proc.returncode}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile the named kernels in parallel; returns wall seconds per
    kernel (0.0 for one that was already built).  Raises with nvcc's
    output if any build fails."""
    return _compile({name: (name, ()) for name in names})


def _kernel_name(mangled: str) -> str:
    """The kernel's own name (and its integer and bool template arguments)
    from its Itanium-mangled name, past any anonymous namespace (nvcc names
    it ``_GLOBAL__N__<hash>_<file>...``), e.g.
    ``_ZN38_GLOBAL__N__adcf131a_9_fr_mul_cu_c_p1713fr_mul_kernelEPKx...``
    -> ``fr_mul_kernel``, ``..._kernelILi2ELi17ELb1EEEv...`` ->
    ``..._kernel<2, 17, true>``."""
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
    t = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[pos:])
    if not t:
        return name
    args = [("true" if v == "1" else "false") if kind == "b" else v
            for kind, v in re.findall(r"L([ib])(-?\d+)E", t.group(1))]
    return f"{name}<{', '.join(args)}>"


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


# the paths of each kernel whose launcher picks one, in the order its C
# entry ``<name>_path_launches`` reports their launches
PATHS: Dict[str, tuple] = {"limb_addsub": ("staged", "direct"), "keccak_sponge": ("row", "warp"),
                           "lookup_search_eq": ("tile", "warp", "row")}


def path_launches(name: str) -> Dict[str, int]:
    """The launches of each path of a kernel whose launcher picks one
    (``PATHS``: ``{"staged": n, "direct": m}`` for K3, ``{"row": n,
    "warp": m}`` for K7, ``{"tile": n, "warp": m, "row": k}`` for K6's
    search), as
    its C entry counts them since the library loaded; zeros before it
    loads."""
    lib = _LIBS.get(name)
    counts = [ctypes.c_longlong() for _ in PATHS[name]]
    if lib is not None:
        getattr(lib, f"{name}_path_launches")(*map(ctypes.byref, counts))
    return {path: c.value for path, c in zip(PATHS[name], counts)}


def path_taken(name: str, call: Callable[[], object]) -> str:
    """The path of kernel ``name`` (``PATHS``) that ``call`` launched: the
    one whose count moved across it."""
    before = path_launches(name)
    call()
    after = path_launches(name)
    (path,) = [p for p in after if after[p] > before[p]]
    return path


def _load(name: str, so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        so = _so_path(name)
        if not so.exists():
            build_all([name])
        lib = _LIBS[name] = _load(name, so)
    return lib


def build_variants(name: str, variants: Dict[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """``{label: library}``: kernel library ``name`` built once for each
    label's defines (``{"row": ["KECCAK_COOP_ROWS=0"]}`` builds with
    ``-DKECCAK_COOP_ROWS=0``), one nvcc each, all at once, and loaded.
    The wrappers launch a variant only inside ``launching``."""
    _compile({label: (name, tuple(d)) for label, d in variants.items()})
    return {label: _load(name, _so_path(name, tuple(d))) for label, d in variants.items()}


@contextlib.contextmanager
def launching(name: str, lib: ctypes.CDLL):
    """Inside the block, the wrappers of kernel library ``name`` launch
    from ``lib`` (a ``build_variants`` library) in place of the source's
    own build."""
    own = library(name)
    _LIBS[name] = lib
    try:
        yield
    finally:
        _LIBS[name] = own
