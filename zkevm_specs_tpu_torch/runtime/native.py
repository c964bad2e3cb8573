"""The native host library: keccak, secp256k1 and BN254 in C, by ctypes.

Counterpart of ``zkevm_specs_tpu/runtime/native.py``.  The library is the
repository's own ``csrc/keccak.c``, ``csrc/ec_secp256k1.c`` and
``csrc/ec_bn254.c``, compiled with the system C compiler (``$CC``, else
``cc``) and ``csrc/Makefile``'s flags into
``build/native/libzkevm_native-<hash>.so`` at the repository root, where
``<hash>`` hashes the sources and the flags, so an edited source is rebuilt
and an unchanged one is reused.  It is built on first use, never at import,
and nothing is written into ``csrc/`` (the JAX package's
``csrc/libzkevm_native.so`` is never loaded).

Where the library does not build or load, every wrapper returns the JAX
module's "unavailable" value (``None`` or ``False``) and the callers take
their Python path; ``require_native`` raises instead, with the compiler's
output, for a run that must not fall back.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("keccak.c", "ec_secp256k1.c", "ec_bn254.c")
CFLAGS = ("-O3", "-fPIC", "-Wall", "-shared")    # csrc/Makefile's

_lib = None
_tried = False
_error: Optional[str] = None
BUILD_SECONDS: Optional[float] = None


def compiler() -> str:
    return os.environ.get("CC", "cc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join((compiler(),) + CFLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libzkevm_native-{h.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    """Compile the sources into ``so`` (through a file of this process's
    own, renamed into place, so that processes building at once never load
    a half-written library)."""
    global BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CFLAGS, "-o", str(tmp), *(str(CSRC / n) for n in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}")
    os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c, u64 = ctypes.c_char_p, ctypes.c_uint64
    lib.zkevm_keccak256.argtypes = [c, u64, c]
    lib.zkevm_keccak256_batch.argtypes = [c, ctypes.POINTER(u64), u64, c]
    lib.zkevm_secp256k1_double_mul.argtypes = [c] * 6
    lib.zkevm_secp256k1_double_mul.restype = ctypes.c_int
    lib.zkevm_secp256k1_verify_batch.argtypes = [c, c, c, c, c, u64, c]
    lib.zkevm_bn254_g1_add.argtypes = [c] * 6
    lib.zkevm_bn254_g1_add.restype = ctypes.c_int
    lib.zkevm_bn254_g1_mul.argtypes = [c] * 5
    lib.zkevm_bn254_g1_mul.restype = ctypes.c_int
    lib.zkevm_bn254_g1_msm.argtypes = [c, c, c, u64, c, c]
    lib.zkevm_bn254_g1_msm.restype = ctypes.c_int
    lib.zkevm_bn254_g2_subgroup_check.argtypes = [c] * 4
    lib.zkevm_bn254_g2_subgroup_check.restype = ctypes.c_int
    lib.zkevm_bn254_pairing_check.argtypes = [c, c, u64]
    lib.zkevm_bn254_pairing_check.restype = ctypes.c_int
    return lib


def _load():
    """The bound library, built first if needed; None where it cannot be
    built or loaded (the reason kept for ``require_native``)."""
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        _lib = _bind(ctypes.CDLL(str(so)))
    except (OSError, RuntimeError, AttributeError) as e:
        _error = str(e)
        _lib = None
    return _lib


@contextlib.contextmanager
def disabled():
    """Inside the block every wrapper answers "unavailable", so every
    dispatch site takes its Python path (the parity checks' other side)."""
    global _lib, _tried
    saved = _lib, _tried
    _lib, _tried = None, True
    try:
        yield
    finally:
        _lib, _tried = saved


def native_available() -> bool:
    return _load() is not None


def require_native() -> Path:
    """The loaded library's path; raises with the compiler's (or the
    loader's) output where it does not build or load."""
    if _load() is None:
        raise RuntimeError(f"the native host library is unavailable: {_error}")
    return library_path()


def _b32(x: int) -> bytes:
    return (x % (1 << 256)).to_bytes(32, "big")


def _point(ok: int, ox, oy):
    if not ok:
        return None
    return (int.from_bytes(ox.raw, "big"), int.from_bytes(oy.raw, "big"))


def keccak256_native(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.zkevm_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch_native(datas: List[bytes]) -> Optional[List[bytes]]:
    lib = _load()
    if lib is None:
        return None
    offsets = [0]
    for d in datas:
        offsets.append(offsets[-1] + len(d))
    arr = (ctypes.c_uint64 * len(offsets))(*offsets)
    out = ctypes.create_string_buffer(32 * len(datas))
    lib.zkevm_keccak256_batch(b"".join(datas), arr, len(datas), out)
    return [out.raw[32 * i: 32 * i + 32] for i in range(len(datas))]


def secp256k1_double_mul_native(u1: int, u2: int, px: int, py: int):
    """u1 G + u2 (px, py) on secp256k1: the affine point, None for
    infinity, False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    ox, oy = ctypes.create_string_buffer(32), ctypes.create_string_buffer(32)
    ok = lib.zkevm_secp256k1_double_mul(u1.to_bytes(32, "big"), u2.to_bytes(32, "big"),
                                        px.to_bytes(32, "big"), py.to_bytes(32, "big"), ox, oy)
    return _point(ok, ox, oy)


def secp256k1_verify_batch_native(rows) -> Optional[List[bool]]:
    """ECDSA verdicts of ``rows = [(msg_hash, r, s, (px, py))]`` in one call;
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    msg = b"".join(_b32(h) for h, _, _, _ in rows)
    rr = b"".join(_b32(r) for _, r, _, _ in rows)
    ss = b"".join(_b32(s) for _, _, s, _ in rows)
    px = b"".join(pk[0].to_bytes(32, "big") for _, _, _, pk in rows)
    py = b"".join(pk[1].to_bytes(32, "big") for _, _, _, pk in rows)
    out = ctypes.create_string_buffer(len(rows))
    lib.zkevm_secp256k1_verify_batch(msg, rr, ss, px, py, len(rows), out)
    return [bool(b) for b in out.raw]


def bn254_g1_add_native(p1, p2):
    """p1 + p2 on BN254 G1 (int pairs, None = infinity; (0, 0) is infinity
    to the library): the affine sum, None for infinity, False when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    ax, ay = (0, 0) if p1 is None else p1
    bx, by = (0, 0) if p2 is None else p2
    ox, oy = ctypes.create_string_buffer(32), ctypes.create_string_buffer(32)
    return _point(lib.zkevm_bn254_g1_add(_b32(ax), _b32(ay), _b32(bx), _b32(by), ox, oy), ox, oy)


def bn254_g1_mul_native(pt, k: int):
    """k pt on BN254 G1 (k taken mod 2^256); False when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return False
    px, py = (0, 0) if pt is None else pt
    ox, oy = ctypes.create_string_buffer(32), ctypes.create_string_buffer(32)
    return _point(lib.zkevm_bn254_g1_mul(_b32(px), _b32(py), _b32(k), ox, oy), ox, oy)


def bn254_g1_msm_native(points, scalars):
    """sum_i k_i P_i on BN254 G1 (None = infinity); False when the library
    is unavailable."""
    lib = _load()
    if lib is None:
        return False
    xs = b"".join(_b32(0 if p is None else p[0]) for p in points)
    ys = b"".join(_b32(0 if p is None else p[1]) for p in points)
    ks = b"".join(_b32(k) for k in scalars)
    ox, oy = ctypes.create_string_buffer(32), ctypes.create_string_buffer(32)
    return _point(lib.zkevm_bn254_g1_msm(xs, ys, ks, len(points), ox, oy), ox, oy)


def bn254_g2_subgroup_native(x0: int, x1: int, y0: int, y1: int):
    """Membership of the order-r subgroup for the G2 point ((x0, x1), (y0,
    y1)); None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return bool(lib.zkevm_bn254_g2_subgroup_check(_b32(x0), _b32(x1), _b32(y0), _b32(y1)))


def bn254_pairing_check_native(pairs):
    """prod e(P_i, Q_i) == 1 for ``pairs = [(g1 int pair, ((x0, x1), (y0,
    y1)))]``, None points being infinity; None when the library is
    unavailable.  The library's precondition: every point on its curve and
    every G2 point in the subgroup (the ecc circuit checks both first)."""
    lib = _load()
    if lib is None:
        return None
    g1s, g2s = [], []
    for pt, q in pairs:
        px, py = (0, 0) if pt is None else pt
        g1s.append(_b32(px) + _b32(py))
        if q is None:
            g2s.append(b"\x00" * 128)
        else:
            (x0, x1), (y0, y1) = q
            g2s.append(_b32(x0) + _b32(x1) + _b32(y0) + _b32(y1))
    return bool(lib.zkevm_bn254_pairing_check(b"".join(g1s), b"".join(g2s), len(pairs)))
