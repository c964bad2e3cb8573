"""Keccak circuit: the keccak-f[1600] constraint body over every enabled
keccak-table row at once.

Counterpart of ``zkevm_specs_tpu/circuits/keccak.py``.  Given the
witnessed preimages, the circuit

  1. recomputes each row's byte-RLC (a Horner scan, kernel K8
     ``horner_rlc``, ``csrc/horner_rlc.cu``) and constrains it against the
     table's ``input_rlc``, and the length against ``input_len``;
  2. absorbs each row's padded blocks (kernel K7 ``keccak_sponge``,
     ``ops/keccak.py``) and constrains the digest against the table's
     ``output`` word.

The same body runs eagerly on host tensors (``run_spec``: spec mode) and on
the card (``keccak_kernel``, a ``CircuitKernel``).  Both kernels stop each
row at its own length, where the JAX body runs every row through the
longest and masks; the verdicts are the same.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops import fr
from ..ops import limbs as L
from ..ops.keccak import RATE_WORDS, keccak_sponge, pad_blocks
from ..utils.typing import is_circuit_code

# ---------------------------------------------------------------------------
# K8: the byte-RLC Horner scan
# ---------------------------------------------------------------------------

def _rlc_widths(r: int):
    """(r's limbs, product limbs, sum limbs) of a Horner step: the JAX
    package's ``out_n = 16 + r_width + 1`` and ``out_n + 1``, capped at 32
    limbs.  acc * r + byte < p^2 < 2^508, so the cap drops only zero limbs;
    it changes nothing for r below 2^224, and above it the JAX step
    overflows ``reduce_wide``'s 32-limb input (ROADMAP §C)."""
    r_width = max((r.bit_length() + 15) // 16, 1)
    out_n = 16 + r_width + 1
    return r_width, min(out_n, 32), min(out_n + 1, 32)


def horner_rlc_plain(byte_cols: torch.Tensor, active_cols: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of K8, step by step as ``_horner_rlc`` (:56-61): the
    product by r's limbs, the byte added, Barrett ``reduce_wide``, kept
    where the step is active."""
    T, n = byte_cols.shape
    r = r % fr.P
    r_width, prod_n, sum_n = _rlc_widths(r)
    dev = byte_cols.device
    r_limbs = L.int_to_limbs(r, r_width)[None, :].to(dev)
    acc = torch.zeros((n, fr.NL), dtype=L.DTYPE, device=dev)
    for j in range(T):
        prod = L.mul_plain(acc, r_limbs, prod_n)
        s = L.addsub_plain(prod, byte_cols[j].to(L.DTYPE)[:, None], L.ADD, sum_n)
        nxt = fr.reduce_wide_plain(s)
        acc = torch.where(active_cols[j][:, None], nxt, acc)
    return acc


class HornerSchedule(NamedTuple):
    """K8's cut of a ``[T, n]`` scan: ``chunk`` steps a work item,
    ``chunks`` items a row; a block of the chunk phase holds
    ``chunks_per_block`` consecutive chunks of ``rows_per_block`` rows.
    The rest follows, as ``horner_chunk_launch`` derives it: each chunk
    stages ``stage`` steps at a time; ``groups`` blocks cover a row's
    chunks, and with more than one a second launch (``combine_threads``
    threads a row) combines their pairs."""
    chunk: int
    chunks: int
    rows_per_block: int
    chunks_per_block: int

    @property
    def stage(self) -> int:
        return min(self.chunk, HORNER_MAX_STAGE)

    @property
    def groups(self) -> int:
        return -(-self.chunks // self.chunks_per_block)

    @property
    def combine_threads(self) -> int:
        return 1 << (min(self.groups, HORNER_BLOCK) - 1).bit_length()

    @property
    def launches(self) -> int:
        return 1 if self.groups == 1 else 2


# the card's 132 SMs x the 2 resident blocks of 256 threads that K8's
# kernels are built for (csrc/horner_rlc.cu's MIN_BLOCKS; read back by
# horner_blocks_per_sm)
HORNER_TARGET_ITEMS = 132 * 2 * 256
HORNER_MAX_CHUNK = 1024           # bounds the table of r^0 .. r^C
HORNER_BLOCK = 256                # threads of a block, both kernels
HORNER_MAX_STAGE = 32             # steps of each chunk in shared memory at a time


def horner_schedule(T: int, n: int) -> HornerSchedule:
    """K8's schedule for ``T`` steps and ``n`` rows: the chunk length C that
    makes n * ceil(T / C) work items fill the card (C = T when n alone
    does; 1 <= C <= HORNER_MAX_CHUNK), then blocks of at most 256 threads,
    a row's chunks first.  Pure: the wrapper and the tests share it."""
    want = -(-HORNER_TARGET_ITEMS // max(n, 1))
    chunk = min(max(-(-T // want), 1), HORNER_MAX_CHUNK)
    chunks = max(-(-T // chunk), 1)
    per_block = min(chunks, HORNER_BLOCK)
    return HornerSchedule(chunk, chunks, max(min(n, HORNER_BLOCK // per_block), 1), per_block)


def _powers_host(r: int, count: int) -> np.ndarray:
    """r^0 .. r^(count - 1) mod p as ``[count, 16]`` uint32 limbs."""
    out = np.zeros((count, fr.NL), dtype=np.uint32)
    v = 1
    for i in range(count):
        out[i] = [(v >> (16 * k)) & 0xFFFF for k in range(fr.NL)]
        v = v * r % fr.P
    return out


_POWERS: dict = {}


def _powers_on(r: int, chunk: int, device) -> torch.Tensor:
    """K8's table of r^0 .. r^chunk on ``device``, built once per (r, C,
    device): the first call at a shape (a CUDA graph's warm-up pass)
    uploads it, and a capture finds it there."""
    key = (r, chunk, str(device))
    t = _POWERS.get(key)
    if t is None:
        t = torch.from_numpy(_powers_host(r, chunk + 1).view(np.int32)).to(device)
        _POWERS[key] = t
    return t


def _combine_plain(h_a, p_a, h_b, p_b):
    """(h_a * p_b + h_b, p_a * p_b) mod p: K8's combine step (the product
    and the addend summed wide, one Barrett reduction)."""
    x = L.addsub_plain(L.mul_plain(h_a, p_b, 32), h_b, L.ADD, 32)
    return fr.reduce_wide_plain(x), fr.fr_mul_plain(p_a, p_b)


def horner_rlc_chunked_plain(byte_cols: torch.Tensor, active_cols: torch.Tensor, r: int,
                             chunk: int) -> torch.Tensor:
    """K8's chunked schedule in plain PyTorch (for the tests): each chunk of
    ``chunk`` steps scanned from 0 by ``horner_rlc_plain``, with its count
    c of active steps and r^c from the power table, then the (h, r^c)
    pairs combined in order, neighbours first, level by level."""
    T, n = byte_cols.shape
    r = r % fr.P
    chunks = max(-(-T // chunk), 1)
    pad = chunks * chunk - T
    b = torch.cat([byte_cols, byte_cols.new_zeros((pad, n))])
    a = torch.cat([active_cols, active_cols.new_zeros((pad, n))])
    # [chunks * chunk, n] -> [chunk, chunks * n]: step i of chunk k of row j
    # in column k * n + j
    b = b.reshape(chunks, chunk, n).transpose(0, 1).reshape(chunk, chunks * n)
    a = a.reshape(chunks, chunk, n).transpose(0, 1).reshape(chunk, chunks * n)
    h = horner_rlc_plain(b.contiguous(), a.contiguous(), r).reshape(chunks, n, fr.NL)
    powers = torch.from_numpy(_powers_host(r, chunk + 1).astype(np.int64)).to(byte_cols.device)
    pw = powers[a.sum(dim=0)].reshape(chunks, n, fr.NL)
    while h.shape[0] > 1:
        m = h.shape[0] // 2
        flat = [v[s:2 * m:2].reshape(m * n, fr.NL) for v in (h, pw) for s in (0, 1)]
        h_ab, pw_ab = _combine_plain(flat[0], flat[2], flat[1], flat[3])
        h = torch.cat([h_ab.reshape(m, n, fr.NL), h[2 * m:]])
        pw = torch.cat([pw_ab.reshape(m, n, fr.NL), pw[2 * m:]])
    return h[0]


def horner_rlc(byte_cols: torch.Tensor, active_cols: torch.Tensor, r: int) -> torch.Tensor:
    """K8 wrapper: acc <- (acc * r + byte) mod p down the ``[T, n]`` uint8
    byte columns, over the steps where the ``[T, n]`` bool ``active_cols``
    holds (any mask; a prefix of each column in every caller), from
    acc = 0; returns the ``[n, 16]`` canonical int64 limbs.  ``r`` is
    static and taken mod p.  On the card it is the chunked Horner of
    ``horner_schedule(T, n)``: one launch where a block holds all of a
    row's chunks, else two (the chunk phase, then the combine), each
    counted.

    Replaces ``zkevm_specs_tpu/circuits/keccak.py:_horner_rlc`` (:44-74)."""
    if byte_cols.dtype != torch.uint8 or byte_cols.dim() != 2 or not byte_cols.is_contiguous():
        raise ValueError("horner_rlc: byte_cols must be a contiguous [T, n] uint8 tensor")
    if active_cols.dtype != torch.bool or active_cols.shape != byte_cols.shape \
            or not active_cols.is_contiguous():
        raise ValueError("horner_rlc: active_cols must be a contiguous bool tensor shaped "
                         "like byte_cols")
    if L.on_cpu(byte_cols, active_cols):
        return horner_rlc_plain(byte_cols, active_cols, r)
    from ..runtime import cuda_build

    T, n = byte_cols.shape
    r = r % fr.P
    s = horner_schedule(T, n)
    dev = byte_cols.device
    r_host = np.array([(r >> (16 * k)) & 0xFFFF for k in range(fr.NL)], dtype=np.uint32)
    out = torch.empty((n, fr.NL), dtype=L.DTYPE, device=dev)
    powers = _powers_on(r, s.chunk, dev) if s.chunks > 1 else None
    partial = (torch.empty((n * s.groups * 32,), dtype=torch.int32, device=dev)
               if s.groups > 1 else None)
    lib = cuda_build.library("horner_rlc")
    err = lib.horner_chunk_launch(
        byte_cols.data_ptr(), active_cols.data_ptr(), T, n, s.chunk, s.rows_per_block,
        s.chunks_per_block, r_host.ctypes.data, None if powers is None else powers.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(), L.cuda_stream())
    L.check_launch(err, "horner_rlc")
    if s.groups > 1:
        err = lib.horner_combine_launch(partial.data_ptr(), n, s.groups, out.data_ptr(),
                                        L.cuda_stream())
        L.check_launch(err, "horner_rlc")
    return out


# ---------------------------------------------------------------------------
# The circuit
# ---------------------------------------------------------------------------

def _bswap16(v: torch.Tensor) -> torch.Tensor:
    """Byte-swap the low 16 bits."""
    return ((v & 0xFF) << 8) | ((v >> 8) & 0xFF)


def _digest_to_word(ctx: Ctx, digest: torch.Tensor) -> Word:
    """``[n, 8]`` little-endian 32-bit digest words -> the big-endian 256-bit
    output Word (lo/hi 128-bit halves as 16-bit limb F's): its little-endian
    limbs come from the words in reverse order, each giving (bswap16 of its
    high half, bswap16 of its low half)."""
    def limbs_of(words):  # [n, 4], most significant word first
        w = words.flip(-1)
        return torch.stack([_bswap16((w >> 16) & 0xFFFF), _bswap16(w & 0xFFFF)],
                           dim=-1).reshape(w.shape[0], 8)

    return Word(F(ctx, limbs_of(digest[:, 4:8]), 128), F(ctx, limbs_of(digest[:, 0:4]), 128))


def build_keccak_inputs(preimages: List[bytes], enabled_rows: List[dict]):
    """Columns (table commitments) + extra arrays (byte/block matrices) for
    the constraint body, as the JAX package builds them (the padding and
    the byte matrix in one numpy pass each)."""
    n = len(preimages)
    ctx = Ctx("cpu", n, "eager")
    cols = {
        "input_rlc": F.from_ints(ctx, [r["input_rlc"] for r in enabled_rows]),
        "input_len": F.from_ints(ctx, [r["input_len"] for r in enabled_rows], 64),
        "output": Word.from_ints(ctx, [r["output"] for r in enabled_rows]),
    }
    raw, lens, padded, n_blocks = pad_blocks(preimages)
    max_len = raw.shape[1]
    extra = {
        "blocks": padded.view("<u4").astype(np.uint32).reshape(n, -1, RATE_WORDS),
        "n_blocks": n_blocks.astype(np.int32),
        "len_arr": lens.astype(np.int32),
        "byte_cols": np.ascontiguousarray(raw.T),
        "active_cols": np.arange(max_len, dtype=np.int32)[:, None] < lens[None, :],
    }
    return ctx, cols, extra


@is_circuit_code
def check_keccak(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The keccak-circuit constraint body, eager and on the device alike;
    ``extra`` holds tensors on the context's device."""
    # 1. byte-RLC recomputation over the raw preimages
    acc = horner_rlc(extra["byte_cols"], extra["active_cols"], static["r"])
    cs.check(F(ctx, acc, 254).eq_mask(cols["input_rlc"]),
             lambda: "keccak input_rlc mismatch")
    # canonical 16-bit limb split: a >=64KiB preimage (large contract
    # bytecode) overflows a single limb
    len_arr = extra["len_arr"].to(L.DTYPE)
    len_limbs = torch.stack([len_arr & 0xFFFF, (len_arr >> 16) & 0xFFFF], dim=-1)
    cs.check(cols["input_len"].eq_mask(F(ctx, len_limbs, 32)),
             lambda: "keccak input_len mismatch")

    # 2. sponge: each row absorbs its own blocks
    computed = _digest_to_word(ctx, keccak_sponge(extra["blocks"], extra["n_blocks"]))
    cs.check(cols["output"].eq_mask(computed), lambda: "keccak output mismatch")


def _enabled(preimages, keccak_rows):
    enabled = [r for r in keccak_rows if r["state_tag"] == 2]
    assert len(enabled) == len(preimages), "one preimage per enabled keccak row"
    return enabled


def verify_keccak_circuit(preimages: List[bytes], keccak_rows: List[dict],
                          keccak_randomness: int, success: bool = True):
    """Spec-mode (eager, host) driver with reference verdict semantics.

    ``keccak_rows``: the shared keccak table rows ({state_tag, input_rlc,
    input_len, output}); enabled rows (state_tag == 2) must match the
    preimages positionally."""
    from ..runtime.kernels import run_spec

    enabled = _enabled(preimages, keccak_rows)
    if not enabled:
        return
    _, cols, extra = build_keccak_inputs(preimages, enabled)
    run_spec("keccak", check_keccak, cols, None, {"r": keccak_randomness}, extra,
             success=success)


def keccak_kernel(preimages: List[bytes], keccak_rows: List[dict],
                  keccak_randomness: int, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu"); None when no
    row is enabled."""
    from ..runtime.kernels import CircuitKernel, require_device

    require_device(device, "keccak")
    enabled = _enabled(preimages, keccak_rows)
    if not enabled:
        return None
    _, cols, extra = build_keccak_inputs(preimages, enabled)
    return CircuitKernel("keccak", check_keccak, cols, None, {"r": keccak_randomness}, extra,
                         device=device)
