"""Seeded operands of kernels K3 (``limb_addsub``) and K4
(``lookup_gather_eq``) at the edges of their tiles, shared by the CPU tests
(plain versions against the JAX package, and the tile model) and the card
tests (kernels against plain versions).

The tile sizes are read from the kernel sources, so the batch cases sit
at the edges of the tiles the kernels really use.  Every case is built on
the device it is asked for, so a view of a wider tensor stays a view there.

A K3 case is ``(a, b, mode, out_n)``; a K4 case is ``(table, query, idx,
enabled)``, with None for a part that is only gathered."""
import re
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
ADDSUB_SOURCE = (CSRC / "limb_addsub.cu").read_text()
GATHER_SOURCE = (CSRC / "lookup_gather_eq.cu").read_text()


def define(source, name):
    """The integer value of ``#define name value`` in a kernel source."""
    m = re.search(r"#define " + name + r" (\d+)", source)
    assert m, f"{name} is not defined"
    return int(m.group(1))


ADDSUB_TILE = define(ADDSUB_SOURCE, "ADDSUB_TILE")
ADDSUB_MAX_UNROLLED = define(ADDSUB_SOURCE, "ADDSUB_MAX_UNROLLED")
ADDSUB_MAX_LIMBS = define(ADDSUB_SOURCE, "ADDSUB_MAX_LIMBS")
ADDSUB_DIRECT_WIDTH = define(ADDSUB_SOURCE, "ADDSUB_DIRECT_WIDTH")
GATHER_TILE = define(GATHER_SOURCE, "GATHER_TILE")
GATHER_THREADS = define(GATHER_SOURCE, "GATHER_THREADS")
GATHER_UNROLL = define(GATHER_SOURCE, "GATHER_UNROLL")

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ADD, SUB, FR_ADD, FR_SUB = 0, 1, 2, 3
MODES = {"ADD": ADD, "SUB": SUB, "FR_ADD": FR_ADD, "FR_SUB": FR_SUB}
BIG_BATCH = 131079     # many tiles and a ragged last one


def chain_width(mode, na, nb, out_n):
    """The limbs of a lane's chain (the kernel's ``Args.width``)."""
    return {ADD: out_n, SUB: max(na, nb), FR_ADD: 17, FR_SUB: 16}[mode]


def addsub_staged(batch, width, stride_a, stride_b):
    """Whether K3's launcher picks the staged path (``launch_width``,
    ``launch_staged``): a chain of more than ADDSUB_DIRECT_WIDTH and at
    most ADDSUB_MAX_UNROLLED limbs, a batch of at least one tile, not two
    broadcast rows."""
    return (ADDSUB_DIRECT_WIDTH < width <= ADDSUB_MAX_UNROLLED and batch >= ADDSUB_TILE
            and not (stride_a == 0 and stride_b == 0))


def addsub_pitch(width):
    """32-bit words of a staged row (``addsub_pitch``): odd."""
    return width | 1


# -- K3 --------------------------------------------------------------------------

def _values(rng, rows, n, below=None):
    """[rows] ints below 2^(16 n) (or ``below``); of eight rows or more the
    first five are the edges 0, 1, the largest (all limbs 0xFFFF: a full
    carry chain), p - 1 where it fits, and the top bit alone."""
    top = (1 << (16 * n)) if below is None else below
    vals = [int.from_bytes(rng.bytes(2 * n + 8), "little") % top for _ in range(rows)]
    if rows >= 8:
        vals[:5] = [0, 1, top - 1, (P - 1) % top, top >> 1]
    return vals


def _limbs(vals, n):
    buf = b"".join(int(v).to_bytes(2 * n, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), n).astype(np.int64)


def _operand(rng, rows, n, below, layout, device):
    """``rows`` x ``n`` limbs on ``device``: "dense" a contiguous tensor;
    "view" the first n limbs of rows of n + 3 (row stride != width);
    "offset" a dense [rows, n] view one limb into a flat buffer (base not
    16-byte aligned); "offset_view" a view one limb into rows of n + 2."""
    arr = _limbs(_values(rng, rows, n, below), n)
    if layout == "dense":
        return torch.from_numpy(arr).to(device)
    if layout == "offset":
        flat = np.zeros(rows * n + 2, dtype=np.int64)
        flat[1:1 + rows * n] = arr.ravel()
        return torch.from_numpy(flat).to(device)[1:1 + rows * n].view(rows, n)
    extra, start = (3, 0) if layout == "view" else (2, 1)
    wide = rng.randint(0, 1 << 16, size=(rows, n + extra)).astype(np.int64)
    wide[:, start:start + n] = arr
    return torch.from_numpy(wide).to(device)[:, start:start + n]


def _bound(mode, n):
    """Values an Fr mode's operand may take: canonical below p (within
    2^(16 n)); a 17-limb reduce_once input below 2p."""
    if mode not in (FR_ADD, FR_SUB):
        return None
    return min(1 << (16 * n), 2 * P if n == 17 else P)


def addsub_operands(mode, na, nb, out_n, batch, broadcast=None, layout=("dense", "dense"),
                    seed=0, device="cpu"):
    """``(a, b, mode, out_n)``; ``broadcast`` names the operands that are one
    ``[1, w]`` row ("a", "b" or "ab"); ``layout`` each operand's layout."""
    rng = np.random.RandomState(seed)
    ra = 1 if broadcast and "a" in broadcast else batch
    rb = 1 if broadcast and "b" in broadcast else batch
    a = _operand(rng, ra, na, _bound(mode, na), layout[0], device)
    if mode == FR_ADD and na == 17:
        # reduce_once: a 17-limb value below 2p plus a zero row
        b = torch.zeros((1, nb), dtype=torch.int64, device=device)
    else:
        b = _operand(rng, rb, nb, _bound(mode, nb), layout[1], device)
    return a, b, mode, out_n


def _addsub_cases():
    cases = {}
    # every mode at every width it takes (batch 37: the direct path)
    for w in list(range(1, ADDSUB_MAX_UNROLLED + 1)) + [32, 64]:
        cases[f"ADD_w{w}"] = (ADD, w, w, w, 37)
        cases[f"ADD_w{w}_half_wider_out"] = (ADD, w, max(1, w // 2), min(w + 1, 64), 37)
        cases[f"SUB_w{w}"] = (SUB, w, w, 0, 37)
        cases[f"SUB_w{w}_one_limb"] = (SUB, 1, w, 0, 37)
    cases["ADD_truncating"] = (ADD, 16, 16, 8, 37)
    for w in range(1, 17):
        cases[f"FR_ADD_w{w}"] = (FR_ADD, w, 16, 0, 37)
        cases[f"FR_SUB_w{w}"] = (FR_SUB, 16, w, 0, 37)
        cases[f"FR_SUB_a{w}"] = (FR_SUB, w, 16, 0, 37)
    cases["FR_ADD_reduce_once"] = (FR_ADD, 17, 1, 0, 37)
    out = {name: (*spec, None, ("dense", "dense")) for name, spec in cases.items()}
    # broadcast operands, at a batch that runs the staged instance
    lanes = ADDSUB_TILE + 5
    for mode, (na, nb, out_n) in (("ADD", (16, 16, 17)), ("SUB", (1, 16, 0)),
                                  ("FR_ADD", (16, 16, 0)), ("FR_SUB", (16, 16, 0))):
        for bc in ("a", "b", "ab"):
            out[f"{mode}_broadcast_{bc}"] = (MODES[mode], na, nb, out_n, lanes, bc,
                                             ("dense", "dense"))
    out["FR_SUB_neg"] = (FR_SUB, 1, 16, 0, lanes, "a", ("dense", "dense"))
    # row stride != width: views of wider rows
    for mode, (na, nb, out_n) in (("ADD", (16, 8, 16)), ("SUB", (16, 16, 0)),
                                  ("FR_ADD", (16, 16, 0)), ("FR_SUB", (16, 16, 0)),
                                  ("ADD", (32, 32, 33)), ("SUB", (64, 3, 0))):
        for layout in (("view", "dense"), ("dense", "view"), ("view", "view"),
                       ("offset", "offset_view")):
            out[f"{mode}_{na}_{nb}_{layout[0]}_{layout[1]}"] = (MODES[mode], na, nb, out_n,
                                                                lanes, None, layout)
    # batches at the edges of a tile, and one of many tiles
    for mode, (na, nb, out_n) in (("ADD", (16, 16, 16)), ("SUB", (16, 16, 0)),
                                  ("FR_ADD", (16, 16, 0)), ("FR_SUB", (16, 16, 0)),
                                  ("ADD", (32, 32, 32)), ("SUB", (1, 16, 0)), ("ADD", (3, 5, 5))):
        tile = ADDSUB_TILE
        for batch in (1, tile - 1, tile, tile + 1, BIG_BATCH):
            out[f"{mode}_{na}_{nb}_{out_n}_batch{batch}"] = (MODES[mode], na, nb, out_n, batch,
                                                            None, ("dense", "dense"))
    return out


ADDSUB_CASES = _addsub_cases()


def addsub_case(name, device="cpu"):
    mode, na, nb, out_n, batch, broadcast, layout = ADDSUB_CASES[name]
    a, b, mode, out_n = addsub_operands(mode, na, nb, out_n, batch, broadcast, layout,
                                        seed=sum(map(ord, name)), device=device)
    if name == "FR_SUB_neg":
        a = torch.zeros_like(a)           # fr.neg: 0 - b
    return a, b, mode, out_n


# -- K4 --------------------------------------------------------------------------

WIDTHS = (1, 2, 4, 8, 16)


def gather_operands(parts, batch, n_rows=300, hints="random", enabled=None, seed=0,
                    out_of_range=False, device="cpu"):
    """``(table, query, idx, enabled)``.  ``parts``: (tw, qw) per part, qw
    None for a part only gathered, 0 for a ``[1, tw]`` broadcast query;
    ``hints`` "random" or "ascending"; ``enabled`` None, "lanes" ([B]),
    "on" or "off" ([1]); ``out_of_range``: some indexes below -n_rows, in
    [-n_rows, -1] and at or past n_rows.  Every third lane's query
    differs from its row in one limb (where the query has limbs)."""
    rng = np.random.RandomState(seed)
    if hints == "ascending":
        idx = np.sort(rng.randint(0, n_rows, size=batch))
    else:
        idx = rng.randint(0, n_rows, size=batch)
    if out_of_range:
        idx[0::5] = -n_rows - 1 - rng.randint(0, 3, size=idx[0::5].shape)
        idx[1::5] = -1 - rng.randint(0, n_rows, size=idx[1::5].shape)
        idx[2::5] = n_rows + rng.randint(0, 3, size=idx[2::5].shape)
    rows = np.where(idx < 0, idx + n_rows, idx).clip(0, n_rows - 1)
    table, query = [], []
    for p, (tw, qw) in enumerate(parts):
        t = rng.randint(0, 1 << 16, size=(n_rows, tw)).astype(np.int64)
        if qw is not None and qw and qw < tw:
            t[:, qw:] = 0                    # a wide column holding narrow values
        table.append(torch.from_numpy(t).to(device))
        if qw is None:
            query.append(None)
            continue
        width = qw or tw
        q = np.zeros((batch, width), dtype=np.int64)
        k = min(width, tw)
        q[:, :k] = t[rows, :k]
        if qw == 0:
            q = q[:1]
        else:
            q[p % 3::3, (p % width)] ^= 1 + p
        query.append(torch.from_numpy(q).to(device))
    en = {None: None, "on": np.array([True]), "off": np.array([False]),
          "lanes": rng.rand(batch) < 0.5}[enabled]
    return (table, query, torch.from_numpy(idx.astype(np.int32)).to(device),
            None if en is None else torch.from_numpy(en).to(device))


def _gather_cases():
    cases = {}
    for n in range(1, 17):
        parts = [(WIDTHS[p % 5], WIDTHS[(p * 3 + 1) % 5]) for p in range(n)]
        cases[f"parts{n}"] = (parts, 97, "random", None, False)
        cases[f"parts{n}_gather_only"] = ([(tw, None) for tw, _ in parts], 97, "random", None,
                                          False)
    # the rw lookup's widths: table (8, 8, 1, 4, 1) against queries (8, 8, 1, 16, 1)
    rw = [(8, 8), (8, 8), (1, 1), (4, 16), (1, 1)]
    cases["rw_lookup"] = (rw, 97, "ascending", None, False)
    cases["table_wider"] = ([(16, 2), (8, 1), (4, 0)], 97, "random", None, False)
    cases["query_wider"] = ([(2, 16), (1, 8), (4, 0)], 97, "random", None, False)
    cases["mixed_gather"] = ([(8, 8), (8, None), (1, 1), (16, None)], 97, "random", None, False)
    for en in ("lanes", "on", "off"):
        cases[f"enabled_{en}"] = (rw, 97, "random", en, False)
    cases["out_of_range"] = (rw, 97, "random", "lanes", True)
    cases["out_of_range_gather_only"] = ([(8, None), (4, None)], 97, "random", None, True)
    for hints in ("random", "ascending"):
        for batch in (1, GATHER_TILE - 1, GATHER_TILE, GATHER_TILE + 1, 5000):
            cases[f"rw_{hints}_batch{batch}"] = (rw, batch, hints, "lanes", batch == 5000)
            cases[f"gather_{hints}_batch{batch}"] = ([(8, None), (8, None)], batch, hints,
                                                     None, False)
    return cases


GATHER_CASES = _gather_cases()


def gather_case(name, device="cpu"):
    parts, batch, hints, enabled, out_of_range = GATHER_CASES[name]
    return gather_operands(parts, batch, hints=hints, enabled=enabled,
                           seed=sum(map(ord, name)), out_of_range=out_of_range, device=device)
