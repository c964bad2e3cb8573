#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``zkevm_specs_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It drives the port's paths through the entry points a user calls, and
checks them.  Phases (JSON lines on stdout; any failure raises and the
script exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the kernels of ``zkevm_specs_tpu_torch/csrc``, one nvcc per
   source, all started together, with each kernel's registers and spill
   bytes as ptxas reports them;
3. slice: the compiled EVM group verifier on the ADD and MUL groups
   (``slice`` lines), then on the groups of the last eight ALU gadgets
   (``alu_group`` lines, ``workloads.ALU_GROUPS``: LT, SLT, ISZERO, NOT,
   AND, BYTE, SIGNEXTEND, SAR), ADD and MUL at 131072 lanes (``bench.py``'s
   ``BENCH_STEPS``), the eight at 32768 (cut for the run's time): host trace, upload, one replay on the card with every
   kernel launch count set to 0 just before it and read just after, every
   lane passing, then the replay timed, the arguments of every kernel at
   each distinct shape of one more replay, and one corrupted lane, an edit
   of the uploaded inputs, that must fail alone (the pushed word's lowest
   bit flipped; SIGNEXTEND's gas_left + 1, its result bytes being
   unconstrained, as in the JAX package); plus the replay at 256 lanes
   held against the same replay on the CPU (the plain versions, which the
   CPU tests hold against the JAX package), clean and with the builder's
   own corrupted lane; the MUL group's word product runs as one K11
   launch; each group and block line gives its phase's seconds;
4. state: the state circuit (``make_state_check_fn``) on both of
   ``bench.py``'s row mixes at 2^19 rows: build, pack and upload, one
   counted check with every row passing, 10 timed checks, a rebuild with
   one corrupted row that must fail alone, and the check at 512 rows held
   against the CPU;
5. bytecode: the bytecode circuit (``bytecode_kernel``, a ``CircuitKernel``)
   on the ALU-mix bytecodes at k = 20, the same steps, one corrupted byte,
   and the check at k = 10 held against the CPU;
6. keccak: the keccak circuit (``keccak_kernel``, a ``CircuitKernel``) on
   the ALU block's keccak table (8 bytecodes of 66001 bytes) and on the
   table of a SHA3-heavy block (65536 short preimages): build, pack and
   upload, one counted check with every row passing, 10 timed checks, two
   rebuilds that each corrupt one row (a wrong output, a wrong input_rlc)
   that must fail alone, and the check at a small size held against the
   CPU;
7. withdrawal: the withdrawal circuit (``withdrawal_kernel``) at mainnet's
   16 rows, the same steps with one corrupted amount;
8. block: the ALU block at a quarter of its rounds
   (``workloads.build_alu_block(8, 2750)``; ``bench.py:_alu_heavy_txs(8,
   11000)``, cut so that the run keeps its time; the bytecode and keccak
   phases keep its full codes) traced and signed by the port, as
   ``bench.py:_run_block_once`` traces it, caller 0xFE becoming each tx's
   own key's address) through the port's ``CompiledBlockVerifier``, the tx
   and sig circuits included (``"sign": true``; the host seconds of the
   signing and of the tx and sig witnesses, each timed again on its own):
   trace, build, cold and
   warm ``prepare`` (one upload through K9), then, with every count set to
   0 just before and read just after, a warm ``prepare`` and the first
   ``run_device_combined`` (the capture of the whole device pass into one
   CUDA graph, K10 its last kernel, and a replay), no failure; the
   per-kernel pass (``run_device``, median of 5, its launches counted on
   their own, and the graph's recorded launches equal to them kernel for
   kernel, plus one K10, and K3's launches by path, staged or direct,
   as its launcher counts them) and the graph replay (median
   of 10), the graph's device time alone (CUDA events) and the
   host-scheduled groups' time
   (they run on the host while the graph runs); the keccak check's share
   (the check's host ms over the replay and the per-kernel pass, its own
   captured graph's device ms over the block graph's device ms);
   one more per-kernel pass that records every kernel's arguments at each
   distinct shape, and counts every call under its shape; a rebuild with
   one ADD step's gas_left + 1 that must fail at that step or its
   predecessor only; the built verifier's pi-kernel inputs with one row's
   rpi_value_lc + 1, uploaded by a new ``prepare``, that must fail at
   ("pi", row) keys only, and likewise one lane's ECDSA verdict flipped in
   the tx and then the sig inputs, failing at ("tx", lane) and ("sig",
   lane) only; the keccak, tx, sig and pi checks' shares; and a 2 x 6
   block, signed, its two txs with calldata (so that pi's calldata region
   and its calldata-gas lookup have enabled rows on the card), whose
   failure dicts on the card and on the CPU must be equal, clean, with the
   gas_left edit and with tx 0 re-signed with key 0xBAD (failing at ("tx",
   0) only).  Every circuit is ported (``"not_ported": []``), pi on every
   block;
9. arith: the arithmetic block at an eighth of its txs
   (``workloads.build_arith_block(5, 37)``: MUL, DIV, MOD, SDIV, SMOD,
   ADDMOD, MULMOD, EXP, SHL and SHR on seeded words, 185 EXP events in the
   exp circuit; signed, one caller 0xFE; the 40-tx block, 1110840 gas, is
   cut to an eighth so that the run keeps its time) through the same steps, the exp circuit's share beside the
   keccak, tx, sig and pi checks', the tx and sig edits, and
   the pi edit above, and two corruptions each on its own rebuild (one
   MULMOD step's pushed result + 1; one exp-circuit row's d + 1) that must
   fail exactly where the JAX
   verifier fails on the same edit of the 4 x 1 block (the CPU tests
   show those keys); and the 4 x 1 block's failure dicts on the card and
   on the CPU, clean and with the MULMOD edit;
   after the timed passes of each block, its logUp lookup argument (a
   ``logup`` line, ``run_logup``): from the verifier's partition-pass log
   and the table columns ``prepare`` uploaded, every family the JAX
   package's ShardedBlockVerifier names (rw, bytecode, tx, block, exp, ...)
   with the counts set to 0 just before and read just after, each family's
   rows, queries, host seconds, check time and the port's launches of one
   check (``check_launches``: one K2 normalise-and-reduce launch, no K2
   product), true on the clean block;
   false with an over-counted multiplicity and with a corrupted rw value;
   an alpha equal to a table fingerprint giving a zero partial sum on the
   card and in the plain version; and on the small block the same
   verdicts and lhs/rhs limbs on the card and on the CPU;
10. sstore: the SSTORE-heavy block (``workloads.build_sstore_block(7)`` =
   ``bench.py:_sstore_heavy_txs(7)``, signed: 1080653 gas, six cold
   SSTOREs, warm SLOADs and a SHA3 a tx, its copy circuit and the Storage,
   access-list and refund rows of the state circuit) through the same
   steps, the copy check's share beside the keccak, tx, sig and pi checks',
   two rebuilds (the middle SSTORE's written value + 1, failing at that
   step and the state row of the SLOAD that reads it back; one copy row's
   rlc_acc + 1, failing at that row and the one before, as the JAX
   verifier fails on the same edits of a 2-tx block), its logUp line (the
   copy and keccak families among them), and the 2-tx block's failure
   dicts on the card and the CPU, clean and with the SSTORE edit;
10b. flow: the loop block at half its txs and a quarter of its rounds
   (``workloads.build_flow_block(4, 400)``, signed: 27533 steps, 60413 rw
   rows; the 8 x 1600 block, 986488 gas, is cut so that the run keeps its
   time): each tx reads every context value, queries 0xCAFE's account cold
   and warm, copies from its code, the calldata and its own code, then runs
   400 rounds of a Solidity-shaped for-loop over a calldata word (JUMPDEST,
   DUP, PUSH, GT, ISZERO, JUMPI, CALLDATALOAD, SWAP, ADD, JUMP) and ends in
   a LOG1; the block goes through the same steps, the copy check's share beside the keccak, tx, sig and pi checks',
   two rebuilds (tx 3's LOG1 topic + 1, failing at its LOG step alone; the
   middle CALLDATALOAD's pushed word + 1, failing at that step and the
   state row of the SWAP1 that reads it, as the JAX verifier fails on the
   same edits of a 2 x 8 block), its logUp line, and the 2 x 8 block's
   failure dicts on the card and the CPU, clean and with both edits, and
   the conformance block's (``workloads.build_conformance_block``: 50
   execution states in one frame), clean;
10c. calls: the call block at a sixteenth of its rounds
   (``workloads.build_call_block(8, 19)``, signed: 5997 steps, 46746 rw
   rows, 500340 gas, 11776 copy rows; cut from 8 x 316 for the run's time,
   to 8 x 79 with the create phase and to 8 x 19 with the precompile
   phase; each tx a router calling 0xC0DE 19 times with
   CALL, STATICCALL, DELEGATECALL or CALLCODE, each round's return data
   copied into the next round's args,
   then a CALL with value, a 3-deep call through 0xB0B and a call to 0xDEAD,
   which writes and reverts; the last tx reverts at its root) through the
   same steps, the copy check's share beside the keccak, tx, sig and pi
   checks', two rebuilds (the first restored caller GasLeft + 1, failing at
   that CALL step and the state row of the halt that reads it back; the
   first tx's mirror of 0xDEAD's SSTORE + 1, failing at that SSTORE step,
   as the JAX verifier fails on the same edits of a 4 x 3 block), its logUp
   line, the 4 x 3 block's failure dicts on the card and the CPU, clean and
   with both edits, and the mega conformance block's
   (``workloads.build_conformance_mega_block``: 55 execution states, the
   four call opcodes among them), clean and with the GasLeft edit;
10d. create: the create-and-fail block (``workloads.build_create_block(8,
   8)``, signed: 5774 steps, 33282 rw rows, 5541204 gas, 9648 copy rows;
   each tx a factory running 8 rounds of CREATE2 of the self-replicating
   initcode then a CALL of the new contract, then a CREATE, a CREATE with
   value, a CREATE2 collision, a reverting initcode and an empty one, eight
   callees that each halt in one error state, and four sub-factories that
   each end in one create error; the last tx halts at its root in
   ErrorInvalidOpcode) through the same steps, the copy check's share
   beside the keccak, tx, sig and pi checks', two rebuilds (the first
   CREATE2's pushed address + 1, failing at that step and the state row
   of the first read of its stack slot; the caller's GasLeft that the first
   error halt in a sub-call reads back + 1, failing at that halt and the
   state row of the read, as the JAX verifier fails on the same edits of a
   2 x 1 block), its logUp line, the 2 x 1 block's failure dicts on the
   card and the CPU, clean and with both edits, and the create-then-call
   chain block's (``workloads.build_create_chain_block``,
   tests/test_block_create.py's), clean and with both edits;
10e. precompile: the proof-verifier and signature-relayer block
   (``workloads.build_precompile_block(4, 4, 64)``, signed: 10733 steps,
   469909 rw rows, 2635528 gas, 529664 copy rows; not cut): four rollups
   each STATICCALL the shared Groth16 verifier 0xBEEF with the proof in
   their calldata (2 ecMul, 2 ecAdd and a 4-pair ecPairing, the ecc
   circuit's capacity over the four; the result SSTOREd), four relayers
   each recover 64 signers (a round: CALLDATACOPY, identity, ecRecover and
   a LOG1 of the address), then an ecRecover with v = 29 and one given 2999
   gas (ErrorOutOfGasPrecompile), through the same steps, the ecc and
   sig_trace checks' shares beside the copy, keccak, tx, sig and pi
   checks', a rebuild with the first identity output byte + 1 in the rw
   rows (failing at its copy row and the state row of the byte's next
   read), its logUp line (sig and ecc among its families), and the small
   block's (``build_precompile_block(1, 1, 2)``: a rollup, a relayer of 2
   messages) failure dicts on the card and the CPU, clean and with each
   of ``workloads.PRECOMPILE_EDITS`` at its predicted keys (the first
   ecAdd op's out y + 1: that BN254_ADD step and ("ecc", 0); the first sig
   row's is_valid flipped: the first ECRECOVER step and ("sig_trace", 0);
   the identity edit), as the JAX verifier fails on the same edits;
11. tx_sig: ``tx_kernel`` and ``sig_kernel`` on 714 signed transfers
   (``workloads.signed_transfers``: half of 30000000 // 21000, the most a
   30 M-gas block holds, cut so that the run keeps its time;
   ``bench.py:bench_sig``'s shape, chain 1337): the host
   seconds of the signing, ``txs2witness``, ``sig_witness_from_txs`` and
   ``verify_batch`` (all Python ints, as in the JAX package), the build and
   the upload; one counted check of each with every lane passing (K8 at
   ``[64, 714]``, K6 on the prebuilt keccak index, no index built on the
   card), 10 timed checks, signed txs verified a second (``bench_sig``'s
   terms, and on the card alone); lane 700's ECDSA verdict flipped in the
   uploaded inputs, failing alone in each check; and the checks at 4
   transfers on the card and the CPU, clean and with one lane flipped;
12. kernels: each kernel against its plain version on the card at a shape
   of the path (bit-exact: they are integer functions), with the median of
   25 timed launches, the plain version's time and the bound; K1, K3 and
   K8 also at every distinct shape and mode the state, bytecode, keccak and
   withdrawal paths gave them (``path_shapes``), as K6 at its lookups
   (with the path its launcher took, one warp a lane or a staged tile) and
   K7 at both keccak tables, and every kernel at each distinct shape the
   block verifier's device pass gave it (``path_shapes`` entries labelled
   "block", "arith", "sstore", "flow", "calls", "create" or "precompile", 10 timed
   launches each, each
   entry with
   its count in the pass, the pi, tx, sig and copy checks' K1, K3, K4, K6
   and K8 calls among them, and at tx_sig's shapes, labelled "tx_sig";
   and likewise at
   each distinct shape of the eight ALU groups' replays, labelled with the
   group; K4 also with a bound that reads the table in whole 32-byte
   sectors, and at every gather-only shape ``torch.index_select`` a part
   as its library call;
   and "arith": K11 at each of its
   variants and shapes there, the exp circuit's included, 25 launches
   each, its bound at the least work on 32-bit words with a chain term
   (``runtime/bounds.py:word_mul_cost``, ``word_mul_chain_ms``); K2 has
   its row at the arithmetic block's widest shape, since the MUL group no
   longer launches it, and every distinct shape of that pass in its
   ``path_shapes``, each also held against Python ints).  K2's
   normalise-and-reduce entry (``limb_reduce``) at the logUp sides'
   ``[2, 16]`` (keep 17, reduced) and at ``[2, 32]`` (keep 32, reduced
   and rippled alone), and at every shape the logUp checks give it, each
   against Python ints, its bound the larger of its bytes and its chain
   (``runtime/bounds.py:reduce_chain``).  K5 at both state mixes' 2^19
   rows and at every block's state rows, each also against the keys compared
   on Python ints.  K8 at the ALU block's 66001 steps is
   timed at that shape and held against its plain version on the first
   512 steps of the same rows (256 at the block verifier's tables), which
   the line says (at the blocks' shapes its plain time is that of the one
   held call: it takes seconds); at every K8 shape of every path the whole output is
   also held against the Python-int Horner, and the entry gives the
   chunked schedule (``horner_schedule``: chunk, work items, launches,
   the kernels' resident blocks an SM) and its chain bound; K8's
   ``bound_ms`` counts the least work (``K8_OPS_PER_STEP``), not the
   kernel's own.  K9 at the
   ALU block's upload, beside the pinned host-to-device copy rate of the
   same bytes, and K10 at every block's verdict vectors (``torch.cat`` of
   the same vectors as its library call);
   K9 is held on the leaves and timed on its arena alone, the host's
   building of the leaf views timed on its own.  K12 at the logUp checks'
   one-lane inversion and at 131072 lanes, with its bounds from the least
   sliding-window chain for p - 2 (the kernel runs the width-4 chain);
   K13 at every partial sum of every family of every block (table and
   query side, up to the ALU block's 6160016 bytecode queries), with its
   plan (levels, tile, resident blocks) and the device launches of one
   call by entry, counted where each kernel is launched and held against
   the plan (each kernel's first logUp call held against its own plain
   call, timed, its others against one plain call over them all:
   ``logup_kernel_rows``), and K1-K4 at each distinct shape of every family's check
   (``path_shapes`` labelled "logup_block <family>"/"logup_arith
   <family>").  The bounds of K1, K8 (its chain), K12 and K13 count a
   field product at its least work on 32-bit words (``FR_PRODUCT_OPS``,
   ``fr_product_chain``: an 8 x 32-bit-limb Montgomery product).  K1 at
   every shape is also held against a * b mod p on Python ints, and K7
   against the host's numpy keccak-f, with the path it took (row or
   warp) and its chain bound (``runtime/bounds.py:keccak_round_chain``;
   its ``bound_ms`` the largest of bytes, operations and chain).  The
   peaks and K1's, K6's, K7's and K11's cost models are
   ``runtime/bounds.py``'s, which ``profile_replay.py`` shares.  A ``pass_sums`` line then
   gives, over each block's device pass (the graph's K10 included) and
   each block's logUp check (every family), for every kernel its calls,
   the sums of count x ms and of count x bound_ms and their difference
   (the time it loses to its bound), ranked by that loss, with K3's, K6's
   and K7's launches of each path.

The last three lines are the kernels line (every row with its
``block_pass_sums``), the card's nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing anything.
"""
import collections
import concurrent.futures
import contextlib
import ctypes
import functools
import json
import multiprocessing
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU")

from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.circuits import bytecode as bytecode_circuit  # noqa: E402
from zkevm_specs_tpu_torch.circuits import keccak as keccak_circuit  # noqa: E402
from zkevm_specs_tpu_torch.circuits import sig as sig_circuit  # noqa: E402
from zkevm_specs_tpu_torch.circuits import state  # noqa: E402
from zkevm_specs_tpu_torch.circuits import super_circuit  # noqa: E402
from zkevm_specs_tpu_torch.circuits import tx as tx_circuit  # noqa: E402
from zkevm_specs_tpu_torch.circuits import withdrawal as withdrawal_circuit  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.ops import fr  # noqa: E402
from zkevm_specs_tpu_torch.ops import keccak as keccak_ops  # noqa: E402
from zkevm_specs_tpu_torch.ops import limbs as L  # noqa: E402
from zkevm_specs_tpu_torch.ops import word_mul  # noqa: E402
from zkevm_specs_tpu_torch.ops.ecc import bn254, secp256k1  # noqa: E402
from zkevm_specs_tpu_torch.parallel import logup_shard  # noqa: E402
from zkevm_specs_tpu_torch.runtime import block as block_runtime  # noqa: E402
from zkevm_specs_tpu_torch.runtime.bounds import (  # noqa: E402
    DEP_LATENCY_CYCLES, HBM_BYTES_PER_S, K7_ROUND_CHAIN, WORD_MUL_CHAIN, bound, chain_bound,
    fingerprint_cost, fr_mul_cost, fr_product_ops, limb_mul_cost, nbytes, order_cost,
    reduce_chain, reduce_chain_ms, reduce_cost, search_cost, sm_clock_max_hz, sponge_chain_ms,
    sponge_cost, word_mul_chain_ms, word_mul_cost)
from zkevm_specs_tpu_torch.runtime import cuda_build  # noqa: E402
from zkevm_specs_tpu_torch.runtime import native  # noqa: E402
from zkevm_specs_tpu_torch.runtime import profiling  # noqa: E402
from zkevm_specs_tpu_torch.runtime import transfer  # noqa: E402
from zkevm_specs_tpu_torch.runtime.convert import to_device  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.runtime.timing import time_on_card_ms  # noqa: E402
from zkevm_specs_tpu_torch.tables import engine  # noqa: E402
from zkevm_specs_tpu_torch.tables import logup  # noqa: E402
from zkevm_specs_tpu_torch.tables.schemas import (  # noqa: E402
    RW, BytecodeFieldTag, CallContextFieldTag, Target, TxLogFieldTag)
from zkevm_specs_tpu_torch.witness import tracer  # noqa: E402
from zkevm_specs_tpu_torch.workloads import build_add_workload, build_mul_workload  # noqa: E402

LANES = workloads.GROUP_LANES
# the eight ALU gadgets' groups at a quarter of bench.py's BENCH_STEPS: with
# the loop block's phase the whole run went past the time it has (the
# replays are bound by their launches, not their lanes)
ALU_GROUP_LANES = LANES // 4
SMALL_LANES = 256
CORRUPT_LANE = 77_777
REPLAY_REPEATS = 10
KERNEL_REPEATS = 25
# the kernels whose wrappers launch once a call: their captured calls at a
# block's pass add up to the pass's launches
COUNTED_CALLS = ("fr_mul", "limb_addsub", "lookup_gather_eq", "keccak_sponge")
STATE_ROWS = workloads.ALU_BLOCK_STATE_ROWS
SMALL_STATE_ROWS = 512
CORRUPT_ROW = 77_777
ALU_TXS, ALU_OPS = workloads.ALU_BLOCK_TXS, workloads.ALU_BLOCK_OPS
# the block verifier's ALU block at a quarter of its rounds (the bytecode and
# keccak phases keep its full codes): with the call block's phase, and again
# with the precompile phase, the whole run went past the time it has
BLOCK_ALU_OPS = ALU_OPS // 4
SMALL_K = 10
SHA3_PREIMAGES = workloads.SHA3_MIX_PREIMAGES
SMALL_SHA3 = 512
WITHDRAWALS = workloads.MAX_WITHDRAWALS_PER_PAYLOAD
# K8's plain version at the ALU block: the first steps only (its plain
# version takes about 12 ms a step; the run's time)
K8_HELD_STEPS = 512
K8_BLOCK_HELD_STEPS = 256  # ... and at the block verifiers' keccak tables (another r)
BLOCK_SHAPE_REPEATS = 10  # timed launches of a kernel at each of the block's shapes
BLOCK_PASS_REPEATS = 5    # the per-kernel pass at the ALU block (about a third of a second each)
SMALL_BLOCK = (2, 6)      # txs x rounds of the block held against the CPU
# its txs' calldata: zero and nonzero bytes, 43 in all
SMALL_BLOCK_CALL_DATA = (bytes([0, 1, 2, 0]), bytes(range(1, 40)))
# the arithmetic block at an eighth of its txs (workloads.ARITH_BLOCK_TXS is
# 40): with the SSTORE, tx_sig and loop-block phases, and again with the
# precompile phase, the whole block ran past the time the run has
ARITH_TXS, ARITH_CYCLES = workloads.ARITH_BLOCK_TXS // 8, workloads.ARITH_BLOCK_CYCLES
SMALL_ARITH = (4, 1)      # txs x cycles of the arithmetic block held against the CPU
SSTORE_TXS = workloads.SSTORE_BLOCK_TXS
SMALL_SSTORE = 2          # txs of the SSTORE block held against the CPU
# half of the most signed transfers a 30 M-gas block holds: with the call
# block's phase the whole run went past the time it has
TX_SIG_TXS = workloads.TX_SIG_TXS // 2
SMALL_TX_SIG = 4          # signed transfers of the tx and sig checks held against the CPU
TX_SIG_CORRUPT_LANE = 700
# the loop block at half its txs and a quarter of its rounds
# (workloads.FLOW_BLOCK_TXS x FLOW_BLOCK_ITERATIONS is 8 x 1600): with the
# call block's phase, and again with the precompile phase, the whole run went
# past the time it has; the call block runs the same loop gadgets
FLOW_TXS = workloads.FLOW_BLOCK_TXS // 2
FLOW_ITERATIONS = workloads.FLOW_BLOCK_ITERATIONS // 4
SMALL_FLOW = (2, 8)       # txs x rounds of the loop block held against the CPU
# the call block at a sixteenth of its rounds (the run's time: a quarter since
# the create phase, a sixteenth since the precompile phase)
CALL_TXS, CALL_ROUNDS = workloads.CALL_BLOCK_TXS, workloads.CALL_BLOCK_ROUNDS // 16
SMALL_CALLS = (4, 3)      # txs x rounds of the call block held against the CPU
CREATE_TXS, CREATE_ROUNDS = workloads.CREATE_BLOCK_TXS, workloads.CREATE_BLOCK_ROUNDS
SMALL_CREATE = (2, 1)     # txs x rounds of the create block held against the CPU
PRECOMPILE_SIZE = (workloads.PRECOMPILE_VERIFIER_TXS, workloads.PRECOMPILE_RELAYER_TXS,
                   workloads.PRECOMPILE_MESSAGES)
# verifier txs x relayer txs x messages of the precompile block held against the CPU
SMALL_PRECOMPILE = (1, 1, 2)
# the label of each block phase in workloads.LOGUP_SIDES
BLOCK_LABELS = {"block": "ALU", "arith": "arith", "sstore": "sstore", "flow": "flow",
                "calls": "calls", "create": "create", "precompile": "precompile"}
FR_INV_LANES = 131072     # K12 held and timed beside its one-lane path shape

# the kernels by the name their wrapper counts launches under (L.LAUNCHES)
KERNELS = ("fr_mul", "limb_mul", "limb_reduce", "limb_addsub", "lookup_gather_eq",
           "state_order_lt", "lookup_search_eq", "lookup_fingerprint", "keccak_sponge",
           "horner_rlc", "leaf_unpack", "verdict_pack", "mul_add_words", "fr_inv", "logup_sum")
SOURCES = {name: f"zkevm_specs_tpu_torch/csrc/{name}.cu" for name in KERNELS}
SOURCES["lookup_fingerprint"] = "zkevm_specs_tpu_torch/csrc/lookup_search_eq.cu"
SOURCES["limb_reduce"] = "zkevm_specs_tpu_torch/csrc/limb_mul.cu"
REPLACES = {
    "fr_mul": "zkevm_specs_tpu/ops/fr.py:97 (mul -> reduce_wide :43; retired Pallas "
              "fr_mul_pallas, ops/pallas_fr.py:146 before 8a07970)",
    "limb_mul": "zkevm_specs_tpu/ops/limbs.py:277 (mul, with carry_propagate :197)",
    "limb_reduce": "zkevm_specs_tpu/ops/limbs.py:197 (carry_propagate) with ops/fr.py:43 "
                   "(reduce_wide), as parallel/logup_shard.py:153-154 composes them",
    "limb_addsub": "zkevm_specs_tpu/ops/limbs.py:228 (add/sub :228-252; fr.py:66-94 "
                   "add/sub/neg/reduce_once)",
    "lookup_gather_eq": "zkevm_specs_tpu/tables/engine.py:199 (Table.lookup hint replay, "
                        "_gather_rows :313)",
    "state_order_lt": "zkevm_specs_tpu/circuits/state.py:253 (_order_limbs of the rows and of "
                      "shifted(-1), with the L.lt of :304-311)",
    "lookup_search_eq": "zkevm_specs_tpu/tables/engine.py:227 (Table.lookup non-hinted branch, "
                        ":227-280)",
    "lookup_fingerprint": "zkevm_specs_tpu/tables/engine.py:109 (_fingerprint inside index_for "
                          ":141-164, built under jit)",
    "keccak_sponge": "zkevm_specs_tpu/ops/keccak.py:171 (keccak_f_lanes, keccak_round :136, "
                     "keccak256_batch_fixed_blocks :195; absorb loop circuits/keccak.py:158-179)",
    "horner_rlc": "zkevm_specs_tpu/circuits/keccak.py:44 (_horner_rlc :44-74)",
    "leaf_unpack": "zkevm_specs_tpu/runtime/block.py:61 (_ship_leaves :61-115, its jitted "
                   "unpacker :99-115)",
    "verdict_pack": "zkevm_specs_tpu/runtime/block.py:468 (make_combined's verdict "
                    "concatenation :514-519, read in run_device_combined's order :536-553)",
    "mul_add_words": "zkevm_specs_tpu/evm/instruction.py:812 (_mul_512_terms, with "
                     "mul_add_words :827 and mul_add_words_512 :845; circuits/exp.py:"
                     "_mul_add_words :19)",
    "fr_inv": "zkevm_specs_tpu/ops/fr.py:134 (inv :134-158, its lax.scan ladder; numpy "
              "pow_const :112-127)",
    "logup_sum": "zkevm_specs_tpu/tables/logup.py:87 (logup_partial_sum :87-106 with "
                 "batch_inverse :49-84)",
}
# kernels each path must launch
PATH_KERNELS = {"ADD": ("limb_addsub", "lookup_gather_eq"),
                "MUL": ("fr_mul", "limb_addsub", "lookup_gather_eq", "mul_add_words"),
                "state_memory_stack": ("state_order_lt", "limb_addsub"),
                "state_storage_account": ("state_order_lt", "limb_addsub", "lookup_search_eq",
                                          "lookup_fingerprint"),
                "bytecode": ("fr_mul", "limb_addsub", "lookup_search_eq"),
                "keccak_alu_block": ("keccak_sponge", "horner_rlc"),
                "keccak_sha3_mix": ("keccak_sponge", "horner_rlc"),
                "withdrawal": ("horner_rlc", "limb_addsub", "lookup_search_eq",
                               "lookup_fingerprint"),
                "block": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_addsub",
                          "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                          "lookup_fingerprint", "keccak_sponge", "horner_rlc"),
                "arith": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_mul", "limb_addsub",
                          "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                          "lookup_fingerprint", "keccak_sponge", "horner_rlc", "mul_add_words"),
                "sstore": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_addsub",
                           "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                           "lookup_fingerprint", "keccak_sponge", "horner_rlc"),
                "flow": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_mul", "limb_addsub",
                         "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                         "lookup_fingerprint", "keccak_sponge", "horner_rlc"),
                "calls": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_mul", "limb_addsub",
                          "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                          "lookup_fingerprint", "keccak_sponge", "horner_rlc"),
                "create": ("leaf_unpack", "verdict_pack", "fr_mul", "limb_mul", "limb_addsub",
                           "lookup_gather_eq", "state_order_lt", "lookup_search_eq",
                           "lookup_fingerprint", "keccak_sponge", "horner_rlc"),
                "tx_sig": ("horner_rlc", "lookup_search_eq"),
                "logup": ("lookup_gather_eq", "fr_mul", "limb_reduce", "limb_addsub", "fr_inv",
                          "logup_sum")}
# the precompile block's pass launches the create block's kernels (and K11 once)
PATH_KERNELS["precompile"] = PATH_KERNELS["create"]
# the sharded checks at world size 1: the groups, the state check, the
# circuits and the logUp argument, with no K9 upload nor K10 pack
PATH_KERNELS["sharded"] = ("fr_mul", "limb_addsub", "lookup_gather_eq", "state_order_lt",
                           "lookup_search_eq", "keccak_sponge", "horner_rlc", "fr_inv",
                           "logup_sum", "limb_reduce")
# the last eight ALU gadgets' groups: every one reaches K3 and K4 (their
# fixed Bitwise, SignByte and Pow2 lookups are computed predicates, as in the
# JAX package); SLT's and SAR's bytes_to_fq products reach K2 and K1
for _name in workloads.ALU_GROUPS:
    PATH_KERNELS[_name] = (("fr_mul", "limb_mul", "limb_addsub", "lookup_gather_eq")
                           if _name in ("SLT", "SAR") else ("limb_addsub", "lookup_gather_eq"))


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "ended_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def reset_counts():
    L.LAUNCHES.clear()


def read_counts():
    return {name: L.LAUNCHES[name] for name in KERNELS}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: the slice ---------------------------------------------------------

def run_group(name, exec_state, build, n_pops, corrupt, card, phase, lanes=LANES):
    """One group of ``n_pops``-operand steps through the compiled group
    verifier at ``lanes`` lanes (phase 3 of the module docstring); returns
    the main path's launch counts and (the uploaded inputs, every kernel's
    arguments at each distinct shape of one more replay)."""
    out = {"phase": phase, "group": name, "lanes": lanes, "card": card}
    t_phase = t0 = time.perf_counter()
    tables, steps, nexts = build(lanes)
    t1 = time.perf_counter()
    verifier = CompiledGroupVerifier(tables, exec_state, steps, nexts)   # device "cuda"
    t2 = time.perf_counter()
    inputs = verifier.prepare_inputs(steps, nexts)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del tables, steps, nexts

    # the main path: counts set to 0 just before the replay, read just after
    reset_counts()
    fail = verifier(*inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.dtype == torch.bool and fail.shape == (lanes,)
    assert not bool(fail.any()), f"{name}: {int(fail.sum())} lanes failed on a valid witness"
    for k in PATH_KERNELS[name]:
        assert counts[k] > 0, f"{name}: kernel {k} was not launched on the main path"

    replay_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        verifier(*inputs)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(replay_ms)
    out.update({
        "workload_build_s": t1 - t0, "host_trace_s": t2 - t1, "upload_s": t3 - t2,
        "n_constraints": verifier.n_constraints, "n_lookups": verifier.n_hints,
        "launches": counts, "replay_ms_median": med, "replay_ms_min": min(replay_ms),
        "steps_per_s": lanes / (med / 1e3),
        "constraint_evals_per_s": lanes * verifier.n_constraints / (med / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    _, calls = capture_pass(lambda: verifier(*inputs))
    out["distinct_kernel_shapes"] = {k: len(c) for k, c in calls.items()}
    # the corrupted lane as an edit of the uploaded inputs, the clean trace
    # reused (the builder's own corrupt_lane runs at 256 lanes below)
    corrupt_lane = CORRUPT_LANE % lanes
    with corrupted_upload(inputs, corrupt_lane, n_pops, corrupt):
        fail = verifier(*inputs)
    bad = torch.nonzero(fail).flatten().tolist()
    assert bad == [corrupt_lane], f"{name}: corrupted lane {corrupt_lane}, failing lanes {bad[:8]}"
    out["corrupt_lane_caught"] = corrupt_lane
    del fail, verifier

    # the card's replay against the CPU replay (plain versions) at 256 lanes
    for bad_lane in (None, 3):
        tables, steps, nexts = build(SMALL_LANES, seed=1, corrupt_lane=bad_lane)
        on_card = CompiledGroupVerifier(tables, exec_state, steps, nexts)
        on_cpu = CompiledGroupVerifier(tables, exec_state, steps, nexts, device="cpu")
        f_card = on_card(*on_card.prepare_inputs(steps, nexts)).cpu()
        f_cpu = on_cpu(*on_cpu.prepare_inputs(steps, nexts))
        assert torch.equal(f_card, f_cpu), f"{name}: card and CPU replays disagree"
        assert torch.nonzero(f_card).flatten().tolist() == ([] if bad_lane is None else [bad_lane])
    out["small_replay_matches_cpu"] = True
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit(out)
    return counts, (inputs, calls)


@contextlib.contextmanager
def corrupted_upload(inputs, lane, n_pops, corrupt):
    """A group's uploaded replay inputs with ``lane`` made wrong by one while
    active, as ``workloads.build_op_workload``'s ``corrupt_lane`` makes it:
    the lane's pushed word (its rw row after its ``n_pops`` pops; the lowest
    bit of the value flipped) for ``corrupt="result"``, the step's gas_left
    + 1 for ``"gas_left"``."""
    curr, _, tree, _ = inputs
    if corrupt == "gas_left":
        cell = curr["gas_left"][lane]
        old = cell.clone()
        cell[0] += 1
    else:
        cell = tree["rw"]["cols"]["value"]["lo"][lane * (n_pops + 1) + n_pops]
        old = cell.clone()
        cell[0] ^= 1
    try:
        yield
    finally:
        cell.copy_(old)


# -- phase 4: the state circuit ---------------------------------------------------

class Capture:
    """Records the arguments of calls of ``module.name`` while active: the
    first call for each value of ``key(args)`` (by default the first call
    only), its positional arguments in ``calls`` and its keyword arguments
    in ``kwargs``, and every call counted under its key in ``counts``.  Used
    on a run outside the counted main path, to hold and time the kernels at
    the path's own shapes."""

    def __init__(self, module, name, key=lambda args: None):
        self.module, self.name, self.key, self.calls, self.kwargs = module, name, key, {}, {}
        self.counts = collections.Counter()
        self.orig = getattr(module, name)

    def __enter__(self):
        def record(*args, **kw):
            key = self.key(args)
            if key not in self.calls:
                self.calls[key], self.kwargs[key] = args, kw
            self.counts[key] += 1
            return self.orig(*args, **kw)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def addsub_key(args):
    """K3's (mode, out_n, operand shapes, operand row strides): one capture
    for each (a view of wider rows loads otherwise than a dense tensor)."""
    a, b, mode = args[:3]
    return (mode, args[3] if len(args) > 3 else 0, tuple(a.shape), tuple(b.shape),
            L.row_stride(a), L.row_stride(b))


def shapes(ts):
    return tuple(None if t is None else tuple(t.shape) for t in ts)


def gather_key(args):
    """K4's table, query (None for a part only gathered), lane and enabled
    shapes."""
    table, query, idx = args[:3]
    enabled = args[3] if len(args) > 3 else None
    return shapes(table), shapes(query), tuple(idx.shape), shapes([enabled])


def search_key(args):
    query, table, _coefs, fps, _order, max_span, batch = args
    return shapes(query), shapes(table), fps.shape[0], max_span, batch


def mul_key(args):
    """K2's (operand shapes, row strides, out_n): one capture for each."""
    a, b, out_n = args
    return shapes((a, b)), L.row_stride(a), L.row_stride(b), out_n


def reduce_key(args):
    """K2's normalise-and-reduce entry: (shape, row stride, keep, reduce)."""
    x, keep, reduce = args
    return tuple(x.shape), x.stride(0), keep, bool(reduce)


def word_mul_key(args):
    """K11's (variant, row shapes): one capture for each."""
    return (len(args) > 1 and bool(args[1]), shapes(args[0]))


# the keyword under which a captured call's count rides beside its keyword
# arguments (``block_path_shapes`` takes it out before a call)
COUNT = "__count__"

# the kernel wrappers the block verifier's device pass calls, as (kernel,
# module, attribute, key of a distinct shape)
BLOCK_CAPTURES = (
    ("fr_mul", fr, "fr_mul", lambda a: shapes(a)),
    ("limb_mul", L, "limb_mul", mul_key),
    ("limb_reduce", L, "limb_reduce", reduce_key),
    ("limb_addsub", L, "limb_addsub", addsub_key),
    ("lookup_gather_eq", engine, "lookup_gather_eq", gather_key),
    ("state_order_lt", state, "state_order_lt", lambda a: shapes(a)),
    ("lookup_search_eq", engine, "lookup_search_eq", search_key),
    ("lookup_fingerprint", engine, "lookup_fingerprint", lambda a: (shapes(a[0]), shapes(a[1:]))),
    ("keccak_sponge", keccak_circuit, "keccak_sponge", lambda a: shapes(a)),
    ("horner_rlc", keccak_circuit, "horner_rlc", lambda a: (shapes(a[:2]), a[2])),
    ("horner_rlc", withdrawal_circuit, "horner_rlc", lambda a: (shapes(a[:2]), a[2])),
    ("horner_rlc", sig_circuit, "horner_rlc", lambda a: (shapes(a[:2]), a[2])),
    ("mul_add_words", word_mul, "mul_add_words", word_mul_key),
)


def capture_pass(fn):
    """``fn()`` with every wrapper of BLOCK_CAPTURES recorded: its result
    and, by kernel, the arguments of each distinct shape with the count of
    calls at it (outside the counted runs)."""
    with contextlib.ExitStack() as stack:
        caps = [(name, stack.enter_context(Capture(module, attr, key)))
                for name, module, attr, key in BLOCK_CAPTURES]
        result = fn()
    torch.cuda.synchronize()
    calls = {}
    for name, c in caps:
        calls.setdefault(name, []).extend((args, {**c.kwargs[k], COUNT: c.counts[k]})
                                          for k, args in c.calls.items())
    return result, calls


def state_inputs(mix, n_rows, corrupt_row=None, seed=0):
    rows, mpt_rows = getattr(workloads, f"build_state_{mix}")(n_rows, seed=seed,
                                                             corrupt_row=corrupt_row)
    return state.pack_state_inputs(rows, mpt_rows)


def run_state(mix, card):
    path = f"state_{mix}"
    out = {"phase": "state", "mix": mix, "rows": STATE_ROWS, "card": card}
    t0 = time.perf_counter()
    rows, mpt_rows = getattr(workloads, f"build_state_{mix}")(STATE_ROWS)
    t1 = time.perf_counter()
    cols, tree, meta = state.pack_state_inputs(rows, mpt_rows)
    t2 = time.perf_counter()
    inputs = to_device((cols, tree), "cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check = state.make_state_check_fn(meta)                 # device "cuda"
    del rows, mpt_rows, cols, tree

    # the main path: counts set to 0 just before the check, read just after
    reset_counts()
    fail = check(*inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.dtype == torch.bool and fail.shape == (STATE_ROWS,)
    assert not bool(fail.any()), f"{path}: {int(fail.sum())} rows failed on a valid witness"
    for k in PATH_KERNELS[path]:
        assert counts[k] > 0, f"{path}: kernel {k} was not launched on the main path"
    if mix == "storage_account":
        assert counts["lookup_search_eq"] == 2, f"{path}: {counts['lookup_search_eq']} K6 launches"

    torch.cuda.reset_peak_memory_stats()
    check_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        check(*inputs)
        torch.cuda.synchronize()
        check_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(check_ms)
    out.update({
        "workload_build_s": t1 - t0, "pack_s": t2 - t1, "upload_s": t3 - t2,
        "mpt_rows": meta["mpt_rows"], "launches": counts, "check_ms_median": med,
        "check_ms_min": min(check_ms), "rows_per_s": STATE_ROWS / (med / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })

    # the kernels' arguments at the path's shapes, from one more check; K5
    # takes the uploaded key columns as they are
    cols = inputs[0]
    captured = {"state_order_lt": tuple(cols[c] for c in (
        "tag", "id", "address", "field_tag", "storage_key_lo", "storage_key_hi", "rw_counter"))}
    with Capture(L, "limb_addsub", addsub_key) as k3, Capture(engine, "lookup_search_eq") as k6, \
            Capture(engine, "lookup_fingerprint") as k6f:
        check(*inputs)
    captured.update(limb_addsub=k3.calls, lookup_search_eq=k6.calls.get(None),
                    lookup_fingerprint=k6f.calls.get(None))
    del inputs, fail, cols

    cols, tree, meta = state_inputs(mix, STATE_ROWS, corrupt_row=CORRUPT_ROW)
    fail = state.make_state_check_fn(meta)(*to_device((cols, tree), "cuda"))
    bad = torch.nonzero(fail).flatten().tolist()
    assert bad == [CORRUPT_ROW], f"{path}: corrupted row {CORRUPT_ROW}, failing rows {bad[:8]}"
    out["corrupt_row_caught"] = CORRUPT_ROW
    del cols, tree, fail

    # the card's check against the same check on the CPU at 512 rows
    for corrupt in (None, 101):
        cols, tree, meta = state_inputs(mix, SMALL_STATE_ROWS, corrupt_row=corrupt, seed=1)
        f_card = state.make_state_check_fn(meta)(*to_device((cols, tree), "cuda")).cpu()
        f_cpu = state.make_state_check_fn(meta, device="cpu")(*to_device((cols, tree), "cpu"))
        assert torch.equal(f_card, f_cpu), f"{path}: card and CPU checks disagree"
        assert torch.nonzero(f_card).flatten().tolist() == ([] if corrupt is None else [corrupt])
    out["small_check_matches_cpu"] = True
    torch.cuda.empty_cache()
    emit(out)
    return counts, captured


# -- phase 5: the bytecode circuit ------------------------------------------------

def run_bytecode(card):
    out = {"phase": "bytecode", "txs": ALU_TXS, "ops_per_tx": ALU_OPS, "card": card}
    t0 = time.perf_counter()
    rows, keccak_rows, r = workloads.build_alu_bytecodes(ALU_TXS, ALU_OPS)
    t1 = time.perf_counter()
    kernel = bytecode_circuit.bytecode_kernel(rows, keccak_rows, r)     # device "cuda"
    t2 = time.perf_counter()
    args = kernel.device_args()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n = len(rows)
    k = n.bit_length() - 1
    codes = workloads.alu_bytecodes(ALU_TXS, ALU_OPS)
    assert n == 1 << k == 1 << workloads.bytecode_k(codes)
    unrolled = sum(len(c) + 1 for c in codes)       # a Header and the Byte rows of each code
    corrupt = next(i for i in range(CORRUPT_ROW, n) if rows[i]["tag"] == int(BytecodeFieldTag.Byte))
    del rows

    reset_counts()
    fail = kernel(args)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.shape == (n,)
    assert not bool(fail.any()), f"bytecode: {int(fail.sum())} rows failed on valid bytecodes"
    for name in PATH_KERNELS["bytecode"]:
        assert counts[name] > 0, f"bytecode: kernel {name} was not launched on the main path"

    torch.cuda.reset_peak_memory_stats()
    check_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        kernel(args)
        torch.cuda.synchronize()
        check_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(check_ms)
    out.update({
        "k": k, "rows": n, "keccak_rows": len(keccak_rows), "workload_build_s": t1 - t0,
        "pack_s": t2 - t1, "upload_s": t3 - t2, "launches": counts, "check_ms_median": med,
        "check_ms_min": min(check_ms), "rows_per_s": n / (med / 1e3),
        "unrolled_rows": unrolled, "unrolled_rows_per_s": unrolled / (med / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    with Capture(engine, "lookup_search_eq") as k6, Capture(fr, "fr_mul") as k1, \
            Capture(L, "limb_addsub", addsub_key) as k3:
        kernel(args)
    captured = {"lookup_search_eq": k6.calls[None], "fr_mul": k1.calls[None],
                "limb_addsub": k3.calls}
    del kernel, args, fail

    rows, keccak_rows, r = workloads.build_alu_bytecodes(ALU_TXS, ALU_OPS, corrupt_row=corrupt)
    fail = bytecode_circuit.bytecode_kernel(rows, keccak_rows, r)()
    bad = torch.nonzero(fail).flatten().tolist()
    assert bad and all(abs(i - corrupt) <= 1 for i in bad), \
        f"bytecode: corrupted byte at row {corrupt}, failing rows {bad[:8]}"
    out["corrupt_row"], out["failing_rows"] = corrupt, bad
    del rows, fail

    # the card's check against the same check on the CPU at k = 10
    for corrupt in (None, 45):
        rows, keccak_rows, r = workloads.build_alu_bytecodes(2, 40, k=SMALL_K, seed=1,
                                                             corrupt_row=corrupt)
        f_card = bytecode_circuit.bytecode_kernel(rows, keccak_rows, r)().cpu()
        f_cpu = bytecode_circuit.bytecode_kernel(rows, keccak_rows, r, device="cpu")()
        assert torch.equal(f_card, f_cpu), "bytecode: card and CPU checks disagree"
        assert bool(f_card.any()) == (corrupt is not None)
    out["small_check_matches_cpu"] = True
    torch.cuda.empty_cache()
    emit(out)
    return counts, captured


# -- phase 6: the keccak circuit --------------------------------------------------

KECCAK_DATA = {
    # data: (builder, the two corrupted rows (output, input_rlc), the small size)
    "alu_block": (workloads.build_keccak_alu_block, (2, 5),
                  lambda **kw: workloads.build_keccak_alu_block(2, 40, seed=1, **kw)),
    "sha3_mix": (workloads.build_keccak_sha3_mix, (40_000, 54_321),
                 lambda **kw: workloads.build_keccak_sha3_mix(SMALL_SHA3, seed=1, **kw)),
}


def run_keccak(data, card):
    path = f"keccak_{data}"
    build, bad_rows, small_build = KECCAK_DATA[data]
    out = {"phase": "keccak", "data": data, "card": card}
    t0 = time.perf_counter()
    preimages, rows, r = build()
    t1 = time.perf_counter()
    kernel = keccak_circuit.keccak_kernel(preimages, rows, r)          # device "cuda"
    t2 = time.perf_counter()
    args = kernel.device_args()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n = len(preimages)
    extra = args[2]

    reset_counts()
    fail = kernel(args)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.dtype == torch.bool and fail.shape == (n,)
    assert not bool(fail.any()), f"{path}: {int(fail.sum())} rows failed on a valid table"
    for name in PATH_KERNELS[path]:
        assert counts[name] > 0, f"{path}: kernel {name} was not launched on the main path"

    torch.cuda.reset_peak_memory_stats()
    check_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        kernel(args)
        torch.cuda.synchronize()
        check_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(check_ms)
    n_bytes = sum(len(p) for p in preimages)
    out.update({
        "rows": n, "preimage_bytes": n_bytes, "rate_blocks": int(extra["n_blocks"].sum()),
        "max_blocks": int(extra["blocks"].shape[1]), "max_len": int(extra["byte_cols"].shape[0]),
        "r_limbs": (r.bit_length() + 15) // 16, "workload_build_s": t1 - t0, "pack_s": t2 - t1,
        "upload_s": t3 - t2, "launches": counts, "check_ms_median": med,
        "check_ms_min": min(check_ms), "rows_per_s": n / (med / 1e3),
        "preimage_bytes_per_s": n_bytes / (med / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    with Capture(keccak_circuit, "keccak_sponge") as k7, \
            Capture(keccak_circuit, "horner_rlc") as k8:
        kernel(args)
    captured = {"keccak_sponge": k7.calls[None], "horner_rlc": k8.calls[None]}
    del kernel, args, extra, fail, rows

    # one rebuild for each of the JAX package's two wrong-table vectors
    for corrupt, row in zip(("output", "input_rlc"), bad_rows):
        pre, bad_table, r_bad = build(corrupt_row=row, corrupt=corrupt)
        fail = keccak_circuit.keccak_kernel(pre, bad_table, r_bad)()
        bad = torch.nonzero(fail).flatten().tolist()
        assert bad == [row], f"{path}: corrupted {corrupt} of row {row}, failing rows {bad[:8]}"
        out[f"corrupt_{corrupt}_row_caught"] = row
        del pre, bad_table, fail

    # the card's check against the same check on the CPU at a small size
    for corrupt in (None, 1):
        pre, table, r_s = small_build(corrupt_row=corrupt, corrupt="input_rlc")
        f_card = keccak_circuit.keccak_kernel(pre, table, r_s)().cpu()
        f_cpu = keccak_circuit.keccak_kernel(pre, table, r_s, device="cpu")()
        assert torch.equal(f_card, f_cpu), f"{path}: card and CPU checks disagree"
        assert torch.nonzero(f_card).flatten().tolist() == ([] if corrupt is None else [corrupt])
    out["small_check_matches_cpu"] = len(pre)
    torch.cuda.empty_cache()
    emit(out)
    return counts, captured


# -- phase 7: the withdrawal circuit ----------------------------------------------

def run_withdrawal(card):
    path = "withdrawal"
    out = {"phase": "withdrawal", "rows": WITHDRAWALS, "card": card}
    t0 = time.perf_counter()
    witness, n, r = workloads.build_withdrawals(WITHDRAWALS)
    t1 = time.perf_counter()
    kernel = withdrawal_circuit.withdrawal_kernel(witness, n, r)      # device "cuda"
    t2 = time.perf_counter()
    args = kernel.device_args()
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    reset_counts()
    fail = kernel(args)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.dtype == torch.bool and fail.shape == (n,)
    assert not bool(fail.any()), f"{path}: {int(fail.sum())} rows failed on a valid witness"
    for name in PATH_KERNELS[path]:
        assert counts[name] > 0, f"{path}: kernel {name} was not launched on the main path"
    assert counts["lookup_search_eq"] == 3 and counts["lookup_fingerprint"] == 1, counts

    check_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        kernel(args)
        torch.cuda.synchronize()
        check_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(check_ms)
    out.update({
        "workload_build_s": t1 - t0, "pack_s": t2 - t1, "upload_s": t3 - t2,
        "rlp_max_len": int(args[2]["byte_cols"].shape[0]), "launches": counts,
        "check_ms_median": med, "check_ms_min": min(check_ms), "rows_per_s": n / (med / 1e3),
    })
    with Capture(withdrawal_circuit, "horner_rlc") as k8, \
            Capture(L, "limb_addsub", addsub_key) as k3:
        kernel(args)
    captured = {"horner_rlc": k8.calls[None], "limb_addsub": k3.calls}
    del kernel, args, fail

    corrupt = 5
    witness, n, r = workloads.build_withdrawals(WITHDRAWALS, corrupt_row=corrupt)
    fail = withdrawal_circuit.withdrawal_kernel(witness, n, r)()
    bad = torch.nonzero(fail).flatten().tolist()
    assert bad == [corrupt], f"{path}: corrupted amount of row {corrupt}, failing rows {bad[:8]}"
    out["corrupt_row_caught"] = corrupt

    # the card's check against the CPU, on a payload with padding rows
    for corrupt in (None, 7):
        witness, n, r = workloads.build_withdrawals(WITHDRAWALS, n_real=11, seed=1,
                                                    corrupt_row=corrupt)
        f_card = withdrawal_circuit.withdrawal_kernel(witness, n, r)().cpu()
        f_cpu = withdrawal_circuit.withdrawal_kernel(witness, n, r, device="cpu")()
        assert torch.equal(f_card, f_cpu), f"{path}: card and CPU checks disagree"
        assert torch.nonzero(f_card).flatten().tolist() == ([] if corrupt is None else [corrupt])
    out["small_check_matches_cpu"] = True
    emit(out)
    return counts, captured


# -- phases 8-11: the five blocks through the block verifier, and the tx and sig checks

def host_ms(fn, repeats):
    """Median host wall time of ``fn()`` ending in a synchronise, and its
    last result."""
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), out


def captured_device_ms(fn):
    """The device time of ``fn()`` alone: captured in its own CUDA graph
    (after a warm-up call on a side stream, as the block verifier
    captures its pass) and its replay timed with CUDA events, so that it
    compares with the block graph's ``graph_device_ms``; a call from
    Python would also count the host's gaps between its launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_on_card_ms(graph.replay, repeats=5, warmup=1)


def corrupt_gas_left(w):
    """One ADD step's gas_left + 1: that step or its predecessor fails,
    nothing else."""
    adds = [i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.ADD]
    bad = adds[len(adds) // 2]
    w.steps[bad].gas_left += 1

    def undo():
        w.steps[bad].gas_left -= 1

    return {"corrupt_step": bad}, lambda bv, f: bool(f) and set(f) <= {bad - 1, bad}, undo


def corrupt_mulmod_push(w):
    """The pushed result of the middle MULMOD step + 1: exactly that step
    and the state row of the POP that reads the result fail, as the JAX
    verifier's keys on the same edit of the 4 x 1 block
    (tests/test_torch_block.py, arith_mulmod_push)."""
    mulmods = [i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.MULMOD]
    bad = mulmods[len(mulmods) // 2]
    rwc = w.steps[bad].rw_counter + 3
    row = next(r for r in w.rw.rws if r["rw_counter"] == rwc)
    assert row["key0"] == int(Target.Stack) and row["rw"] == int(RW.Write)
    old = row["value"]
    row["value"] = (old + 1) % (1 << 256)

    def expected(bv, f):
        pop_read = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == rwc + 1]
        return set(f) == {bad, ("state", pop_read[0])}

    def undo():
        row["value"] = old

    return {"corrupt_mulmod_step": bad}, expected, undo


def corrupt_exp_row_d(w):
    """One exp-circuit row's d + 1, a row in the middle of the table that is
    not the first of its event: exactly it and its predecessor (whose
    ``a`` no longer equals the next ``d``) fail, as the JAX verifier's keys
    on the same edit (tests/test_torch_block.py, arith_exp_row_d)."""
    rows = w.exp_circuit.rows
    k = next(k for k in range(len(rows) // 2, len(rows))
             if rows[k]["identifier"] == rows[k - 1]["identifier"])
    old = rows[k]["d"]
    rows[k]["d"] = (old + 1) % (1 << 256)

    def undo():
        rows[k]["d"] = old

    return {"corrupt_exp_row": k}, lambda bv, f: set(f) == {("exp", k - 1), ("exp", k)}, undo


def corrupt_pi_value_lc(bv):
    """One pi row's rpi_value_lc + 1 in the built verifier's pi-kernel
    inputs, before a new ``prepare``: only ("pi", row) keys fail, that row's
    and the one whose value chain reads it, as the JAX verifier's keys on
    the same edit (tests/test_torch_block.py, pi_value_lc)."""
    k = next(k for n, k in bv.circuit_kernels if n == "pi")
    limbs = k.args[0]["rpi_value_lc"]["f"]
    r = k.n // 2
    old = limbs[r].copy()
    v = (sum(int(x) << (L.LIMB_BITS * i) for i, x in enumerate(old)) + 1) % fr.P
    limbs[r] = L.int_to_limbs(v, limbs.shape[1]).numpy()

    def undo():
        limbs[r] = old

    return ({"corrupt_pi_row": r}, lambda f: bool(f) and set(f) <= {("pi", r - 1), ("pi", r)},
            undo)


def corrupt_ecdsa_ok(bv, name):
    """One lane's host ECDSA verdict flipped in the built verifier's tx- or
    sig-kernel inputs, before a new ``prepare``: exactly (name, lane)
    fails."""
    k = next(k for n, k in bv.circuit_kernels if n == name)
    ok = k.args[2]["ecdsa_ok"]
    lane = k.n // 2
    ok[lane] ^= 1

    def undo():
        ok[lane] ^= 1

    return {f"corrupt_{name}_ecdsa_lane": lane}, lambda f: set(f) == {(name, lane)}, undo


def corrupt_sstore_value(w):
    """The written value of the middle SSTORE step's storage row + 1:
    exactly that step and the state row of the SLOAD that reads the slot
    back fail, as the JAX verifier's keys on the same edit of the 2-tx
    block (tests/test_torch_block_signed.py, sstore_value)."""
    sstores = [i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.SSTORE]
    bad = sstores[len(sstores) // 2]
    rows = w.rw.rws
    k = next(k for k, r in enumerate(rows) if r["key0"] == int(Target.AccountStorage)
             and r["rw"] == int(RW.Write) and r["rw_counter"] >= w.steps[bad].rw_counter)
    row = rows[k]
    read = next(r for r in rows[k + 1:] if r["key0"] == int(Target.AccountStorage)
                and r["rw"] == int(RW.Read) and r["address"] == row["address"]
                and r["storage_key"] == row["storage_key"])
    row["value"] += 1

    def expected(bv, f):
        read_row = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == read["rw_counter"]]
        return set(f) == {bad, ("state", read_row[0])}

    def undo():
        row["value"] -= 1

    return {"corrupt_sstore_step": bad}, expected, undo


def corrupt_copy_rlc(w):
    """One copy row's rlc_acc + 1, the sixth row of the middle SHA3 copy
    event: exactly it and its predecessor fail (the accumulator is no
    longer constant across them), as the JAX verifier's keys on the same
    edit (tests/test_torch_block_signed.py, sha3_copy_rlc)."""
    rows = w.copy_circuit.rows
    firsts = [i for i, r in enumerate(rows) if r["is_first"]]
    k = firsts[len(firsts) // 2] + 5
    old = rows[k]["rlc_acc"]
    rows[k]["rlc_acc"] = (old + 1) % fr.P

    def undo():
        rows[k]["rlc_acc"] = old

    return {"corrupt_copy_row": k}, lambda bv, f: set(f) == {("copy", k - 1), ("copy", k)}, undo


def _step_rw_row(w, step, offset, key0, rw):
    rwc = w.steps[step].rw_counter + offset
    row = next(r for r in w.rw.rws if r["rw_counter"] == rwc)
    assert row["key0"] == int(key0) and row["rw"] == int(rw), row
    return row


def corrupt_log_topic(w):
    """The LOG1 topic of tx 3 (of the last tx, when the block has fewer) + 1:
    exactly that tx's LOG step fails, as the JAX verifier's keys on the same
    edit of the 2 x 8 block (tests/test_torch_block_flow.py, flow_log_topic)."""
    tx_id = min(3, len(w.txs))
    bad = [i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.LOG][tx_id - 1]
    row = next(r for r in w.rw.rws if r["key0"] == int(Target.TxLog) and r["id"] == tx_id
               and (r["address"] >> 32) & 0xFFFF == int(TxLogFieldTag.Topic))
    old = row["value"]
    row["value"] = (old + 1) % (1 << 256)

    def undo():
        row["value"] = old

    return {"corrupt_log_step": bad, "tx": tx_id}, lambda bv, f: set(f) == {bad}, undo


def corrupt_calldataload_word(w):
    """The word pushed by the middle CALLDATALOAD step (its fourth rw row) +
    1: exactly that step and the state row of the SWAP1 that reads the word
    fail, as the JAX verifier's keys on the same edit of the 2 x 8 block
    (tests/test_torch_block_flow.py, flow_calldataload_word)."""
    loads = [i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.CALLDATALOAD]
    bad = loads[len(loads) // 2]
    row = _step_rw_row(w, bad, 3, Target.Stack, RW.Write)
    old = row["value"]
    row["value"] = (old + 1) % (1 << 256)

    def expected(bv, f):
        rwc = row["rw_counter"] + 1
        read = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == rwc]
        return set(f) == {bad, ("state", read[0])}

    def undo():
        row["value"] = old

    return {"corrupt_calldataload_step": bad}, expected, undo


def _step_holding(w, rw_counter, state):
    """The step of ``state`` whose rw rows hold ``rw_counter``."""
    return max(i for i, s in enumerate(w.steps)
               if s.execution_state == state and s.rw_counter <= rw_counter)


def corrupt_restored_gas_left(w):
    """The first restored caller GasLeft row + 1 (the first call-context
    write of a GasLeft: the first CALL saves it, its callee's halt reads it
    back): exactly that CALL step and the state row of the read fail, as
    the JAX verifier's keys on the same edit of the 4 x 3 block
    (tests/test_torch_block_call_block.py, restored_gas_left)."""
    rows = w.rw.rws
    k = next(k for k, r in enumerate(rows) if r["key0"] == int(Target.CallContext)
             and r["rw"] == int(RW.Write) and r["address"] == int(CallContextFieldTag.GasLeft))
    row = rows[k]
    read = next(r for r in rows[k + 1:] if r["key0"] == int(Target.CallContext)
                and r["rw"] == int(RW.Read) and r["id"] == row["id"]
                and r["address"] == int(CallContextFieldTag.GasLeft))
    bad = _step_holding(w, row["rw_counter"], ExecutionState.CALL_OP)
    row["value"] += 1

    def expected(bv, f):
        read_row = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == read["rw_counter"]]
        return set(f) == {bad, ("state", read_row[0])}

    def undo():
        row["value"] -= 1

    return {"corrupt_call_step": bad}, expected, undo


def corrupt_dead_sstore_mirror(w):
    """The value of the first tx's mirror of 0xDEAD's SSTORE (its write back
    to 0) + 1: exactly the SSTORE step that looks the mirror up fails, as the
    JAX verifier's keys on the same edit of the 4 x 3 block
    (tests/test_torch_block_call_block.py, dead_sstore_mirror)."""
    rows = w.rw.rws
    mirror = next(r for r in rows if r["key0"] == int(Target.AccountStorage)
                  and r["rw"] == int(RW.Write) and r["address"] == workloads.CALL_REVERTING
                  and r["value_prev"] == 1)
    write = next(r for r in rows if r["key0"] == mirror["key0"] and r["rw"] == int(RW.Write)
                 and r["id"] == mirror["id"] and r["address"] == mirror["address"]
                 and r["storage_key"] == mirror["storage_key"] and r["value"] == 1)
    bad = _step_holding(w, write["rw_counter"], ExecutionState.SSTORE)
    mirror["value"] += 1

    def undo():
        mirror["value"] -= 1

    return ({"corrupt_sstore_step": bad, "mirror_rw_counter": mirror["rw_counter"]},
            lambda bv, f: set(f) == {bad}, undo)


def corrupt_create2_address(w):
    """The first CREATE2's pushed address + 1 (tests/test_block_create.py:
    test_block_create_corrupt_address_push_rejected's edit): exactly that
    CREATE2 step and the state row of the first read of its stack slot (the
    round's DUP6; the POP's later read is held to that read and passes)
    fail, as the JAX verifier's keys on the same edit of the 2 x 1 block
    (tests/test_torch_create_blocks.py, create2_address)."""
    bad = next(i for i, s in enumerate(w.steps) if s.execution_state == ExecutionState.CREATE2)
    rows = w.rw.rws
    k = next(k for k, r in enumerate(rows) if r["rw_counter"] >= w.steps[bad].rw_counter
             and r["key0"] == int(Target.Stack) and r["rw"] == int(RW.Write))
    row = rows[k]
    read = next(r for r in rows[k + 1:] if r["key0"] == int(Target.Stack)
                and (r["id"], r["address"]) == (row["id"], row["address"]))
    assert read["rw"] == int(RW.Read)
    row["value"] += 1

    def expected(bv, f):
        read_row = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == read["rw_counter"]]
        return set(f) == {bad, ("state", read_row[0])}

    def undo():
        row["value"] -= 1

    return {"corrupt_create2_step": bad}, expected, undo


def corrupt_error_restored_gas_left(w):
    """The caller's GasLeft that the first error halt in a sub-call reads
    back + 1: exactly that halt's step (its restored gas) and the state row
    of the read fail, as the JAX verifier's keys on the same edit of the
    2 x 1 block (tests/test_torch_create_blocks.py, error_restored_gas_left)."""
    bad = next(i for i, s in enumerate(w.steps)
               if s.execution_state.name.startswith("Error") and not s.is_root)
    lo, hi = w.steps[bad].rw_counter, w.steps[bad + 1].rw_counter
    row = next(r for r in w.rw.rws if lo <= r["rw_counter"] < hi
               and r["key0"] == int(Target.CallContext) and r["rw"] == int(RW.Read)
               and r["address"] == int(CallContextFieldTag.GasLeft))
    row["value"] += 1

    def expected(bv, f):
        read_row = [k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == row["rw_counter"]]
        return set(f) == {bad, ("state", read_row[0])}

    def undo():
        row["value"] -= 1

    return ({"corrupt_error_step": bad, "state": w.steps[bad].execution_state.name},
            expected, undo)


def _precompile_edit(w, name):
    """``workloads.PRECOMPILE_EDITS[name]`` on the witness: exactly the keys
    it predicts from the witness (the CPU tests hold them against the JAX
    verifier on the small block) fail."""
    keys, undo = workloads.PRECOMPILE_EDITS[name](w)
    return {"edit": name}, (lambda bv, f: set(f) == keys(bv)), undo


def corrupt_ecc_add_out(w):
    """The first ecAdd op's out y + 1: ("ecc", 0) and that BN254_ADD step."""
    return _precompile_edit(w, "ecc_add_out")


def corrupt_sig_row_is_valid(w):
    """The first sig row's is_valid flipped: ("sig_trace", 0) and the first
    ECRECOVER step."""
    return _precompile_edit(w, "sig_row_is_valid")


def corrupt_identity_output(w):
    """The first identity output byte + 1 in the rw rows: its copy row and
    the state row of the byte's next read."""
    return _precompile_edit(w, "identity_output")


def corrupt_wrong_key(w):
    """Tx 0 re-signed with key 0xBAD over the same payload: its recovered
    signer is no longer the EVM-side sender, so the tx check's lane 0
    fails (tests/test_block_jit.py:test_block_jit_corrupt_signature_rejected)."""
    w.signed_txs[0] = tx_circuit.sign_tx(0xBAD, w.signed_txs[0], w.chain_id)


# the block phases: the witness builder and its sizes, the circuit checks
# whose share of the device time is reported, the corruptions, and the
# small block held against the CPU with the corruptions it gets there
# (None: the clean block)
BLOCK_PHASES = {
    "block": dict(build=lambda: workloads.build_alu_block(ALU_TXS, BLOCK_ALU_OPS),
                  sizes={"txs": ALU_TXS, "ops_per_tx": BLOCK_ALU_OPS},
                  shares=("keccak", "tx", "sig", "pi"),
                  corruptions=(corrupt_gas_left,),
                  small=lambda: workloads.build_alu_block(*SMALL_BLOCK,
                                                          call_data=SMALL_BLOCK_CALL_DATA),
                  small_size=SMALL_BLOCK,
                  small_corruptions=(None, corrupt_gas_left, corrupt_wrong_key)),
    "arith": dict(build=lambda: workloads.build_arith_block(ARITH_TXS, ARITH_CYCLES),
                  sizes={"txs": ARITH_TXS, "cycles_per_tx": ARITH_CYCLES},
                  shares=("exp", "keccak", "tx", "sig", "pi"),
                  corruptions=(corrupt_mulmod_push, corrupt_exp_row_d),
                  small=lambda: workloads.build_arith_block(*SMALL_ARITH), small_size=SMALL_ARITH,
                  small_corruptions=(None, corrupt_mulmod_push)),
    "sstore": dict(build=lambda: workloads.build_sstore_block(SSTORE_TXS),
                   sizes={"txs": SSTORE_TXS},
                   shares=("copy", "keccak", "tx", "sig", "pi"),
                   corruptions=(corrupt_sstore_value, corrupt_copy_rlc),
                   small=lambda: workloads.build_sstore_block(SMALL_SSTORE),
                   small_size=(SMALL_SSTORE,),
                   small_corruptions=(None, corrupt_sstore_value)),
    "flow": dict(build=lambda: workloads.build_flow_block(FLOW_TXS, FLOW_ITERATIONS),
                 sizes={"txs": FLOW_TXS, "iterations_per_tx": FLOW_ITERATIONS},
                 shares=("copy", "keccak", "tx", "sig", "pi"),
                 corruptions=(corrupt_log_topic, corrupt_calldataload_word),
                 small=lambda: workloads.build_flow_block(*SMALL_FLOW), small_size=SMALL_FLOW,
                 small_corruptions=(None, corrupt_log_topic, corrupt_calldataload_word),
                 # held clean against the CPU too: every root-frame state in one frame
                 also_small={"conformance": (workloads.build_conformance_block, (None,))}),
    "calls": dict(build=lambda: workloads.build_call_block(CALL_TXS, CALL_ROUNDS),
                  sizes={"txs": CALL_TXS, "rounds_per_tx": CALL_ROUNDS},
                  shares=("copy", "keccak", "tx", "sig", "pi"),
                  corruptions=(corrupt_restored_gas_left, corrupt_dead_sstore_mirror),
                  small=lambda: workloads.build_call_block(*SMALL_CALLS), small_size=SMALL_CALLS,
                  small_corruptions=(None, corrupt_restored_gas_left,
                                     corrupt_dead_sstore_mirror),
                  # tests/test_block_conformance.py's mega block: the wide
                  # program and the four call opcodes into a returning callee
                  also_small={"conformance_mega": (workloads.build_conformance_mega_block,
                                                   (None, corrupt_restored_gas_left))}),
    "create": dict(build=lambda: workloads.build_create_block(CREATE_TXS, CREATE_ROUNDS),
                   sizes={"txs": CREATE_TXS, "rounds_per_tx": CREATE_ROUNDS},
                   shares=("copy", "keccak", "tx", "sig", "pi"),
                   corruptions=(corrupt_create2_address, corrupt_error_restored_gas_left),
                   small=lambda: workloads.build_create_block(*SMALL_CREATE),
                   small_size=SMALL_CREATE,
                   small_corruptions=(None, corrupt_create2_address,
                                      corrupt_error_restored_gas_left),
                   # tests/test_block_create.py's create-then-call-then-create2
                   # chain block (its error edit lands on no halt: clean and
                   # with the CREATE2 edit)
                   also_small={"create_chain": (workloads.build_create_chain_block,
                                                (None, corrupt_create2_address))}),
    "precompile": dict(build=lambda: workloads.build_precompile_block(*PRECOMPILE_SIZE),
                       sizes=dict(zip(("verifier_txs", "relayer_txs", "messages_per_relayer"),
                                      PRECOMPILE_SIZE)),
                       shares=("copy", "keccak", "tx", "sig", "ecc", "sig_trace", "pi"),
                       # at full size the edit of the largest tables (a
                       # rebuild of this block is about half a minute of host
                       # work); every edit on the small block, each at its
                       # predicted keys on the card and the CPU
                       corruptions=(corrupt_identity_output,),
                       small=lambda: workloads.build_precompile_block(*SMALL_PRECOMPILE),
                       small_size=SMALL_PRECOMPILE,
                       small_corruptions=(None, corrupt_ecc_add_out, corrupt_sig_row_is_valid,
                                          corrupt_identity_output),
                       small_keys_predicted=True,
                       # the lookup families its logUp line must prove
                       logup_families=("sig", "ecc")),
}


# the small blocks' CPU side runs in one worker process, started with the
# run, while the card works in this one; its torch threads
CPU_SIDE_THREADS = 2
CPU_SIDE = {}   # (path, block, corruption's name) -> the future of cpu_side's result


def cpu_side_keys():
    """Every small block a block phase holds against the CPU, in the order
    the phases reach them: (path, "small" or an ``also_small`` name, the
    corruption's name or None)."""
    keys = []
    for path, spec in BLOCK_PHASES.items():
        keys += [(path, "small", c and c.__name__) for c in spec["small_corruptions"]]
        for name, (_, corruptions) in spec.get("also_small", {}).items():
            keys += [(path, name, c and c.__name__) for c in corruptions]
    return keys


def cpu_side(path, which, corruption):
    """One small block built, corrupted and verified on the CPU alone (the
    plain versions; no card work): its failure dict, and for a phase's clean
    small block the logUp verdicts and limbs of every family."""
    torch.set_num_threads(CPU_SIDE_THREADS)
    spec = BLOCK_PHASES[path]
    w = (spec["small"] if which == "small" else spec["also_small"][which][0])()
    if corruption is not None:
        globals()[corruption](w)
    bv = block_runtime.CompiledBlockVerifier(w, device="cpu")
    prepared = bv.prepare()
    limbs = logup_limbs(bv, prepared) if which == "small" and corruption is None else None
    return bv.run_device(prepared), limbs


def cpu_result(path, which, corrupt):
    """The worker's ``cpu_side`` result for a small block (waits for it)."""
    return CPU_SIDE[(path, which, corrupt and corrupt.__name__)].result()


def run_block(path, card):
    """One block through the port's ``CompiledBlockVerifier`` (see phases 8
    to 10c of the module docstring)."""
    spec = BLOCK_PHASES[path]
    CBV = block_runtime.CompiledBlockVerifier
    out = {"phase": path, **spec["sizes"], "sign": True, "not_ported": list(CBV.not_ported),
           "host_crypto": host_crypto(), "card": card}
    assert not CBV.not_ported, CBV.not_ported
    t_phase = t0 = time.perf_counter()
    witness = spec["build"]()
    t_trace = time.perf_counter() - t0
    # the host seconds of the signing (part of the trace) and of the tx and
    # sig witnesses the verifier builds, each timed again on its own
    signed = list(witness.signed_txs)
    t0 = time.perf_counter()
    tracer.sign_block_txs(witness)
    t_sign = time.perf_counter() - t0
    assert [tuple(t) for t in witness.signed_txs] == [tuple(t) for t in signed]
    max_txs, max_cd, chain_id = block_runtime.DEFAULT_CONFIG.tx_circuit_params()
    r = block_runtime.DEFAULT_CONFIG.keccak_randomness
    t0 = time.perf_counter()
    tx_circuit.txs2witness(signed, chain_id, max(max_txs, len(signed)),
                           max(max_cd, sum(len(t.data) for t in signed)), r)
    t_tx_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    super_circuit.sig_witness_from_txs(signed, chain_id, r)
    t_sig_witness = time.perf_counter() - t0
    gas = workloads.receipt_gas_used(witness)
    n_steps = len(witness.steps)
    t0 = time.perf_counter()
    bv = CBV(witness)                                          # device "cuda"
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    bv.prepare()
    t_prepare_cold = time.perf_counter() - t0

    # the main path: counts set to 0 just before a warm prepare (K9) and the
    # first combined call (the capture of the device pass with K10 last,
    # then a replay), read just after
    reset_counts()
    t0 = time.perf_counter()
    prepared = bv.prepare()
    t_prepare = time.perf_counter() - t0
    t0 = time.perf_counter()
    failures = bv.run_device_combined(prepared)
    t_capture = time.perf_counter() - t0
    counts = read_counts()
    assert not failures, f"{path}: the clean block failed at {sorted(failures, key=str)[:8]}"
    for name in PATH_KERNELS[path]:
        assert counts[name] > 0, f"{path}: kernel {name} was not launched on the main path"
    assert counts["leaf_unpack"] == 1, counts

    # the per-kernel pass, its launches counted on their own (and K3's on
    # each path, counted by its launcher)
    reset_counts()
    paths_before = {name: cuda_build.path_launches(name) for name in cuda_build.PATHS}
    assert not bv.run_device(prepared), f"{path}: the per-kernel pass failed the clean block"
    torch.cuda.synchronize()
    pass_counts = read_counts()
    # K3's launches by path, staged or direct, and K7's, row or warp; K4 has one
    pass_paths = {name: {k: v - paths_before[name][k] for k, v in
                         cuda_build.path_launches(name).items()} for name in cuda_build.PATHS}
    pass_paths["lookup_gather_eq"] = {"tiled": pass_counts["lookup_gather_eq"]}
    for name in cuda_build.PATHS:
        assert sum(pass_paths[name].values()) == pass_counts[name], \
            (name, pass_paths[name], pass_counts[name])
    # the graph holds the per-kernel pass's launches, kernel for kernel, and K10
    graph_counts = prepared["graph"]["launches"]
    for name in KERNELS:
        want = 1 if name == "verdict_pack" else 0 if name == "leaf_unpack" else pass_counts[name]
        assert graph_counts.get(name, 0) == want, \
            f"{path}: the graph recorded {graph_counts.get(name, 0)} {name} launches, " \
            f"the per-kernel pass {want}"
        assert name not in PATH_KERNELS[path] or name == "leaf_unpack" or want > 0, \
            f"{path}: kernel {name} is not in the captured graph"
    per_kernel_ms, per_kernel_min, failures = host_ms(lambda: bv.run_device(prepared),
                                                      BLOCK_PASS_REPEATS)
    assert not failures
    reset_counts()
    graph_ms, graph_min, failures = host_ms(lambda: bv.run_device_combined(prepared),
                                            REPLAY_REPEATS)
    assert not failures
    assert sum(read_counts().values()) == 0, f"{path}: a graph replay went through a wrapper"
    # the parts of a replay: the graph on the card alone (CUDA events), the
    # host-scheduled groups (run on the host while the graph runs), and the
    # named circuit checks alone
    graph_device_ms = time_on_card_ms(prepared["graph"]["graph"].replay, repeats=5, warmup=1)
    host_groups_ms, _, _ = host_ms(bv.host_group_fails, 3)
    groups_card = sum(g["verifier"] is not None for g in bv.groups)
    device_s = graph_ms / 1e3
    out.update({
        "steps": n_steps, "rw_rows": len(witness.rw.rws), "gas_used": gas,
        "groups_on_card": groups_card, "groups_on_host": len(bv.groups) - groups_card,
        "trace_s": t_trace, "sign_s": t_sign, "tx_witness_s": t_tx_witness,
        "sig_witness_s": t_sig_witness, "build_s": t_build, "prepare_cold_s": t_prepare_cold,
        "prepare_s": t_prepare, "upload": bv.upload_stats,
        "per_kernel_pass_ms_median": per_kernel_ms, "per_kernel_pass_ms_min": per_kernel_min,
        "per_kernel_pass_launches": pass_counts,
        "per_kernel_pass_launches_total": sum(pass_counts.values()),
        "per_kernel_pass_instance_launches": pass_paths,
        "graph_replay_ms_median": graph_ms, "graph_replay_ms_min": graph_min,
        "capture_s": t_capture, "graph_device_ms": graph_device_ms,
        "host_groups_ms": host_groups_ms, "graph_host_launches": 1,
        "graph_captured_launches": prepared["graph"]["launches"],
        "main_path_launches": counts,
    })
    for name in spec["shares"]:
        k, args = next((k, a) for n, k, a in prepared["circuits"] if n == name)
        check_ms, _, _ = host_ms(lambda: k(args), 3)
        check_device_ms = captured_device_ms(lambda: k(args))
        out.update({f"{name}_check_ms": check_ms, f"{name}_rows": k.n,
                    f"{name}_check_graph_device_ms": check_device_ms,
                    f"{name}_share_of_graph_replay": check_ms / graph_ms,
                    f"{name}_share_of_graph_device": check_device_ms / graph_device_ms,
                    f"{name}_share_of_per_kernel_pass": check_ms / per_kernel_ms})
    out.update({
        # bench.py:_bench_block_mix's terms (:550-580): repeat-verify over a warm
        # prepare and the combined pass; fresh-block over trace, build, a cold
        # prepare and the first combined call (its capture included)
        "gas_per_s": gas / (t_prepare + device_s), "steps_per_s": n_steps / (t_prepare + device_s),
        "device_gas_per_s": gas / device_s,
        "fresh_block_s": t_trace + t_build + t_prepare_cold + t_capture,
        "fresh_block_gas_per_s": gas / (t_trace + t_build + t_prepare_cold + t_capture),
        "fresh_block_steps_per_s": n_steps / (t_trace + t_build + t_prepare_cold + t_capture),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })

    # every kernel's arguments at the block's shapes, outside the counted
    # runs: K9's from a prepare, the others' (and K10's fail vectors) from
    # one per-kernel pass, the first call of each distinct shape
    with Capture(block_runtime, "upload") as up:
        bv.prepare()
    leaves, _ = up.calls[None]
    fails, calls = capture_pass(lambda: bv._device_pass(prepared))
    captured = {"plan": transfer.UploadPlan(leaves), "fails": fails, "calls": calls,
                "instances": pass_paths}
    out["distinct_kernel_shapes"] = {name: len(c) for name, c in calls.items()}
    for name in COUNTED_CALLS:
        assert sum(kw[COUNT] for _, kw in calls[name]) == pass_counts[name], \
            f"{path}: the captured {name} calls differ from the per-kernel pass's launches"
    missing = set(spec.get("logup_families", ())) - set(logup_families(bv))
    assert not missing, f"{path}: the block looks up no {sorted(missing)}"
    logup_counts, logup_captured = run_logup(path, bv, prepared, card)

    # the pi kernel's inputs corrupted in the built verifier, uploaded anew:
    # pi's keys fail, nothing else
    info, expected, undo = corrupt_pi_value_lc(bv)
    failures = bv.run_device_combined(bv.prepare())
    assert expected(failures), f"{path}: {info}, failures {sorted(failures, key=str)[:8]}"
    out["corruptions"] = [{**info, "failing_keys": sorted(failures, key=str)}]
    undo()
    # one lane's ECDSA verdict flipped in the tx and then the sig inputs
    for name in ("tx", "sig"):
        info, expected, undo = corrupt_ecdsa_ok(bv, name)
        failures = bv.run_device_combined(bv.prepare())
        assert expected(failures), f"{path}: {info}, failures {sorted(failures, key=str)[:8]}"
        out["corruptions"].append({**info, "failing_keys": sorted(failures, key=str)})
        undo()
    del bv, prepared, up, leaves, fails
    torch.cuda.empty_cache()

    # each corruption on its own rebuild: it fails where it must, nothing else
    for corrupt in spec["corruptions"]:
        info, expected, undo = corrupt(witness)
        bv = CBV(witness)
        failures = bv.run_device_combined(bv.prepare())
        assert expected(bv, failures), \
            f"{path}: {info}, failures {sorted(failures, key=str)[:8]}"
        out["corruptions"].append({**info, "failing_keys": sorted(failures, key=str)})
        undo()
        del bv
        torch.cuda.empty_cache()
    del witness

    # the card's failure dicts against the CPU's on a small block, clean and
    # with each of its corruptions
    out["small_block_variants"] = {}
    for corrupt in spec["small_corruptions"]:
        small = spec["small"]()
        edited = corrupt(small) if corrupt is not None else None
        on_card = CBV(small)
        p = on_card.prepare()
        f_card, f_graph = on_card.run_device(p), on_card.run_device_combined(p)
        f_cpu, lu_cpu = cpu_result(path, "small", corrupt)
        assert f_card == f_graph == f_cpu, f"{path}: card {f_card}, graph {f_graph}, CPU {f_cpu}"
        assert bool(f_cpu) == (corrupt is not None)
        if spec.get("small_keys_predicted") and corrupt is not None:
            assert edited[1](on_card, f_card), f"{path}: {edited[0]}, failures {f_card}"
        if corrupt is corrupt_wrong_key:
            assert set(f_cpu) == {("tx", 0)}, f_cpu
        out["small_block_variants"][corrupt.__name__ if corrupt else "clean"] = \
            sorted(f_cpu, key=str)
        if corrupt is None:
            # the logUp argument of the clean small block: the same verdicts
            # and the same lhs and rhs limbs on the card and on the CPU
            lu_card = logup_limbs(on_card, p)
            assert lu_card == lu_cpu, f"{path}: logUp on the card {lu_card}, on the CPU {lu_cpu}"
            assert all(ok for ok, _, _ in lu_cpu.values()), lu_cpu
            out["small_block_logup_matches_cpu"] = sorted(lu_cpu)
    for name, (build, corruptions) in spec.get("also_small", {}).items():
        for corrupt in corruptions:
            other = build()
            if corrupt is not None:
                corrupt(other)
            on_card = CBV(other)
            p = on_card.prepare()
            f_card, f_graph = on_card.run_device(p), on_card.run_device_combined(p)
            f_cpu, _ = cpu_result(path, name, corrupt)
            assert f_card == f_graph == f_cpu, \
                f"{path}: {name} block: card {f_card}, graph {f_graph}, CPU {f_cpu}"
            assert bool(f_cpu) == (corrupt is not None), f"{path}: {name} block: {f_cpu}"
            out["small_block_variants"][name + ("" if corrupt is None else
                                                f" {corrupt.__name__}")] = {
                "steps": len(other.steps),
                "states": len({s.execution_state for s in other.steps}),
                "failing_keys": sorted(f_cpu, key=str)}
    out["small_block_matches_cpu"] = list(spec["small_size"])
    out["small_block_calldata_bytes"] = sum(len(tx.call_data) for tx in small.txs)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return counts, captured, logup_counts, logup_captured


def run_tx_sig(card):
    """The tx and sig checks on the most signed transfers a 30 M-gas block
    holds (see phase 11 of the module docstring)."""
    n, chain, r = TX_SIG_TXS, workloads.TX_SIG_CHAIN_ID, 0x64
    max_cd = workloads.TX_SIG_MAX_CALLDATA
    out = {"phase": "tx_sig", "txs": n, "chain_id": chain, "max_calldata_bytes": max_cd,
           "host_crypto": host_crypto(), "card": card}
    t_phase = t0 = time.perf_counter()
    txs = workloads.signed_transfers(n)
    t_sign = time.perf_counter() - t0
    t0 = time.perf_counter()
    tw = tx_circuit.txs2witness(txs, chain, n, max_cd, r)
    t_tx_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw = super_circuit.sig_witness_from_txs(txs, chain, r)
    t_sig_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    verdicts = secp256k1.verify_batch([(c.msg_hash_int, *c.signature, c.pub_key)
                                       for c in tw.sign_verifications])
    t_verify = time.perf_counter() - t0
    assert all(verdicts)
    # the kernels' construction runs verify_batch once for each check
    t0 = time.perf_counter()
    tk = tx_circuit.tx_kernel(tw, n, r)                       # device "cuda"
    sk = sig_circuit.sig_kernel(sw, r)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ta, sa = tk.device_args(), sk.device_args()
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0

    # the main path: counts set to 0 just before one check of each, read
    # just after; every lane passes
    reset_counts()
    t0 = time.perf_counter()
    f_tx, f_sig = tk(ta), sk(sa)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = read_counts()
    assert not f_tx.any() and not f_sig.any(), "tx_sig: a clean signed transfer failed"
    for name in PATH_KERNELS["tx_sig"]:
        assert counts[name] > 0, f"tx_sig: kernel {name} was not launched on the main path"
    assert counts["lookup_fingerprint"] == 0, "tx_sig: an index was built on the card"
    check_ms = time_on_card_ms(lambda: (tk(ta), sk(sa)), repeats=REPLAY_REPEATS)
    tx_ms = time_on_card_ms(lambda: tk(ta), repeats=REPLAY_REPEATS)
    sig_ms = time_on_card_ms(lambda: sk(sa), repeats=REPLAY_REPEATS)
    # bench.py:bench_sig's terms: the witnesses, then the checks' build and
    # run (here with the upload)
    total_s = t_tx_witness + t_sig_witness + t_build + t_upload + check_ms / 1e3
    out.update({
        "sign_s": t_sign, "tx_witness_s": t_tx_witness, "sig_witness_s": t_sig_witness,
        "verify_batch_s": t_verify, "build_s": t_build, "upload_s": t_upload,
        "first_check_s": t_first, "check_ms_median": check_ms, "tx_check_ms_median": tx_ms,
        "sig_check_ms_median": sig_ms, "main_path_launches": counts,
        "signed_txs_verified_per_s": n / total_s,
        "device_signed_txs_per_s": n / (check_ms / 1e3),
    })

    # one corrupted lane: its ECDSA verdict flipped in the uploaded inputs
    lane = TX_SIG_CORRUPT_LANE
    out["corruptions"] = []
    for name, k, a in (("tx", tk, ta), ("sig", sk, sa)):
        a[2]["ecdsa_ok"][lane] ^= 1
        bad = torch.nonzero(k(a)).flatten().tolist()
        a[2]["ecdsa_ok"][lane] ^= 1
        assert bad == [lane], f"tx_sig: {name} lane {lane} edited, failures {bad[:8]}"
        out["corruptions"].append({f"corrupt_{name}_ecdsa_lane": lane, "failing_lanes": bad})
    _, calls = capture_pass(lambda: (tk(ta), sk(sa)))
    out["distinct_kernel_shapes"] = {name: len(c) for name, c in calls.items()}

    # the checks at SMALL_TX_SIG transfers on the card and on the CPU, clean
    # and with one lane's verdict flipped
    small = workloads.signed_transfers(SMALL_TX_SIG)
    stw = tx_circuit.txs2witness(small, chain, SMALL_TX_SIG, max_cd, r)
    ssw = super_circuit.sig_witness_from_txs(small, chain, r)
    for corrupt in (False, True):
        for name, make in (("tx", lambda d: tx_circuit.tx_kernel(stw, SMALL_TX_SIG, r, device=d)),
                           ("sig", lambda d: sig_circuit.sig_kernel(ssw, r, device=d))):
            got = []
            for dev in ("cuda", "cpu"):
                k = make(dev)
                a = k.device_args()
                if corrupt:
                    a[2]["ecdsa_ok"][1] ^= 1
                got.append(torch.nonzero(k(a)).flatten().tolist())
            assert got[0] == got[1] == ([1] if corrupt else []), f"tx_sig: {name} {got}"
    out["small_matches_cpu"] = SMALL_TX_SIG
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    del tk, sk, ta, sa
    torch.cuda.empty_cache()
    return counts, {"calls": calls, "instances": {}}


# -- the native host library, the sharded verifier, the profiling hooks -------

NATIVE_PREIMAGES = 64         # keccak preimages of 0..300 bytes
NATIVE_DOUBLE_MULS = 256      # secp256k1 u1 G + u2 Q
NATIVE_VERIFY_ROWS = TX_SIG_TXS   # verify_batch rows, tx_sig's 714
NATIVE_BAD_ROWS = (3, 100, 357, 700)   # rows made invalid among them
COMM_MODEL_WORLDS = (1, 2, 4, 8)


def host_crypto():
    """The path the port's host crypto takes: "native" or "python"."""
    return "native" if native.native_available() else "python"


def _fq2_pow(a, e):
    out = bn254.FQ2.one()
    while e:
        if e & 1:
            out = out * a
        a = a * a
        e >>= 1
    return out


def g2_off_subgroup():
    """A point on BN254's twist curve outside the order-r subgroup: the
    first x = k + u with x^3 + b2 a square in FQ2."""
    p = bn254.P
    for k in range(1, 100):
        x = bn254.FQ2([k, 1])
        a = x * x * x + bn254.B2
        a1 = _fq2_pow(a, (p - 3) // 4)
        alpha, x0 = a1 * a1 * a, a1 * a
        y = (bn254.FQ2([0, 1]) * x0 if alpha == bn254.FQ2([p - 1, 0])
             else _fq2_pow(alpha + bn254.FQ2.one(), (p - 1) // 2) * x0)
        if y * y == a:
            return (x, y)
    raise AssertionError("no point off the subgroup found")


def run_native(card):
    """The native host library: built from csrc/'s sources (its seconds),
    each wrapper held against the port's Python path on seeded inputs, and
    native and Python times of verify_batch at tx_sig's rows and of a
    4-pair pairing check.  Any mismatch or a failed build fails the run."""
    import random

    out = {"phase": "native", "card": card}
    t_phase = t0 = time.perf_counter()
    out["library"] = str(native.require_native().relative_to(native.BUILD_DIR.parents[1]))
    out["build_s"] = native.BUILD_SECONDS    # None where it was built before this run
    out["load_s"] = time.perf_counter() - t0
    rng = random.Random(19)

    def both(fn, *args):
        got = fn(*args)
        with native.disabled():
            want = fn(*args)
        assert got == want, f"native: {fn.__name__} differs from the Python path"
        return got

    datas = [bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 301)))
             for _ in range(NATIVE_PREIMAGES)]
    keccak_ops._keccak256.cache_clear()
    both(keccak_ops.keccak256_batch, datas)
    assert [native.keccak256_native(d) for d in datas] == [keccak_ops._keccak256_py(d)
                                                             for d in datas]
    t0 = time.perf_counter()
    keccak_ops.keccak256_batch(datas * 32)
    out["keccak_batch_2048_native_ms"] = (time.perf_counter() - t0) * 1e3
    with native.disabled():
        t0 = time.perf_counter()
        keccak_ops.keccak256_batch(datas * 32)
        out["keccak_batch_2048_python_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for d in datas:
            keccak_ops._keccak256_py(d)
        out["keccak_64_python_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for d in datas:
        native.keccak256_native(d)
    out["keccak_64_native_ms"] = (time.perf_counter() - t0) * 1e3

    for _ in range(NATIVE_DOUBLE_MULS):
        q = secp256k1.mul(secp256k1.G, rng.randrange(1, secp256k1.N))
        both(secp256k1._double_mul, rng.randrange(secp256k1.N), rng.randrange(secp256k1.N), q)
    txs = workloads.signed_transfers(NATIVE_VERIFY_ROWS)
    tw = tx_circuit.txs2witness(txs, workloads.TX_SIG_CHAIN_ID, NATIVE_VERIFY_ROWS,
                                workloads.TX_SIG_MAX_CALLDATA, 0x64)
    rows = [(c.msg_hash_int, *c.signature, c.pub_key) for c in tw.sign_verifications]
    for k, i in enumerate(NATIVE_BAD_ROWS):
        h, r, s_, pk = rows[i]
        rows[i] = [(h, r, (s_ + 1) % secp256k1.N, pk), (h, r, s_, (pk[0], pk[1] + 1)),
                   (h, 0, s_, pk), (h, r, s_, None)][k]
    t0 = time.perf_counter()
    verdicts = secp256k1.verify_batch(rows)
    out["verify_batch_native_s"] = time.perf_counter() - t0
    with native.disabled():
        t0 = time.perf_counter()
        assert secp256k1.verify_batch(rows) == verdicts, "native: verify_batch differs"
        out["verify_batch_python_s"] = time.perf_counter() - t0
    assert [i for i, v in enumerate(verdicts) if not v] == list(NATIVE_BAD_ROWS), verdicts
    out["verify_batch_rows"] = len(rows)

    # (a coordinate at or past p: the library reduces it, the Python path
    # keeps it, so they may differ there; the CPU tests hold those inputs
    # against the JAX package's library)
    g1 = bn254.G1
    pts = [None, g1, bn254.g1_mul(g1, 31337), (g1[0], bn254.P - g1[1])]
    for a in pts:
        for b in pts:
            both(bn254.g1_add, a, b)
    for pt in pts:
        for k in (0, 1, bn254.R - 1, bn254.R, rng.getrandbits(254), 2**256 - 1, 2**256 + 3):
            both(bn254.g1_mul, pt, k)
    ks = [rng.getrandbits(128) for _ in range(4)]
    msm_pts = [bn254.g1_mul(g1, i + 2) for i in range(4)]
    want = None
    for q, k in zip(msm_pts, ks):
        want = bn254.g1_add(want, bn254.g1_mul(q, k))
    assert native.bn254_g1_msm_native(msm_pts + [None], ks + [5]) == want, "native: g1_msm"
    member, outsider = bn254.g2_mul(bn254.G2, 12345), g2_off_subgroup()
    assert both(bn254.g2_in_subgroup, member) is True
    assert both(bn254.g2_in_subgroup, outsider) is False
    neg = (g1[0], bn254.P - g1[1])
    a = 9876543210
    a_p, a_q = bn254.g1_mul(g1, a), bn254.g2_mul(bn254.G2, a)
    true_pairs = [(a_p, bn254.G2), (neg, a_q), (g1, bn254.G2), (neg, bn254.G2)]
    false_pairs = [(a_p, bn254.G2), (neg, a_q), (g1, bn254.G2), (g1, bn254.G2)]
    t0 = time.perf_counter()
    assert bn254.pairing_check(true_pairs) is True
    out["pairing_4_native_s"] = time.perf_counter() - t0
    assert bn254.pairing_check(false_pairs) is False
    with native.disabled():
        t0 = time.perf_counter()
        assert bn254.pairing_check(true_pairs) is True, "native: pairing differs"
        out["pairing_4_python_s"] = time.perf_counter() - t0
        assert bn254.pairing_check(false_pairs) is False, "native: pairing differs"
    out["host_crypto"] = host_crypto()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_sharded(card, backend="nccl", device=None):
    """``ShardedBlockVerifier`` over NCCL at world size 1 on this card: the
    SSTORE block and the small precompile block, each with its verdicts
    equal to ``CompiledBlockVerifier.run_device``'s key for key and every
    logUp family true; on the SSTORE block four edits (an ADD step's
    gas_left, a state row's value, an rw table part in the lookup
    argument, a copy row's rlc_acc) each caught at the single-device
    verifier's keys; and the communication model's rows of the SSTORE block
    at 1, 2, 4 and 8 ranks."""
    import torch.distributed as dist

    from zkevm_specs_tpu_torch.parallel import comm_model
    from zkevm_specs_tpu_torch.parallel.block_shard import ShardedBlockVerifier
    from zkevm_specs_tpu_torch.parallel.shard import make_mesh

    out = {"phase": "sharded", "backend": backend, "world_size": 1, "card": card,
           "host_crypto": host_crypto()}
    t_phase = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    counts = collections.Counter()
    try:
        mesh = make_mesh(device=device)
        blocks = {"sstore": lambda: workloads.build_sstore_block(SSTORE_TXS),
                  "precompile_small": lambda: workloads.build_precompile_block(*SMALL_PRECOMPILE)}
        for name, build in blocks.items():
            w = build()
            sbv = ShardedBlockVerifier(w, mesh)
            reset_counts()
            t0 = time.perf_counter()
            failures, lookups = sbv.check()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            check_s = time.perf_counter() - t0
            counts.update(read_counts())
            single = sbv.inner.run_device(sbv.inner.prepare())
            assert failures == single == {}, f"sharded {name}: {sorted(failures, key=str)[:8]}"
            assert lookups and all(lookups.values()), f"sharded {name}: {lookups}"
            assert lookups == sbv.inner.verify_lookups(), f"sharded {name}: logUp differs"
            out[name] = {"steps": len(w.steps), "rw_rows": len(w.rw.rws), "check_s": check_s,
                         "families": sorted(lookups), "placement": sbv.producer_placement}
            if name != "sstore":
                continue
            sstore_bv = sbv.inner
            edits = {}
            # a state row's value + 1
            mid = len(sbv.inner._state_rows) // 2
            sbv.inner._state_rows[mid]["value"] += 1
            got = set(np.flatnonzero(sbv.verify_state()).tolist())
            cols, tree, meta = state.pack_state_inputs(sbv.inner._state_rows, sbv.inner._state_mpt)
            want = set(torch.nonzero(state.make_state_check_fn(meta, mesh.device)(
                *to_device((cols, tree), mesh.device))).flatten().tolist())
            sbv.inner._state_rows[mid]["value"] -= 1
            assert got == want and got, f"sharded: state row edit {got} != {want}"
            edits["state_row"] = {"row": mid, "failing_rows": sorted(got)}

            # an rw table part in the lookup argument
            def corrupt(family, parts):
                if family == "rw":
                    parts[-1][1][parts[-1][1].shape[0] // 2, 0] ^= 1
            got = sbv.verify_lookups(corrupt_table=corrupt)
            want = sbv.inner.verify_lookups(corrupt_table=corrupt)
            assert got == want and got["rw"] is False and sum(not v for v in got.values()) == 1, got
            edits["rw_table_part"] = got
            # a step and a producer row, each on its own rebuild
            for edit in (corrupt_gas_left, corrupt_copy_rlc):
                info, expected, undo = edit(w)
                try:
                    bad = ShardedBlockVerifier(w, mesh, logup_tables=())
                    reset_counts()
                    got, _ = bad.check()
                    counts.update(read_counts())
                    want = bad.inner.run_device(bad.inner.prepare())
                finally:
                    undo()
                assert got == want and expected(bad.inner, got), \
                    f"sharded {edit.__name__}: {sorted(got, key=str)[:8]} != {sorted(want, key=str)[:8]}"
                edits[edit.__name__] = {**info, "failing": sorted(map(str, got))}
            out["edits"] = edits
            out["comm_model"] = [comm_model.row(comm_model.model_from_witness(w, n), "sstore")
                                 for n in COMM_MODEL_WORLDS]
    finally:
        dist.destroy_process_group()
    for k in PATH_KERNELS["sharded"]:
        assert counts[k] > 0, f"sharded: kernel {k} was not launched"
    out["launches"] = dict(counts)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {k: counts[k] for k in KERNELS}, {"calls": {}, "instances": {}}, sstore_bv


def run_profile(card, bv):
    """``runtime.profiling``: ``STATS`` after one ``run_device`` of the
    SSTORE block (``bv``, the sharded phase's single-device verifier), and
    one ``device_trace`` of it under chiprun_out/."""
    from pathlib import Path

    out = {"phase": "profile", "card": card}
    t_phase = time.perf_counter()
    prepared = bv.prepare()
    bv.run_device(prepared)                   # the kernels loaded, the caches filled
    torch.cuda.synchronize()
    profiling.STATS.reset()
    reset_counts()
    assert not bv.run_device(prepared)
    counts = read_counts()
    out["stats"] = json.loads(profiling.STATS.report())
    out["device_seconds"] = profiling.STATS.device_times
    labels = {r["kernel"] for r in out["stats"]}
    assert "state" in labels and any(k.startswith("evm:") for k in labels), labels
    # what the hooks add to a run_device: its regions, each an empty one's
    # host time (a pair of CUDA events and the host clock)
    probe = profiling.KernelStats()
    t0 = time.perf_counter()
    for _ in range(1000):
        with probe.timed("probe", bv.device):
            pass
    out["timed_region_us"] = (time.perf_counter() - t0) * 1e3
    probe.report()
    out["regions_per_run"] = sum(r["calls"] for r in out["stats"])
    trace_dir = Path("chiprun_out") / "profile_trace"
    with profiling.device_trace(str(trace_dir)) as path:
        with profiling.annotate("sstore run_device"):
            bv.run_device(prepared)
        torch.cuda.synchronize()
    size = Path(path).stat().st_size
    assert size > 0, "profile: the trace is empty"
    out.update({"trace": str(path), "trace_bytes": size,
                "seconds": time.perf_counter() - t_phase})
    emit(out)
    return counts, {"calls": {}, "instances": {}}


def logup_families(bv):
    """The families of the block's lookup log that the JAX package's
    ShardedBlockVerifier proves, in its order."""
    return [n for n in logup_shard.LOGUP_TABLES if n in bv.lookup_log]


def logup_limbs(bv, prepared):
    """{family: (ok, lhs limbs, rhs limbs)} of a block verifier's logUp
    argument on its device."""
    sums = logup_shard.block_logup_sums(
        bv.tables, bv.lookup_log, logup_shard.LOGUP_TABLES, bv.device,
        parts_of=lambda name: bv.table_parts_on_device(prepared, name))
    return {name: (bool(L.eq(lhs, rhs).item()), lhs.cpu().flatten().tolist(),
                   rhs.cpu().flatten().tolist()) for name, (lhs, rhs) in sums.items()}


# the kernel wrappers the logUp check calls, as BLOCK_CAPTURES (the gather
# and the partial sum as logup_shard calls them)
LOGUP_CAPTURES = (
    ("fr_mul", fr, "fr_mul", lambda a: shapes(a)),
    ("limb_mul", L, "limb_mul", mul_key),
    ("limb_reduce", L, "limb_reduce", reduce_key),
    ("limb_addsub", L, "limb_addsub", addsub_key),
    ("lookup_gather_eq", logup_shard, "lookup_gather_eq", gather_key),
    ("fr_inv", fr, "inv", lambda a: shapes(a)),
    ("logup_sum", logup, "logup_partial_sum",
     lambda a: shapes([a[0], a[2] if len(a) > 2 else None])),
)


def logup_shape_calls(bv, prepared, families):
    """Every kernel's arguments at each distinct shape of every family's
    check, from runs outside the counted one: ``{family: {kernel: [(args,
    kwargs), ...]}}``, a shape under the family that first gave it, its
    kwargs with its calls over the checks of all families (``COUNT``)."""
    first = {}
    with contextlib.ExitStack() as stack:
        caps = [(name, stack.enter_context(Capture(module, attr, key)))
                for name, module, attr, key in LOGUP_CAPTURES]
        for family in families:
            bv.verify_lookups(prepared, tables_names=(family,))
            for name, c in caps:
                for k in c.calls:
                    first.setdefault((name, k), family)
    calls = {}
    for name, c in caps:
        for k, a in c.calls.items():
            calls.setdefault(first[name, k], {}).setdefault(name, []).append(
                (a, {**c.kwargs[k], COUNT: c.counts[k]}))
    return calls


def run_logup(path, bv, prepared, card):
    """The block's logUp lookup argument from the verifier's partition-pass
    log, with the table sides taken from the columns ``prepare`` uploaded
    (no block is built again): the main path (every family at once) with
    the counts set to 0 just before and read just after; per family the
    rows T, queries Q, the host seconds (log concatenation and the
    multiplicity count), the card time of the check (median of 10, CUDA
    events around the whole call, its host-issued launch gaps and one bool
    read back included) and its verdict; on the rw family an over-counted
    multiplicity and a corrupted value (``corrupt_table``) that must fail,
    and an alpha equal to one table fingerprint, whose partial sum must be
    0 on the card and in the plain version.  Returns the counts and, per
    family, every kernel's arguments at each distinct shape of its check."""
    out = {"phase": "logup", "block": path, "alpha": logup_shard.ALPHA, "card": card}
    families = logup_families(bv)
    reset_counts()
    t0 = time.perf_counter()
    verdict = bv.verify_lookups(prepared)
    torch.cuda.synchronize()
    out["all_families_s"] = time.perf_counter() - t0
    counts = read_counts()
    assert verdict == {n: True for n in families}, f"{path}: logUp on the clean block {verdict}"
    for name in PATH_KERNELS["logup"]:
        assert counts[name] > 0, f"logup_{path}: kernel {name} was not launched on the main path"
    out["launches"] = counts

    out["families"] = {}
    for name in families:
        table = getattr(bv.tables, name)
        parts = bv.table_parts_on_device(prepared, name)
        t0 = time.perf_counter()
        inp = logup_shard.family_inputs(table, bv.lookup_log[name], "cuda", parts)
        torch.cuda.synchronize()
        inputs_s = time.perf_counter() - t0
        args = (inp["query_fps"], inp["query_en"], inp["parts"], inp["multiplicities"], logup_shard.ALPHA)
        before = dict(L.LAUNCHES)
        ok = logup_shard.sharded_logup_check(*args)
        torch.cuda.synchronize()
        check_launches = {k: L.LAUNCHES[k] - before.get(k, 0) for k in KERNELS
                          if L.LAUNCHES[k] != before.get(k, 0)}
        assert ok, f"{path}: logUp of {name} failed on the clean block"
        assert check_launches.get("limb_reduce") == 1 and "limb_mul" not in check_launches, \
            f"{path}: the {name} check launched {check_launches}"
        check_ms = time_on_card_ms(lambda: logup_shard.sharded_logup_check(*args), repeats=10,
                                   warmup=1)
        out["families"][name] = {
            "rows": inp["n_rows"], "queries": inp["n_queries"],
            "enabled_queries": int(inp["query_en"].sum()), "host_s": inp["host_s"],
            "inputs_s": inputs_s, "parts_from_prepare": parts is not None,
            "check_ms_median": check_ms, "check_launches": check_launches,
            "check_launches_total": sum(check_launches.values()), "ok": ok}
        if name == "rw":
            rw = inp

    # the rw family's negatives, on a row that the block queries
    busy = np.flatnonzero(rw["counts"])
    row = int(busy[len(busy) // 2])
    over = rw["counts"].copy()
    over[row] += 1
    bad_mult = logup_shard.sharded_logup_check(
        rw["query_fps"], rw["query_en"], rw["parts"], logup_shard.multiplicities(over, "cuda"),
        logup_shard.ALPHA)
    assert bad_mult is False, f"{path}: an over-counted multiplicity passed"
    value_lo = logup_shard.part_names(bv.tables.rw.schema).index(("value", "lo"))

    def corrupt(name, parts):
        parts[value_lo][1][row, 0] ^= 1

    bad_value = bv.verify_lookups(prepared, tables_names=("rw",), corrupt_table=corrupt)
    assert bad_value == {"rw": False}, f"{path}: a corrupted rw value gave {bad_value}"
    t_fps = logup_shard.fingerprint_parts(rw["parts"])
    at = t_fps[row].clone()
    zero_card = logup.logup_partial_sum(t_fps, at, rw["multiplicities"])
    zero_plain = logup.logup_partial_sum_plain(t_fps, at, rw["multiplicities"])
    assert not bool(zero_card.any()) and not bool(zero_plain.any()), \
        f"{path}: alpha equal to a table fingerprint left a nonzero partial sum"
    out.update({"overcounted_row": row, "overcounted_ok": bad_mult, "corrupt_value_row": row,
                "corrupt_value_ok": bad_value["rw"], "alpha_at_fingerprint_sum_is_zero": True})
    del rw, t_fps, at, zero_card, zero_plain

    calls = logup_shape_calls(bv, prepared, families)
    out["distinct_kernel_shapes"] = {
        family: {name: len(c) for name, c in by_name.items()} for family, by_name in calls.items()}
    torch.cuda.empty_cache()
    emit(out)
    return counts, {"calls": calls}


def block_kernel_rows(launches, captured, others):
    """K9 at the ALU block's upload and K10 at the verdict vectors of every
    block (``others``: the other block phases' captures, by phase), with the
    pinned host-to-device copy rate of the same staged bytes."""
    dev = torch.device("cuda")
    plan = captured["plan"]
    staged = transfer.stage(plan, dev)
    args = (staged[:4], staged[4], len(plan.segs), plan.arena_bytes)
    read = sum(t.numel() * t.element_size() for t in staged)
    # held on the leaves (the arena's alignment gaps are never written);
    # timed on the arena alone: building the views is host work after the
    # launch, timed on its own
    k9 = compare("leaf_unpack",
                 lambda: transfer.leaf_views(transfer.leaf_unpack(*args), plan),
                 lambda: transfer.leaf_views(transfer.leaf_unpack_plain(*args), plan),
                 read + plan.wide_bytes, 0,
                 f"ALU block: {len(plan.segs)} leaves, {plan.n_chunks} chunks, "
                 f"{read} bytes staged, {plan.wide_bytes} written", launches["leaf_unpack"],
                 timed=(lambda: transfer.leaf_unpack(*args),
                        lambda: transfer.leaf_unpack_plain(*args)))
    arena = transfer.leaf_unpack(*args)
    k9["leaf_views_host_ms"], _, _ = host_ms(lambda: transfer.leaf_views(arena, plan), 5)
    del arena
    pinned = torch.empty(plan.narrow_bytes, dtype=torch.uint8, pin_memory=True)
    on_card = torch.empty(plan.narrow_bytes, dtype=torch.uint8, device=dev)
    h2d_ms = time_on_card_ms(lambda: on_card.copy_(pinned, non_blocking=True), repeats=10)
    k9.update({"narrow_bytes": plan.narrow_bytes, "wide_bytes": plan.wide_bytes,
               "pinned_h2d_ms": h2d_ms, "pinned_h2d_gb_per_s": plan.narrow_bytes / h2d_ms / 1e6})
    del pinned, on_card

    k10 = {"name": "verdict_pack", "route": "cuda", "source": SOURCES["verdict_pack"],
           "replaces": REPLACES["verdict_pack"], "launches": launches["verdict_pack"],
           **verdict_entry("ALU block", captured["fails"]), "pass": "block", "count": 1,
           "path_shapes": [{**verdict_entry(f"{BLOCK_LABELS[p]} block", c["fails"]),
                            "pass": p, "count": 1} for p, c in others.items()]}
    return [k9, k10]


def verdict_entry(label, fails):
    """K10 at one block's fail vectors against its plain version, with
    ``torch.cat`` of the same vectors as the library call."""
    total = sum(f.numel() for f in fails)
    table = transfer.verdict_table(fails).to(fails[0].device)
    out_bytes = transfer.verdict_offsets([f.numel() for f in fails])[-1]
    entry = measure("verdict_pack", lambda: transfer.verdict_pack(fails, table),
                    lambda: transfer.verdict_pack_plain(fails),
                    total + out_bytes + table.numel() * 8, 0,
                    f"{label}: {len(fails)} vectors, {total} verdicts, {out_bytes} bytes packed, "
                    f"{transfer.verdict_blocks([f.numel() for f in fails])[-1]} blocks")
    entry["library_ms"] = time_on_card_ms(lambda: torch.cat(fails),   # bool out, not uint8
                                          repeats=KERNEL_REPEATS)
    return entry


def block_path_shapes(calls, label):
    """Every kernel at each distinct shape a block verifier's device pass
    gave it (``run_block``'s captures), held against its plain version,
    labelled with the block phase ("block" or "arith"); K11 timed over
    KERNEL_REPEATS launches, the others over BLOCK_SHAPE_REPEATS."""
    out = {}
    clock_hz = sm_clock_max_hz()

    def add(name, kw, kernel_fn, plain_fn, cost, note, plain_repeats=3,
            kernel_repeats=BLOCK_SHAPE_REPEATS):
        out.setdefault(name, []).append({**measure(
            name, kernel_fn, plain_fn, *cost, f"{label}: {note}",
            kernel_repeats=kernel_repeats, plain_repeats=plain_repeats), **pass_of(label, kw)})

    def ok_and_rows(want_ok):
        return lambda ok_g: ([ok_g[0]] if want_ok else []) + list(ok_g[1])

    for args, kw in calls.get("fr_mul", []):
        a, b = args
        out.setdefault("fr_mul", []).append({**fr_mul_entry(
            a, b, f"{label}: {list(a.shape)} x {list(b.shape)} -> [B,16], strides "
            f"{L.row_stride(a)} {L.row_stride(b)}", kernel_repeats=BLOCK_SHAPE_REPEATS,
            plain_repeats=3), **pass_of(label, kw)})
    for args, kw in calls.get("limb_mul", []):
        a, b, out_n = args
        out.setdefault("limb_mul", []).append({**limb_mul_entry(
            a, b, out_n, f"{label}: {list(a.shape)} x {list(b.shape)} -> {out_n} limbs, strides "
            f"{L.row_stride(a)} {L.row_stride(b)}", kernel_repeats=BLOCK_SHAPE_REPEATS,
            plain_repeats=3), **pass_of(label, kw)})
    for (x, keep, reduce), kw in calls.get("limb_reduce", []):
        out.setdefault("limb_reduce", []).append({**limb_reduce_entry(
            x, keep, reduce, f"{label}: {list(x.shape)} -> keep {keep}"
            f"{', reduced' if reduce else ''}", clock_hz, kernel_repeats=BLOCK_SHAPE_REPEATS,
            plain_repeats=3), **pass_of(label, kw)})
    for args, kw in calls.get("limb_addsub", []):
        x, y, mode = args[:3]
        out_n = args[3] if len(args) > 3 else 0
        add("limb_addsub", kw, lambda: L.limb_addsub(*args), lambda: L.addsub_plain(x, y, mode, out_n),
            addsub_cost(*args), f"{MODE_NAMES[mode]} {list(x.shape)} {list(y.shape)} out_n {out_n}"
            f" strides {L.row_stride(x)} {L.row_stride(y)}")
        out["limb_addsub"][-1]["lanes"] = L.batch_rows(x, y)
    for args, kw in calls.get("lookup_gather_eq", []):
        call_kw = {k: v for k, v in kw.items() if k != COUNT}
        pick = ok_and_rows(call_kw.get("want_ok", True))
        table, query, idx = args[:3]
        moved, ops = gather_cost(*args)
        add("lookup_gather_eq", kw, lambda: pick(engine.lookup_gather_eq(*args, **call_kw)),
            lambda: pick(engine.lookup_gather_eq_plain(*args)), (moved, ops),
            f"{table[0].shape[0]}-row table, {len(table)} parts "
            f"({sum(q is not None for q in query)} queried), {idx.shape[0]} lanes")
        entry = out["lookup_gather_eq"][-1]
        entry.update(gather_sector_bound(table, idx, moved))
        entry["lanes"] = idx.shape[0]
        if all(q is None for q in query):
            entry.update(gather_library(table, idx))
    for args, kw in calls.get("state_order_lt", []):
        out.setdefault("state_order_lt", []).append({**order_lt_entry(
            args, f"{label}: {args[0].shape[0]} rw rows, 7 key columns",
            kernel_repeats=BLOCK_SHAPE_REPEATS, plain_repeats=3), **pass_of(label, kw)})
    for args, kw in calls.get("lookup_search_eq", []):
        query, _, _, fps, _, max_span, batch = args
        moved, ops, scanned = search_cost(args)
        add("lookup_search_eq", kw, lambda: list(engine.lookup_search_eq(*args)),
            lambda: list(engine.lookup_search_eq_plain(*args)), (moved, ops),
            f"{batch} lanes, {len(query)} parts, {fps.shape[0]}-row index, span {max_span}, "
            f"{scanned} candidates")
        out["lookup_search_eq"][-1].update(path=search_path(args), lanes=batch)
    for args, kw in calls.get("lookup_fingerprint", []):
        parts, coefs = args
        add("lookup_fingerprint", kw, lambda: engine.lookup_fingerprint(parts, coefs),
            lambda: engine.fingerprint_plain(parts, coefs),
            fingerprint_cost([t.shape for t in parts]),
            f"{parts[0].shape[0]} rows, {len(parts)} parts")
    for args, kw in calls.get("keccak_sponge", []):
        blocks, n_blocks = args
        out.setdefault("keccak_sponge", []).append({**sponge_entry(
            blocks, n_blocks, f"{label}: {blocks.shape[0]} rows, max {blocks.shape[1]} blocks, "
            f"{int(n_blocks.sum())} absorbed", clock_hz, kernel_repeats=BLOCK_SHAPE_REPEATS,
            plain_repeats=0), **pass_of(label, kw)})
    for args, kw in calls.get("horner_rlc", []):
        out.setdefault("horner_rlc", []).append(
            {**horner_entry(label, *args, K8_BLOCK_HELD_STEPS, clock_hz, plain_repeats=0),
             **pass_of(label, kw)})
    for args, kw in calls.get("mul_add_words", []):
        add("mul_add_words", kw, *word_mul_entry(args)[:4], kernel_repeats=KERNEL_REPEATS)
        with_chain(out["mul_add_words"][-1], *word_mul_entry(args)[4:], clock_hz)
    return out


def gather_library(table, idx):
    """The library call of a gather-only K4 launch: one torch.index_select
    a part on the resolved (clamped) rows, timed as K4 is and checked equal
    to its gathered rows."""
    rows = engine.hint_rows(idx, table[0].shape[0])

    def library():
        return [torch.index_select(t, 0, rows) for t in table]

    _, gathered = engine.lookup_gather_eq(table, [None] * len(table), idx, want_ok=False)
    assert all(torch.equal(g, w) for g, w in zip(gathered, library())), \
        "lookup_gather_eq: the gather differs from torch.index_select"
    return {"library": "torch.index_select per part on the clamped rows",
            "library_ms": time_on_card_ms(library, repeats=BLOCK_SHAPE_REPEATS)}


def gather_sector_bound(table, idx, moved):
    """K4's bound with the table read in whole sectors: 32 bytes for each
    distinct 32-byte sector of a table part that this run's rows touch
    (computed on the host from the parts' addresses), in place of the
    touched rows' bytes in ``gather_cost``."""
    rows = hinted_rows(table, idx)
    row_bytes = sum(8 * t.shape[1] for t in table)
    sectors = 0
    for t in table:
        stride = L.row_stride(t)
        start = t.data_ptr() + (rows[:1] if stride == 0 else rows) * stride * 8
        first, last = start // 32, (start + 8 * t.shape[1] - 1) // 32
        # rows ascend and the stride is not negative, so the sector runs do too
        prev_last = np.concatenate([[first[0] - 1], last[:-1]])
        sectors += int(np.maximum(0, last - np.maximum(first, prev_last + 1) + 1).sum())
    sector_moved = moved - len(rows) * row_bytes + 32 * sectors
    return {"table_sectors": sectors, "sector_bytes": sector_moved,
            "sector_bound_ms": sector_moved / HBM_BYTES_PER_S * 1e3}


def pass_of(label, kw):
    """The pass an entry's calls belong to ("block", "arith" or
    "logup_block", "logup_arith": a logUp family's label names its block's
    check) and their count in it."""
    return {"pass": label.split(" ")[0], "count": kw[COUNT]}


def pass_sums(rows, instances):
    """Over each block's device pass and each block's logUp check (every
    family), for every kernel: its calls at the captured shapes (``count``
    of each entry), the sums of count x ms and of count x bound_ms, and
    their difference, the time it loses to its bound; K3's one-lane calls
    and K3's and K7's launches of each path as their launchers counted
    them, K4's sum of count x sector bound.  K13's time includes the K12
    launch inside each of its calls, so a logUp total leaves K12 out."""
    out = {}
    for r in rows:
        for e in [r] + r.get("path_shapes", []):
            if "pass" not in e:
                continue
            s = out.setdefault(e["pass"], {}).setdefault(r["name"], {
                "launches": 0, "shapes": 0, "sum_count_ms": 0.0, "sum_count_bound_ms": 0.0})
            s["launches"] += e["count"]
            s["shapes"] += 1
            s["sum_count_ms"] += e["count"] * e["ms"]
            s["sum_count_bound_ms"] += e["count"] * e["bound_ms"]
            if "lanes" in e:
                s["one_lane_launches"] = (s.get("one_lane_launches", 0)
                                          + (e["count"] if e["lanes"] == 1 else 0))
            if "sector_bound_ms" in e:
                s["sum_count_sector_bound_ms"] = (s.get("sum_count_sector_bound_ms", 0.0)
                                                  + e["count"] * e["sector_bound_ms"])
    for label, by_name in out.items():
        for name, s in by_name.items():
            s["loss_ms"] = s["sum_count_ms"] - s["sum_count_bound_ms"]
            if name in instances.get(label, {}):
                s["instance_launches"] = instances[label][name]
        counted = [s for name, s in by_name.items()
                   if not (label.startswith("logup") and name == "fr_inv")]
        by_name["total"] = {k: sum(s[k] for s in counted)
                            for k in ("launches", "sum_count_ms", "sum_count_bound_ms", "loss_ms")}
        by_name["ranked_by_loss"] = sorted((n for n in by_name if n != "total"),
                                           key=lambda n: -by_name[n]["loss_ms"])
    return out


def search_path(args):
    """The path K6's launcher takes at these arguments (tile, warp or row),
    read from its path counts around one more call."""
    return cuda_build.path_taken("lookup_search_eq", lambda: engine.lookup_search_eq(*args))


def with_chain(entry, wide, clock_hz):
    """K11's entry with its chain bound (``word_mul_chain_ms``: one lane's
    WORD_MUL_CHAIN dependent steps at DEP_LATENCY_CYCLES each and the
    card's top clock), taken into ``bound_ms`` by ``chain_bound``."""
    chain_ms = word_mul_chain_ms(wide, clock_hz)
    entry.update(chain_bound_ms=chain_ms, lane_chain_ops=WORD_MUL_CHAIN[bool(wide)],
                 sm_clock_max_mhz=clock_hz / 1e6)
    entry["bound_ms"], entry["bound_by"], entry["bound_kind"] = chain_bound(
        entry["bound_ms"], entry["bound_by"], chain_ms)
    return entry


def limb_mul_entry(a, b, out_n, note, **kw):
    """K2's product at one shape held against its plain version, and every
    lane against (a * b) mod 2^(16 out_n) on Python ints."""
    entry = measure("limb_mul", lambda: L.limb_mul(a, b, out_n), lambda: L.mul_plain(a, b, out_n),
                    *limb_mul_cost(a.shape, b.shape, out_n), note, **kw)
    rows = max(a.shape[0], b.shape[0])

    def want():
        xs, ys = rows_to_ints(a), rows_to_ints(b)
        return [x * y % (1 << 16 * out_n) for x, y in zip(xs * rows if len(xs) == 1 else xs,
                                                           ys * rows if len(ys) == 1 else ys)]

    python_ints_check(entry, note, rows_to_ints(L.limb_mul(a, b, out_n)), want)
    entry["lanes"] = rows
    return entry


def limb_reduce_entry(x, keep, reduce, note, clock_hz, **kw):
    """K2's normalise-and-reduce entry at one shape held against its plain
    version and against x' mod 2^(16 keep) (mod p, reduced) on Python ints,
    with its chain bound (``runtime/bounds.py:reduce_chain``: one row's
    least depth at DEP_LATENCY_CYCLES each and the card's top clock)."""
    def plain():
        return fr.normalize_reduce_plain(x, keep) if reduce else L.carry_propagate_plain(x, keep)

    entry = measure("limb_reduce", lambda: L.limb_reduce(x, keep, reduce), plain,
                    *reduce_cost(x.shape[0], x.shape[1], keep, reduce), note, **kw)
    cols = x.cpu().tolist()

    def want():
        vals = [sum(c << (16 * k) for k, c in enumerate(row[:keep])) % (1 << (16 * keep))
                for row in cols]
        return [v % fr.P for v in vals] if reduce else vals

    python_ints_check(entry, note, rows_to_ints(L.limb_reduce(x, keep, reduce)), want)
    chain_ms = reduce_chain_ms(keep, reduce, clock_hz)
    entry.update(keep=keep, reduce=bool(reduce), chain_bound_ms=chain_ms,
                 row_chain_ops=reduce_chain(keep, reduce), sm_clock_max_mhz=clock_hz / 1e6)
    entry["bound_ms"], entry["bound_by"], entry["bound_kind"] = chain_bound(
        entry["bound_ms"], entry["bound_by"], chain_ms)
    return entry


def order_lt_ints(cols):
    """K5's function on Python ints: each row's key (the declared-bounds
    integer of ``state.order_key_plain``'s docstring) compared with the
    previous row's (cyclic), or the row is Start."""
    def ints(t, k=None):
        return rows_to_ints(t if k is None else t[:, :k])

    tag, id_, address, field_tag, lo, hi, rwc = (ints(cols[0]), ints(cols[1]), ints(cols[2], 10),
                                                 ints(cols[3]), ints(cols[4]), ints(cols[5]),
                                                 ints(cols[6]))
    keys = []
    for t, i, a, f, l, h, r in zip(tag, id_, address, field_tag, lo, hi, rwc):
        w = ((((t << 28) + i) << 160) + a << 16) + f
        keys.append(((w << 32) + (h << 128 | l) << 32) | r)
    return [keys[i - 1] < keys[i] or tag[i] == 1 for i in range(len(keys))]


def order_lt_entry(cols, note, **kw):
    """K5 at one shape held against its plain version and against the keys
    compared on Python ints."""
    entry = measure("state_order_lt", lambda: state.state_order_lt(*cols),
                    lambda: state.state_order_lt_plain(*cols), *order_cost(cols[0].shape[0]),
                    note, **kw)
    python_ints_check(entry, note, state.state_order_lt(*cols).cpu().tolist(),
                      lambda: order_lt_ints(cols))
    entry["rows"] = cols[0].shape[0]
    return entry


def word_mul_entry(args):
    """K11's (kernel call, plain call, cost, note, wide) at captured
    arguments: the verdicts and, for the 256 variant, the overflow limbs."""
    rows = args[0]
    wide = len(args) > 1 and bool(args[1])
    batch = max(r.shape[0] for r in rows)

    def kernel():
        ok, over = word_mul.mul_add_words(rows, wide)
        return [ok] if over is None else [ok, over]

    def plain():
        ok, over = word_mul.mul_add_words_plain(rows, wide)
        ok = ok.expand(ok.shape[0], batch)
        return [ok] if over is None else [ok, over.expand(batch, 16)]

    return (kernel, plain, word_mul_cost([r.shape for r in rows], wide),
            f"variant {512 if wide else 256}, {batch} lanes, rows {[list(r.shape) for r in rows]}",
            wide)


# -- phase 12: the kernels against their plain versions ---------------------------

def seeded_limbs(rng, rows, n, bound_bits, device):
    """[rows, n] canonical limbs of random values below 2^bound_bits (and
    below p when bound_bits is 254)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % (1 << bound_bits) for _ in range(rows)]
    if bound_bits >= 254:
        vals = [v % fr.P for v in vals]
    return L.ints_to_limbs(vals, n).to(device)


def plain_call(plain_fn):
    """A plain version's output and the ms of its one call (CUDA events
    around the host-issued call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = plain_fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def measure(name, kernel_fn, plain_fn, bytes_moved, int_ops, shape_note,
            kernel_repeats=KERNEL_REPEATS, plain_repeats=5, timed=None, launches_per_call=1,
            plain_result=None):
    """One call of a kernel held against its plain version on the same
    inputs (bit-exact), then both timed, and the bound of the work.  With
    ``plain_repeats`` 0 the plain version's time is that of the one call
    it was held on (for plain versions that take seconds).  ``timed``: the
    (kernel, plain) calls to time instead of the held ones, where those
    add host work after the launch that the events would count.
    ``plain_result``: the plain version's output on these inputs from a
    call made for several shapes at once (``plain_fn`` None), so no plain
    time of this shape alone (``plain_ms`` None)."""
    torch.cuda.synchronize()
    before = L.LAUNCHES[name]
    got = kernel_fn()
    torch.cuda.synchronize()
    assert L.LAUNCHES[name] == before + launches_per_call, \
        f"{name}: the wrapper did not launch its kernel"
    want, plain_once_ms = (plain_result, None) if plain_fn is None else plain_call(plain_fn)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    err = 0
    exact = True
    for g, w in zip(got, want):
        exact = exact and g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        if g.shape == w.shape:
            err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    assert exact, f"{name} at {shape_note}: kernel disagrees with its plain version " \
                  f"(max abs err {err})"
    time_kernel, time_plain = timed or (kernel_fn, plain_fn)
    ms = time_on_card_ms(time_kernel, repeats=kernel_repeats)
    plain_ms = (time_on_card_ms(time_plain, repeats=plain_repeats, warmup=1)
                if plain_repeats and plain_fn is not None else plain_once_ms)
    b_ms, b_by = bound(bytes_moved, int_ops)
    return {"shape": shape_note, "exact": exact, "tolerance": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
            "int_ops": int_ops}


def compare(name, kernel_fn, plain_fn, bytes_moved, int_ops, shape_note, launches, **kw):
    """A kernel's row of the kernels line, at one shape of a path."""
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches,
            **measure(name, kernel_fn, plain_fn, bytes_moved, int_ops, shape_note, **kw),
            "library_ms": None}


def fr_mul_entry(a, b, note, **kw):
    """K1 at one shape held against its plain version, and every lane
    against a * b mod p on Python ints."""
    entry = measure("fr_mul", lambda: fr.fr_mul(a, b), lambda: fr.fr_mul_plain(a, b),
                    *fr_mul_cost(a.shape, b.shape), note, **kw)
    rows = max(a.shape[0], b.shape[0])

    def want():
        xs, ys = rows_to_ints(a), rows_to_ints(b)
        return [x * y % fr.P for x, y in zip(xs * rows if len(xs) == 1 else xs,
                                              ys * rows if len(ys) == 1 else ys)]

    python_ints_check(entry, note, rows_to_ints(fr.fr_mul(a, b)), want)
    return entry


def addsub_cost(a, b, mode, out_n=0):
    """(bytes, int32 operations) of K3: three per limb of a chain (add,
    mask, carry shift), two chains and a select in the Fr modes."""
    rows = max(a.shape[0], b.shape[0])
    n = max(a.shape[1], b.shape[1])
    out_limbs = {L.SUB: n, L.FR_ADD: 16, L.FR_SUB: 16}.get(mode, out_n)
    moved = nbytes(a, b) + rows * out_limbs * 8 + (rows * 8 if mode == L.SUB else 0)
    per_row = 3 * max(n, out_limbs) if mode in (L.ADD, L.SUB) else 3 * 17 + 3 * 17 + 16
    return moved, rows * per_row


def hinted_rows(table, idx):
    """The distinct table rows this run's hint indexes resolve to, sorted."""
    return np.unique(engine.hint_rows(idx, table[0].shape[0]).cpu().numpy())


def gather_cost(table, query, idx, enabled=None):
    """(bytes, int32 operations) of K4: every table row the run's hints
    touch read once (each part), each lane's gathered limbs written once,
    the queries, idx and enabled read, the ok bits written where a part is
    queried, and two per compared limb."""
    B = idx.shape[0]
    row_bytes = 8 * sum(t.shape[1] for t in table)
    pairs = [(t, q) for t, q in zip(table, query) if q is not None]
    moved = (nbytes(idx) + sum(nbytes(q) for _, q in pairs)
             + len(hinted_rows(table, idx)) * row_bytes + B * row_bytes
             + (B if pairs else 0) + (nbytes(enabled) if enabled is not None else 0))
    return moved, 2 * B * sum(max(t.shape[1], q.shape[1]) for t, q in pairs)


MODE_NAMES = {L.ADD: "ADD", L.SUB: "SUB", L.FR_ADD: "FR_ADD", L.FR_SUB: "FR_SUB"}


def kernel_phase(launches, mul_inputs, arith_calls):
    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    B = LANES
    rows = []
    mul_inputs, mul_k11 = mul_inputs

    # K1: the fdiv_const shape, [B, 16] x constant [1, 16]
    a = seeded_limbs(rng, B, 16, 254, dev)
    b = L.int_to_limbs(pow(8, fr.P - 2, fr.P), 16)[None, :].to(dev)
    rows.append({"name": "fr_mul", "route": "cuda", "source": SOURCES["fr_mul"],
                 "replaces": REPLACES["fr_mul"], "launches": launches["fr_mul"],
                 **fr_mul_entry(a, b, "MUL: [B,16] x [1,16] -> [B,16]"), "library_ms": None})

    # K2: the MUL group no longer reaches it (K11 took _mul_512_terms'
    # products); its row is its widest shape on the arithmetic block's pass,
    # and every distinct shape of that pass is in its path_shapes
    a, b, out_n = max((args for args, _ in arith_calls["limb_mul"]),
                      key=lambda args: max(args[0].shape[0], args[1].shape[0]) * args[2])
    rows.append({"name": "limb_mul", "route": "cuda", "source": SOURCES["limb_mul"],
                 "replaces": REPLACES["limb_mul"], "launches": launches["limb_mul"],
                 **limb_mul_entry(a, b, out_n,
                                  f"arith: {list(a.shape)} x {list(b.shape)} -> {out_n} limbs"),
                 "library_ms": None,
                 "library": "none: no PyTorch call forms a limb product with its carries"})

    # K2's normalise-and-reduce entry: the logUp tail's [2, 16] at keep 17
    # (both sides of a check; columns below 2^32 exercise the ripple), then a
    # 32-limb shape reduced (reduce_wide's) and rippled alone (the logUp
    # checks' own calls are in its path_shapes)
    clock_hz = sm_clock_max_hz()
    wide = torch.from_numpy(np.random.RandomState(12).randint(0, 1 << 32, size=(2, 32),
                                                              dtype=np.uint64)
                            .astype(np.int64)).to(dev)
    logup_x = wide[:, :16].contiguous()
    k2r = [limb_reduce_entry(x, keep, red, note, clock_hz) for x, keep, red, note in (
        (logup_x, 17, True, "logUp sides: [2, 16] -> keep 17, reduced"),
        (wide, 32, True, "[2, 32] -> keep 32, reduced"),
        (wide, 32, False, "[2, 32] -> keep 32"))]
    rows.append({"name": "limb_reduce", "route": "cuda", "source": SOURCES["limb_reduce"],
                 "replaces": REPLACES["limb_reduce"], "launches": launches["limb_reduce"],
                 **k2r[0], "library_ms": None,
                 "library": "none: no PyTorch call normalises limb carries or reduces mod p",
                 "path_shapes": k2r[1:]})

    # K3: the Fr add of two full-width values (F.__add__ past 253 bits)
    x = seeded_limbs(rng, B, 16, 254, dev)
    y = seeded_limbs(rng, B, 16, 254, dev)
    rows.append(compare("limb_addsub", lambda: L.limb_addsub(x, y, L.FR_ADD),
                        lambda: L.addsub_plain(x, y, L.FR_ADD, 16), *addsub_cost(x, y, L.FR_ADD),
                        "MUL: FR_ADD [B,16] + [B,16] -> [B,16]", launches["limb_addsub"]))

    # K4: the first stack pop of the MUL replay on its own rw table (3B rows)
    # and hint stream: rw_counter, rw, tag, call id, stack pointer
    curr, _, tree, hints = mul_inputs
    cols = ("rw_counter", "rw", "key0", "id", "address")
    table = [tree["rw"]["cols"][c]["f"] for c in cols]
    query = [curr["rw_counter"], torch.zeros((1, 1), dtype=torch.int64, device=dev),
             torch.tensor([[int(Target.Stack)]], dtype=torch.int64, device=dev),
             curr["call_id"], curr["stack_pointer"]]
    idx = hints[1]["idx"]
    ok_k, _ = engine.lookup_gather_eq(table, query, idx)
    assert bool(ok_k.all()), "lookup_gather_eq: the path's own stack lookup did not match"
    rows.append(compare(
        "lookup_gather_eq",
        lambda: (lambda ok_g: [ok_g[0], *ok_g[1]])(engine.lookup_gather_eq(table, query, idx)),
        lambda: (lambda ok_g: [ok_g[0], *ok_g[1]])(
            engine.lookup_gather_eq_plain(table, query, idx)),
        *gather_cost(table, query, idx),
        f"rw table {table[0].shape[0]} rows, 5 parts, {idx.shape[0]} lanes (the MUL group's)",
        launches["lookup_gather_eq"]))
    rows[-1].update(gather_sector_bound(table, idx, gather_cost(table, query, idx)[0]))

    # K11: the MUL group's word product, variant 256 at its lanes
    ((args, _),) = mul_k11
    k11_kernel, k11_plain, k11_cost, k11_note, wide = word_mul_entry(args)
    rows.append(with_chain(compare("mul_add_words", k11_kernel, k11_plain, *k11_cost,
                                   f"MUL: {k11_note}", launches["mul_add_words"]),
                           wide, sm_clock_max_hz()))
    rows[-1]["library"] = "none: no PyTorch call computes the word product and its carry checks"
    return rows


def slice_kernel_rows(launches, captured):
    """K5 and K6 at the shapes the state and bytecode paths gave them."""
    rows = []

    # K5: the ordering check over the Memory/Stack mix's 2^19 uploaded rows,
    # and the Storage/Account mix's (the blocks' are in its path_shapes)
    k5 = [order_lt_entry(captured[mix]["state_order_lt"],
                         f"state_{mix}: {STATE_ROWS} rows, 7 key columns")
          for mix in ("memory_stack", "storage_account")]
    rows.append({"name": "state_order_lt", "route": "cuda", "source": SOURCES["state_order_lt"],
                 "replaces": REPLACES["state_order_lt"], "launches": launches["state_order_lt"],
                 **k5[0], "library_ms": None,
                 "library": "none: no PyTorch call compares multi-limb keys row by row",
                 "path_shapes": k5[1:]})

    # K6: the Storage lookup of the Storage/Account mix (the kernel's row)
    # and the keccak lookup of the bytecode circuit (its path_shapes); the
    # search part alone is timed with torch.searchsorted on the same index
    # and query fingerprints
    k6 = []
    for label, args in (("state_storage_account: Storage MPT lookup",
                         captured["storage_account"]["lookup_search_eq"]),
                        ("bytecode: keccak lookup", captured["bytecode"]["lookup_search_eq"])):
        query, table, coefs, fps, _, max_span, batch = args
        moved, ops, scanned = search_cost(args)
        keys = fps ^ engine._SIGN
        qkeys = (engine.fingerprint_plain(query, coefs).expand(batch) ^ engine._SIGN).contiguous()
        note = (f"{label}: {batch} lanes, {len(query)} parts, {fps.shape[0]}-row index, "
                f"span {max_span}, {scanned} candidates")
        entry = measure("lookup_search_eq", lambda: list(engine.lookup_search_eq(*args)),
                        lambda: list(engine.lookup_search_eq_plain(*args)), moved, ops, note)
        entry["searchsorted_ms"] = time_on_card_ms(
            lambda: torch.searchsorted(keys, qkeys, side="left"), repeats=KERNEL_REPEATS)
        entry.update(path=search_path(args), lanes=batch)
        k6.append(entry)
    rows.append({"name": "lookup_search_eq", "route": "cuda", "source": SOURCES["lookup_search_eq"],
                 "replaces": REPLACES["lookup_search_eq"], "launches": launches["lookup_search_eq"],
                 **k6[0], "library_ms": None, "path_shapes": k6[1:]})

    # K6's fingerprint entry: the MPT index build of the Storage/Account mix
    parts, coefs = captured["storage_account"]["lookup_fingerprint"]
    rows.append(compare("lookup_fingerprint", lambda: engine.lookup_fingerprint(parts, coefs),
                        lambda: engine.fingerprint_plain(parts, coefs),
                        *fingerprint_cost([t.shape for t in parts]),
                        f"state_storage_account: MPT table, {parts[0].shape[0]} rows, "
                        f"{len(parts)} parts",
                        launches["lookup_fingerprint"]))
    return rows


def path_shape_entries(captured):
    """K1 and K3 at every distinct shape and mode that the state, bytecode
    and withdrawal paths gave them, each held against its plain version."""
    a, b = captured["bytecode"]["fr_mul"]
    k1 = [fr_mul_entry(a, b, f"bytecode: {list(a.shape)} x {list(b.shape)} -> [B,16]")]
    seen = {}
    for path in ("memory_stack", "storage_account", "bytecode", "withdrawal"):
        label = path if path in ("bytecode", "withdrawal") else f"state_{path}"
        for key, args in captured[path]["limb_addsub"].items():
            seen.setdefault(key, (label, args))
    k3 = []
    for (mode, out_n, sa, sb, _, _), (path, args) in seen.items():
        x, y = args[:2]
        k3.append(measure("limb_addsub", lambda: L.limb_addsub(*args),
                          lambda: L.addsub_plain(x, y, mode, out_n), *addsub_cost(*args),
                          f"{path}: {MODE_NAMES[mode]} {list(sa)} {list(sb)} out_n {out_n}"))
    return {"fr_mul": k1, "limb_addsub": k3}


# K8's least work, not the kernel's own arithmetic (a 16-bit-limb field
# product and its Barrett reduction a step, about 1800 instructions): a
# row's value is the sum over active j of byte_j * r^e_j, e_j its active
# steps after j.  With a table of r^0 .. r^(c - 1), c the most active
# steps of a row (read once, 32 bytes an entry: cheaper than the c field
# products that would make it), an active step is one byte times r^e_j's
# eight 32-bit limbs, 8 mad.lo and 8 mad.hi in carry chains and 2 carries
# into a 9-limb accumulator (the sum of 2^17 terms < 2^262 fits 279
# bits); a row then reduces its accumulator once (a 32-bit-limb
# reduction: 8 x 8 limb products as mad.lo/mad.hi pairs and 8 carries).
# A Horner step at 32-bit limbs (8 x 8 products and a Montgomery
# reduction, about 300 instructions) needs no table but 16x the operations
K8_OPS_PER_STEP = 2 * 8 + 2
K8_OPS_PER_ROW = 2 * 8 * 8 + 8


# A squaring forms 36 limb products in place of a field product's 64 (the
# 28 cross products once and the 8 squares), and doubles the cross
# products (16 shifts): 272 instructions against 312 (bounds.fr_product_ops).
FR_PRODUCT_OPS = fr_product_ops()
FR_SQUARE_OPS = FR_PRODUCT_OPS - 2 * (64 - 36) + 16
# an add or a subtraction mod p on eight words: a carry chain, p
# subtracted (added under a borrow) on a second chain, and a select
FR_ADD32_OPS = FR_SUB32_OPS = 3 * 8


def fr_product_chain(square=False):
    """The longest chain of dependent instructions in one 8 x 32-bit-limb
    Montgomery product (or, with ``square``, squaring) by separated operand
    scanning, each instruction issued one step after its last operand and
    its carry-in: the rows of a * b as two carry chains each (the limb
    products' low words into one accumulator, their high words into
    another; a squaring's rows hold only the cross products, doubled by
    one shift a word, then the squares in one chain), the accumulators
    added; the reduction of the low half a word at a time (m_i from the
    lowest word, then the chain of m_i * p's low words and the chain of
    its high words); the high half added; p subtracted and a select.
    Every input word is ready at step 0; returns the chain's length."""
    x, y = [0] * 17, [0] * 17              # ready step of each accumulator word

    def row(acc, cols):
        c = 0
        for k in cols:
            acc[k] = c = max(acc[k], c) + 1
        acc[cols[-1] + 1] = c + 1

    for i in range(8):
        first = i + 1 if square else 0
        if first < 8:
            row(x, [i + j for j in range(first, 8)])
            row(y, [i + j + 1 for j in range(first, 8)])
    t, c = [], 0
    for k in range(16):
        c = max(x[k], y[k], c) + 1
        t.append(c)
    if square:
        t = [max(t[k], t[k - 1] if k else 0) + 1 for k in range(16)]
        c = 0
        for k in range(16):
            t[k] = c = max(t[k], c) + 1
    u = t[:8] + [0]
    for _ in range(8):
        m = u[0] + 1
        c = 0
        for j in range(8):                 # low words of m * p
            u[j] = c = max(u[j], m, c) + 1
        u[8] = c + 1
        c = 0
        for j in range(8):                 # high words of m * p
            u[j + 1] = c = max(u[j + 1], m, c) + 1
        u = u[1:] + [0]
    r, c = [], 0
    for k in range(8):                     # the high half added
        c = max(u[k], t[8 + k], c) + 1
        r.append(c)
    c = 0
    for k in range(8):                     # p subtracted, then the select
        c = max(r[k], c) + 1
    return max(max(r), c) + 1


K8_CHAIN_OPS = fr_product_chain()
FR_SQUARE_CHAIN_OPS = fr_product_chain(square=True)


def sponge_entry(blocks, n_blocks, note, clock_hz, **kw):
    """K7 at one shape held against its plain version, with the path its
    launcher took (``path``: row or warp) and its bytes,
    operations and chain bounds: the chain is the longest row's absorbed
    blocks x 24 rounds x K7_ROUND_CHAIN dependent instructions at
    DEP_LATENCY_CYCLES each and the card's top clock (``sponge_chain_ms``);
    ``bound_ms`` is the largest of the three and ``bound_kind`` says which
    (``bound_by`` names a chain "operations": it is dependent ones)."""
    entry = measure("keccak_sponge", lambda: keccak_ops.keccak_sponge(blocks, n_blocks),
                    lambda: keccak_ops.keccak_sponge_plain(blocks, n_blocks),
                    *sponge_cost_of(blocks, n_blocks), note, **kw)
    entry["path"] = cuda_build.path_taken(
        "keccak_sponge", lambda: keccak_ops.keccak_sponge(blocks, n_blocks))
    got = keccak_ops.keccak_sponge(blocks, n_blocks)
    t0 = time.perf_counter()
    assert np.array_equal(got.cpu().numpy(), sponge_numpy(blocks, n_blocks)), \
        f"keccak_sponge at {note}: disagrees with the numpy keccak-f"
    entry["equals_numpy_keccak"] = True
    entry["numpy_keccak_s"] = time.perf_counter() - t0
    longest = int(n_blocks.clamp(0, blocks.shape[1]).max()) if blocks.shape[0] else 0
    chain_ms = sponge_chain_ms(longest, clock_hz)
    entry.update(chain_bound_ms=chain_ms, round_chain_ops=K7_ROUND_CHAIN, longest_row_blocks=longest,
                 sm_clock_max_mhz=clock_hz / 1e6)
    entry["bound_ms"], entry["bound_by"], entry["bound_kind"] = chain_bound(
        entry["bound_ms"], entry["bound_by"], chain_ms)
    return entry


def sponge_numpy(blocks, n_blocks):
    """Each row's digest words by the host's numpy keccak-f over uint64
    lanes (``ops/keccak.py:_keccak_f_u64``, the permutation the witness
    builders' ``keccak256_batch`` runs), each row stopping at its own
    clamped block count."""
    words = blocks.cpu().numpy().astype(np.uint64)
    lanes = words[:, :, 0:34:2] | (words[:, :, 1:34:2] << np.uint64(32))
    nb = n_blocks.cpu().numpy().clip(0, blocks.shape[1])
    st = [np.zeros(blocks.shape[0], dtype=np.uint64) for _ in range(25)]
    for b in range(int(nb.max()) if nb.size else 0):
        active = b < nb
        absorbed = [st[i] ^ lanes[:, b, i] if i < 17 else st[i] for i in range(25)]
        st = [np.where(active, p, s) for p, s in zip(keccak_ops._keccak_f_u64(absorbed), st)]
    out = np.stack(st[:4], axis=-1)
    return np.stack([out & np.uint64(0xFFFFFFFF), out >> np.uint64(32)], axis=-1).reshape(
        blocks.shape[0], 8).astype(np.int64)


def sponge_cost_of(blocks, n_blocks):
    """K7's (bytes, int32 operations) for this run's data: the blocks each
    row absorbs (read once), its block count and its digest."""
    return sponge_cost(int(n_blocks.clamp(0, blocks.shape[1]).sum()), blocks.shape[0])


def horner_cost(byte_cols, active_cols):
    """(bytes, int32 operations) of K8's least work for this run's data
    (K8_OPS_PER_STEP): the byte and mask columns and the power table up to
    the longest row's active count (read once), the [n, 16] result; the
    active steps and each row's one reduction."""
    T, n = byte_cols.shape
    counts = active_cols.sum(dim=0)
    steps, longest = int(counts.sum()), int(counts.max()) if n else 0
    return (2 * T * n + n * 16 * 8 + longest * 32,
            steps * K8_OPS_PER_STEP + n * K8_OPS_PER_ROW)


def horner_ints(byte_cols, active, r):
    """Each row's byte RLC by the Python-int Horner (exact, independent of
    the limb code), over its active steps in order."""
    b, a = byte_cols.cpu().numpy().T.copy(), active.cpu().numpy().T.copy()
    out = []
    for row, mask in zip(b, a):
        acc = 0
        for v in row[mask].tolist():
            acc = (acc * r + v) % fr.P
        out.append(acc)
    return out


def horner_chain_products(s, T):
    """Dependent field products on K8's longest chain under schedule ``s``:
    a chunk's steps, then one product pair a level of the block's tree and,
    with more than one chunk group, the combine kernel's fold and tree
    (the pair's two products are independent)."""
    levels = (min(s.chunks_per_block, s.chunks) - 1).bit_length() if s.chunks > 1 else 0
    if s.groups > 1:
        per = -(-s.groups // s.combine_threads)
        levels += per - 1 + (-(-s.groups // per) - 1).bit_length()
    return min(s.chunk, max(T, 1)) + levels


def horner_entry(path, byte_cols, active, r, held_steps, clock_hz, plain_repeats):
    """K8 at one path's shape, held against its plain version on the first
    ``held_steps`` steps of the same rows where it has more, and against
    the Python-int Horner at the whole shape; timed at its whole shape;
    with its schedule, its operation bound and its latency bounds."""
    T, n = byte_cols.shape
    note = f"{path}: [{T}, {n}] bytes, {int(active.sum())} active steps"
    held = (byte_cols, active)
    if T > held_steps:              # the plain version on the first steps only
        held = (byte_cols[:held_steps].contiguous(), active[:held_steps].contiguous())
        note += f"; held against the plain version on the first {held_steps} steps"
    held_s = keccak_circuit.horner_schedule(*held[0].shape)
    entry = measure("horner_rlc", lambda: keccak_circuit.horner_rlc(*held, r),
                    lambda: keccak_circuit.horner_rlc_plain(*held, r),
                    *horner_cost(*held), note, kernel_repeats=5,
                    plain_repeats=0 if held[0] is not byte_cols else plain_repeats,
                    launches_per_call=held_s.launches)
    if held[0] is not byte_cols:
        entry["held_steps"] = held_steps
        entry["held_chunk"], entry["held_chunks"] = held_s.chunk, held_s.chunks
        entry["held_ms"], entry["held_bound_ms"] = entry["ms"], entry["bound_ms"]
        entry["ms"] = time_on_card_ms(lambda: keccak_circuit.horner_rlc(byte_cols, active, r),
                                      repeats=5, warmup=1)
        moved, ops = horner_cost(byte_cols, active)
        entry["bound_ms"], entry["bound_by"] = bound(moved, ops)
        entry["bytes"], entry["int_ops"] = moved, ops
    # the whole shape against the Python-int Horner
    t0 = time.perf_counter()
    got = L.limbs_to_ints(keccak_circuit.horner_rlc(byte_cols, active, r).cpu())
    assert got == horner_ints(byte_cols, active, r), \
        f"horner_rlc at {note}: disagrees with the Python-int Horner"
    entry["whole_shape_equals_python_ints"] = True
    entry["python_ints_s"] = time.perf_counter() - t0
    entry["r_limbs"] = (r.bit_length() + 15) // 16
    s = keccak_circuit.horner_schedule(T, n)
    entry["schedule"] = {"chunk": s.chunk, "chunks_per_row": s.chunks,
                         "work_items": n * s.chunks, "rows_per_block": s.rows_per_block,
                         "chunks_per_block": s.chunks_per_block, "stage": s.stage,
                         "groups": s.groups, "combine_threads": s.combine_threads,
                         "launches": s.launches,
                         "target_items": keccak_circuit.HORNER_TARGET_ITEMS,
                         "blocks_per_sm": horner_blocks_per_sm()}
    # the design's latency bound: its chain of dependent products (a
    # chunk, then the combine levels) at K8_CHAIN_OPS instructions a
    # product and the card's top clock
    entry["chain_ops_per_step"] = K8_CHAIN_OPS
    entry["sm_clock_max_mhz"] = clock_hz / 1e6
    entry["chain_products"] = horner_chain_products(s, T)
    entry["chain_bound_ms"] = (entry["chain_products"] * K8_CHAIN_OPS * DEP_LATENCY_CYCLES
                               / clock_hz * 1e3)
    return entry


def horner_blocks_per_sm():
    """Resident 256-thread blocks an SM of K8's chunk and combine kernels,
    from the CUDA occupancy calculator on the built kernels."""
    chunk, combine = ctypes.c_int(), ctypes.c_int()
    err = cuda_build.library("horner_rlc").horner_blocks_per_sm(ctypes.byref(chunk),
                                                                ctypes.byref(combine))
    assert err == 0, f"horner_blocks_per_sm: CUDA error {err}"
    return {"chunk": chunk.value, "combine": combine.value}


def keccak_kernel_rows(launches, captured):
    """K7 and K8 at the shapes the keccak and withdrawal paths gave them:
    the SHA3 mix's for the kernels' rows, the others as path_shapes."""
    rows = []
    clock_hz = sm_clock_max_hz()
    k7 = []
    for data in ("sha3_mix", "alu_block"):
        blocks, n_blocks = captured[f"keccak_{data}"]["keccak_sponge"]
        note = (f"keccak_{data}: {blocks.shape[0]} rows, max {blocks.shape[1]} blocks, "
                f"{int(n_blocks.sum())} absorbed")
        k7.append(sponge_entry(blocks, n_blocks, note, clock_hz,
                               plain_repeats=5 if data == "sha3_mix" else 0))
    rows.append({"name": "keccak_sponge", "route": "cuda", "source": SOURCES["keccak_sponge"],
                 "replaces": REPLACES["keccak_sponge"], "launches": launches["keccak_sponge"],
                 **k7[0], "library_ms": None, "path_shapes": k7[1:]})

    k8 = [horner_entry(path, *captured[path]["horner_rlc"], K8_HELD_STEPS, clock_hz,
                       plain_repeats=5 if path == "withdrawal" else 0)
          for path in ("keccak_sha3_mix", "keccak_alu_block", "withdrawal")]
    rows.append({"name": "horner_rlc", "route": "cuda", "source": SOURCES["horner_rlc"],
                 "replaces": REPLACES["horner_rlc"], "launches": launches["horner_rlc"],
                 **k8[0], "library_ms": None, "path_shapes": k8[1:]})
    return rows


def sliding_window_chain(e, w):
    """(squarings, multiplies, dependent products) of the left-to-right
    sliding-window chain for a^e with window width w: the table a^2, a^3,
    a^5, ..., a^(2^w - 1) (one squaring, 2^(w-1) - 1 multiplies, off the
    main chain but for the entries the first window needs), then per bit a
    squaring and per window a multiply by its table entry."""
    bits = bin(e)[2:]
    squares, muls, first, i = 0, 0, None, 0
    while i < len(bits):
        if bits[i] == "0":
            squares += first is not None
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if first is None:
            first = int(bits[i:j], 2)
        else:
            squares, muls = squares + j - i, muls + 1
        i = j
    table_sq, table_mul = (1, (1 << (w - 1)) - 1) if w > 1 else (0, 0)
    before_first = (1 + (first - 1) // 2) if first > 1 else 0
    return (table_sq + squares, table_mul + muls,
            (before_first, squares, muls))


# K12's function, a^(p-2) mod p, at its least work and least dependent
# length over sliding-window chains of width 1 to 8 (the kernel runs the
# width-4 chain, fr.INV_SCHEDULE: 253 squarings and 56 multiplies)
FR_INV_CHAINS = {w: sliding_window_chain(fr.P - 2, w) for w in range(1, 9)}
FR_INV_OPS = min(sq * FR_SQUARE_OPS + mul * FR_PRODUCT_OPS
                 for sq, mul, _ in FR_INV_CHAINS.values())
FR_INV_CHAIN_LEN = min(head * K8_CHAIN_OPS + sq * FR_SQUARE_CHAIN_OPS + mul * K8_CHAIN_OPS
                       for _, _, (head, sq, mul) in FR_INV_CHAINS.values())
FR_INV_LEAST = min(FR_INV_CHAINS.values(),
                   key=lambda c: c[0] * FR_SQUARE_OPS + c[1] * FR_PRODUCT_OPS)


def fr_inv_cost(a):
    """(bytes, int32 operations) of K12: each lane read and written once, the
    least chain's squarings and multiplies."""
    rows = a.shape[0]
    return nbytes(a) + rows * 16 * 8, rows * FR_INV_OPS


def logup_sum_cost(fps, m):
    """(bytes, int32 operations) of K13's partial sum for n elements: fps
    and m read once, alpha read and the sum written once; the least work of
    the function on 32-bit words: n subtractions from alpha, Montgomery's
    3(n - 1) products and one inverse (K12's least chain), a product by m_i
    (of m's words) unless m is 0/1 (one limb: a select), and n - 1
    additions."""
    n = fps.shape[0]
    by_m = fr_product_ops(8, -(-m.shape[1] // 2)) if m is not None and m.shape[1] > 1 else 0
    moved = nbytes(fps) + (nbytes(m) if m is not None else 0) + 2 * 16 * 8
    return moved, (n * FR_SUB32_OPS + 3 * (n - 1) * FR_PRODUCT_OPS + n * by_m + FR_INV_OPS
                   + (n - 1) * FR_ADD32_OPS)


def rows_to_ints(t):
    """Each row of 16-bit limbs (int64 [n, w]) as a Python int, through the
    rows' little-endian bytes (a few seconds for millions of rows)."""
    raw = t.cpu().numpy().astype("<u2").tobytes()
    width = 2 * t.shape[1]
    return [int.from_bytes(raw[i:i + width], "little") for i in range(0, len(raw), width)]


def logup_sum_ints(fps, alpha, m):
    """sum_i m_i / (alpha - fp_i) mod p on Python ints."""
    return logup.logup_partial_sum_ints(rows_to_ints(fps), rows_to_ints(alpha.reshape(1, -1))[0],
                                        None if m is None else rows_to_ints(m))


def python_ints_check(entry, note, got, want_fn):
    """Hold a kernel's whole output against Python ints, timing the ints."""
    t0 = time.perf_counter()
    assert got == want_fn(), f"{note}: the kernel disagrees with Python ints"
    entry["equals_python_ints"] = True
    entry["python_ints_s"] = time.perf_counter() - t0


def inverses_ints(vals):
    """Each value's inverse mod p on Python ints (0 for 0 mod p), by
    Montgomery's batch inverse of the nonzero ones
    (``logup.batch_inverse_ints``: three products a value, where a ``pow``
    a value took 23.5 s at 131072 lanes)."""
    vals = [v % fr.P for v in vals]
    inv = iter(logup.batch_inverse_ints([v for v in vals if v]))
    return [next(inv) if v else 0 for v in vals]


def fr_inv_entry(label, a, clock_hz, plain_result=None):
    """K12 at one shape, held against its plain version (timed on its one
    call; or ``plain_result``, its output from a plain call over several
    shapes' lanes, see ``measure``) and every lane against Python ints,
    with its latency bound: the least sliding-window chain's dependent
    squarings and products, each at least its chain of dependent
    instructions at the card's top clock."""
    note = f"{label}: {a.shape[0]} lanes x {a.shape[1]} limbs"
    entry = measure("fr_inv", lambda: fr.inv(a),
                    None if plain_result is not None else lambda: fr.inv_plain(a),
                    *fr_inv_cost(a), note, plain_repeats=0, plain_result=plain_result)
    python_ints_check(entry, note, rows_to_ints(fr.inv(a)),
                      lambda: inverses_ints(rows_to_ints(a)))
    _, windows, _ = fr.INV_SCHEDULE
    table_multiplies = (1 << (fr.INV_WINDOW - 1)) - 1
    entry.update({"kernel_squares_multiplies": [1 + sum(sq for sq, _ in windows),
                                                table_multiplies + len(windows)],
                  "least_squares_multiplies": list(FR_INV_LEAST[:2]),
                  "ops_per_square_product": [FR_SQUARE_OPS, FR_PRODUCT_OPS],
                  "chain_ops_per_square_product": [FR_SQUARE_CHAIN_OPS, K8_CHAIN_OPS],
                  "chain_ops": FR_INV_CHAIN_LEN, "sm_clock_max_mhz": clock_hz / 1e6,
                  "chain_bound_ms": FR_INV_CHAIN_LEN * DEP_LATENCY_CYCLES / clock_hz * 1e3})
    return entry


def logup_plan_entry(fps, alpha, m):
    """K13's plan at a side's n elements (levels, tile, workspace, the up
    and down kernels' resident blocks an SM) and the device launches of one
    call at that side, counted where each entry launches a kernel
    (``logup.device_launches``), K12's under ``fr_inv``; they must be the
    plan's."""
    plan = logup.logup_plan(fps.shape[0])
    blocks = [ctypes.c_int(), ctypes.c_int()]
    err = cuda_build.library("logup_sum").logup_blocks_per_sm(*map(ctypes.byref, blocks))
    assert err == 0, f"logup_blocks_per_sm: CUDA error {err}"
    torch.cuda.synchronize()
    k12, (up, down) = L.LAUNCHES["fr_inv"], logup.device_launches()
    logup.logup_partial_sum(fps, alpha, m)
    torch.cuda.synchronize()
    after = logup.device_launches()
    counted = {"up_entry": after[0] - up, "fr_inv": L.LAUNCHES["fr_inv"] - k12,
               "down_entry": after[1] - down}
    counted["call"] = sum(counted.values())
    planned = plan.launches(sum_mode=True)
    assert (counted["up_entry"], counted["fr_inv"], counted["down_entry"]) == \
        (planned[0], 1, planned[1]), f"logup_sum at {plan.levels[0]}: {counted} against the plan"
    return {"plan": {"levels": list(plan.levels), "threads": plan.threads, "run": plan.run,
                     "tile": plan.tile, "workspace_words": plan.words,
                     "launches_up_down": list(planned),
                     "blocks_per_sm": {"up": blocks[0].value, "down": blocks[1].value}},
            "device_launches": counted}


def logup_kernel_rows(launches, captured):
    """K12 at the one-lane inversion of each block's logUp checks and at
    FR_INV_LANES lanes; K13 at every partial sum of every family (table and
    query side of every block), with the plan of its tiles and the device
    launches of one call, counted (``logup_plan_entry``).  Each kernel's
    first logUp call, and K12's seeded lanes, are held against their own
    plain call, timed; the other logUp calls of each kernel against one
    plain call over all of them (``fr.inv_plain`` of every one-lane total;
    ``logup.logup_partial_sums_plain`` of every side, one inverse for all):
    a plain chain of 309 launch-bound products takes about 3 s whatever
    its lanes, so one a call took most of the kernels phase."""
    listed = sorted((f"{BLOCK_LABELS[path]} {family} "
                     f"{'query' if args[2].shape[1] == 1 else 'table'}",
                     args[0].shape[0], args[2].shape[1])
                    for path in BLOCK_PHASES
                    for family, calls in captured[f"logup_{path}"]["calls"].items()
                    for args, _ in calls.get("logup_sum", []))
    assert listed == sorted(workloads.LOGUP_SIDES), \
        f"the blocks' logUp sides are not workloads.LOGUP_SIDES: {listed}"
    clock_hz = sm_clock_max_hz()
    totals, sides = [], []
    for path in BLOCK_PHASES:
        for family, calls in captured[f"logup_{path}"]["calls"].items():
            where = f"logup_{path}"
            totals += [(f"{where}: the {family} check's total", a, pass_of(where, kw))
                       for (a,), kw in calls.get("fr_inv", [])]
            for args, kw in calls.get("logup_sum", []):
                fps, alpha = args[:2]
                m = args[2] if len(args) > 2 else None
                side = ("query side (m = en)" if m is not None and m.shape[1] == 1
                        else "table side")
                note = (f"{where}: {family} {side}, {fps.shape[0]} elements, m "
                        f"{None if m is None else list(m.shape)}")
                sides.append((note, fps, alpha, m, pass_of(where, kw)))
    k12 = [{**fr_inv_entry(totals[0][0], totals[0][1], clock_hz), **totals[0][2]}]
    plain_totals, totals_ms = plain_call(
        lambda: fr.inv_plain(torch.cat([L.pad_limbs(a, fr.NL) for _, a, _ in totals[1:]])))
    k12 += [{**fr_inv_entry(label, a, clock_hz, plain_totals[i:i + 1]), **where}
            for i, (label, a, where) in enumerate(totals[1:])]
    plain_sides, sides_ms = plain_call(
        lambda: logup.logup_partial_sums_plain([(fps, alpha, m)
                                                for _, fps, alpha, m, _ in sides[1:]]))
    k13 = []
    for i, (note, fps, alpha, m, where) in enumerate(sides):
        entry = measure(
            "logup_sum", lambda: logup.logup_partial_sum(fps, alpha, m),
            None if i else lambda: logup.logup_partial_sum_plain(fps, alpha, m),
            *logup_sum_cost(fps, m), note, kernel_repeats=10, plain_repeats=0,
            launches_per_call=2, plain_result=plain_sides[i - 1] if i else None)
        python_ints_check(entry, note,
                          rows_to_ints(logup.logup_partial_sum(fps, alpha, m)[None])[0],
                          lambda: logup_sum_ints(fps, alpha, m))
        k13.append({**entry, **logup_plan_entry(fps, alpha, m), **where})
    rng = np.random.RandomState(6)
    wide = seeded_limbs(rng, FR_INV_LANES, 16, 254, torch.device("cuda"))
    k12.append(fr_inv_entry("seeded", wide, clock_hz))
    rows = []
    for name, entries, shared_ms, library in (
            ("fr_inv", k12, totals_ms, "none: no PyTorch call inverts mod p"),
            ("logup_sum", k13, sides_ms, "none: no PyTorch call computes a batch inverse or a "
                                         "sum of inverses mod p")):
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name], **entries[0],
                     "library_ms": None, "library": library, "path_shapes": entries[1:],
                     "shared_plain": {"calls": sum(e["plain_ms"] is None for e in entries),
                                      "ms": shared_ms}})
    return rows


def main():
    # the small blocks' CPU side, in a worker process while the card works here
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        CPU_SIDE.update({key: pool.submit(cpu_side, *key) for key in cpu_side_keys()})
        run_all()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_all():
    card = card_line()
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    per_kernel = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": per_kernel,
          "flags": cuda_build.NVCC_FLAGS,
          "resource_usage": {name: cuda_build.resource_usage(name)
                             for name in cuda_build.SIGNATURES}})
    run_native(card)

    # the groups: (name, state, builder, pops a step, what corrupt_lane
    # makes wrong, phase)
    groups = [("ADD", ExecutionState.ADD, build_add_workload, 2, "result", "slice", LANES),
              ("MUL", ExecutionState.MUL, build_mul_workload, 2, "result", "slice", LANES)]
    groups += [(name, exec_state, functools.partial(workloads.build_alu_group, name),
                len(operands_of(0, 0, 0)), corrupt, "alu_group", ALU_GROUP_LANES)
               for name, (exec_state, _, operands_of, _, corrupt) in workloads.ALU_GROUPS.items()]
    by_path, captured = {}, {}
    for name, *group in groups:
        by_path[name], (inputs, calls) = run_group(name, *group[:4], card, *group[4:])
        captured[name] = {"calls": calls}
        if name == "MUL":
            mul_inputs = (inputs, calls["mul_add_words"])
        del inputs
    for mix in ("memory_stack", "storage_account"):
        by_path[f"state_{mix}"], captured[mix] = run_state(mix, card)
    by_path["bytecode"], captured["bytecode"] = run_bytecode(card)
    for data in ("alu_block", "sha3_mix"):
        by_path[f"keccak_{data}"], captured[f"keccak_{data}"] = run_keccak(data, card)
    by_path["withdrawal"], captured["withdrawal"] = run_withdrawal(card)
    for path in BLOCK_PHASES:
        (by_path[path], captured[path], by_path[f"logup_{path}"],
         captured[f"logup_{path}"]) = run_block(path, card)
    by_path["tx_sig"], captured["tx_sig"] = run_tx_sig(card)
    by_path["sharded"], captured["sharded"], sstore_bv = run_sharded(card)
    by_path["profile"], captured["profile"] = run_profile(card, sstore_bv)
    launches = {k: sum(c[k] for c in by_path.values()) for k in KERNELS}

    # the kernels phase, the seconds of each of its parts in a kernel_rows line
    parts_s, t0 = {}, time.perf_counter()

    def part(name, value):
        nonlocal t0
        parts_s[name] = parts_s.get(name, 0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        return value

    rows = (part("main_shapes", kernel_phase(launches, mul_inputs, captured["arith"]["calls"]))
            + part("state_bytecode", slice_kernel_rows(launches, captured))
            + part("keccak", keccak_kernel_rows(launches, captured))
            + part("upload_verdicts", block_kernel_rows(
                launches, captured["block"],
                {p: captured[p] for p in BLOCK_PHASES if p != "block"}))
            + part("logup", logup_kernel_rows(launches, captured)))
    for name, entries in part("path_shapes", path_shape_entries(captured)).items():
        next(r for r in rows if r["name"] == name)["path_shapes"] = entries
    shape_calls = [(path, captured[path]["calls"])
                   for path in (*workloads.ALU_GROUPS, *BLOCK_PHASES, "tx_sig")]
    shape_calls += [(f"logup_{path} {family}", calls) for path in BLOCK_PHASES
                    for family, calls in captured[f"logup_{path}"]["calls"].items()]
    for label, calls in shape_calls:
        for name, entries in block_path_shapes(calls, label).items():
            row = next(r for r in rows if r["name"] == name)
            row["path_shapes"] = row.get("path_shapes", []) + entries
        part(label.split(" ")[0], None)
    emit({"phase": "kernel_rows", "seconds": parts_s, "card": card})
    sums = pass_sums(rows, {path: captured[path]["instances"] for path in BLOCK_PHASES})
    emit({"phase": "pass_sums", "passes": sums, "card": card})
    for r in rows:
        r["block_pass_sums"] = {label: by_name[r["name"]] for label, by_name in sums.items()
                                if r["name"] in by_name}
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["card"] = card
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
