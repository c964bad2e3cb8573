"""Tag enums and columnar schemas for every lookup table.

The tag values are protocol constants of the spec and must match the
reference exactly (reference: src/zkevm_specs/evm_circuit/table.py:14-361,
row layouts :404-576).
"""
from __future__ import annotations

from enum import IntEnum, auto

from .engine import Col, Schema


class FixedTableTag(IntEnum):
    Range5 = auto()
    Range16 = auto()
    Range32 = auto()
    Range64 = auto()
    Range256 = auto()
    Range512 = auto()
    Range1024 = auto()
    Range24_576 = auto()
    SignByte = auto()
    BitwiseAnd = auto()
    BitwiseOr = auto()
    BitwiseXor = auto()
    ResponsibleOpcode = auto()
    Pow2 = auto()
    OpcodeConstantGas = auto()
    PrecompileInfo = auto()

    @staticmethod
    def range_table_tag(rng: int) -> "FixedTableTag":
        return {
            5: FixedTableTag.Range5,
            16: FixedTableTag.Range16,
            32: FixedTableTag.Range32,
            64: FixedTableTag.Range64,
            256: FixedTableTag.Range256,
            512: FixedTableTag.Range512,
            1024: FixedTableTag.Range1024,
            24576: FixedTableTag.Range24_576,
        }[rng]

    def range_bound(self) -> int:
        return {
            FixedTableTag.Range5: 5,
            FixedTableTag.Range16: 16,
            FixedTableTag.Range32: 32,
            FixedTableTag.Range64: 64,
            FixedTableTag.Range256: 256,
            FixedTableTag.Range512: 512,
            FixedTableTag.Range1024: 1024,
            FixedTableTag.Range24_576: 24576,
        }[self]


class BlockContextFieldTag(IntEnum):
    Coinbase = auto()
    GasLimit = auto()
    Number = auto()
    Timestamp = auto()
    PrevRandao = auto()
    BaseFee = auto()
    ChainId = auto()
    HistoryHash = auto()
    WithdrawalRoot = auto()


class TxContextFieldTag(IntEnum):
    Nonce = auto()
    Gas = auto()
    GasPrice = auto()
    CallerAddress = auto()
    CalleeAddress = auto()
    IsCreate = auto()
    Value = auto()
    CallDataLength = auto()
    CallDataGasCost = auto()
    TxInvalid = auto()
    AccessListGasCost = auto()
    TxSignHash = auto()
    CallData = auto()


class BytecodeFieldTag(IntEnum):
    Header = 1
    Byte = 2


class RW(IntEnum):
    Read = 0
    Write = 1


class Target(IntEnum):
    Start = auto()
    TxAccessListAccount = auto()
    TxAccessListAccountStorage = auto()
    TxRefund = auto()
    Account = auto()
    AccountStorage = auto()
    CallContext = auto()
    Stack = auto()
    Memory = auto()
    TxLog = auto()
    TxReceipt = auto()

    def write_with_reversion(self) -> bool:
        return self in (
            Target.TxAccessListAccount,
            Target.TxAccessListAccountStorage,
            Target.Account,
            Target.AccountStorage,
            Target.TxRefund,
        )


class AccountFieldTag(IntEnum):
    Nonce = auto()
    Balance = auto()
    CodeHash = auto()
    NonExisting = auto()


class CallContextFieldTag(IntEnum):
    RwCounterEndOfReversion = auto()
    CallerId = auto()
    TxId = auto()
    Depth = auto()
    CallerAddress = auto()
    CalleeAddress = auto()
    CallDataOffset = auto()
    CallDataLength = auto()
    ReturnDataOffset = auto()
    ReturnDataLength = auto()
    Value = auto()
    IsSuccess = auto()
    IsPersistent = auto()
    IsStatic = auto()
    IsRoot = auto()
    IsCreate = auto()
    CodeHash = auto()
    LastCalleeId = auto()
    LastCalleeReturnDataOffset = auto()
    LastCalleeReturnDataLength = auto()
    ProgramCounter = auto()
    StackPointer = auto()
    GasLeft = auto()
    MemorySize = auto()
    ReversibleWriteCounter = auto()


class TxLogFieldTag(IntEnum):
    Address = auto()
    Topic = auto()
    Data = auto()
    TopicLength = auto()
    DataLength = auto()


class TxReceiptFieldTag(IntEnum):
    PostStateOrStatus = auto()
    CumulativeGasUsed = auto()
    LogLength = auto()


class CopyDataTypeTag(IntEnum):
    Bytecode = auto()
    Memory = auto()
    TxCalldata = auto()
    TxLog = auto()
    RlcAcc = auto()


class MPTProofType(IntEnum):
    NonceMod = 1
    BalanceMod = 2
    CodeHashMod = 3
    NonExistingAccountProof = 4
    AccountDeleteMod = 5
    StorageMod = 6
    NonExistingStorageProof = 7
    WithdrawalMod = 8

    @staticmethod
    def from_account_field_tag(field_tag: AccountFieldTag) -> "MPTProofType":
        return {
            AccountFieldTag.Nonce: MPTProofType.NonceMod,
            AccountFieldTag.Balance: MPTProofType.BalanceMod,
            AccountFieldTag.CodeHash: MPTProofType.CodeHashMod,
            AccountFieldTag.NonExisting: MPTProofType.NonExistingAccountProof,
        }[field_tag]


class EccOpTag(IntEnum):
    Add = auto()
    Mul = auto()
    Pairing = auto()


# ---------------------------------------------------------------------------
# Columnar schemas (field layouts mirror reference row dataclasses,
# table.py:404-576)
# ---------------------------------------------------------------------------

BLOCK_SCHEMA = Schema(
    "block",
    {
        "field_tag": Col("f", 8),
        "block_number_or_zero": Col("f", 64),
        "value": Col("word"),
    },
)

TX_SCHEMA = Schema(
    "tx",
    {
        "tx_id": Col("f", 32),
        "field_tag": Col("f", 8),
        "call_data_index_or_zero": Col("f", 64),
        "value": Col("word"),
    },
)

WITHDRAWAL_SCHEMA = Schema(
    "withdrawal",
    {
        "id": Col("f", 64),
        "validator_id": Col("f", 64),
        "address": Col("f", 160),
        "amount": Col("f", 64),
    },
)

BYTECODE_SCHEMA = Schema(
    "bytecode",
    {
        "bytecode_hash": Col("word"),
        "field_tag": Col("f", 8),
        "index": Col("f", 64),
        "is_code": Col("f", 1),
        "value": Col("f", 64),
    },
)

RW_SCHEMA = Schema(
    "rw",
    {
        "rw_counter": Col("f", 32),
        "rw": Col("f", 1),
        "key0": Col("f", 8),  # Target
        "id": Col("f", 32),
        "address": Col("f", 160),
        "field_tag": Col("f", 16),
        "storage_key": Col("word"),
        "value": Col("word"),
        "value_prev": Col("word"),
        "aux0": Col("word"),
    },
)

MPT_SCHEMA = Schema(
    "mpt",
    {
        "address": Col("f", 160),
        "proof_type": Col("f", 8),
        "storage_key": Col("word"),
        "root": Col("word"),
        "root_prev": Col("word"),
        "value": Col("word"),
        "value_prev": Col("word"),
    },
)

COPY_SCHEMA = Schema(
    "copy",
    {
        "is_first": Col("f", 1),
        "src_id": Col("word"),
        "src_tag": Col("f", 8),
        "dst_id": Col("word"),
        "dst_tag": Col("f", 8),
        "src_addr": Col("f", 64),
        "src_addr_end": Col("f", 64),
        "dst_addr": Col("f", 64),
        "length": Col("f", 64),
        "rlc_acc": Col("f", 254),
        "rw_counter": Col("f", 32),
        "rwc_inc": Col("f", 32),
    },
)

KECCAK_SCHEMA = Schema(
    "keccak",
    {
        "state_tag": Col("f", 8),
        "input_rlc": Col("f", 254),
        "input_len": Col("f", 64),
        "output": Col("word"),
    },
)

EXP_SCHEMA = Schema(
    "exp",
    {
        "is_step": Col("f", 1),
        "identifier": Col("f", 32),
        "is_last": Col("f", 1),
        "base_limb0": Col("f", 64),
        "base_limb1": Col("f", 64),
        "base_limb2": Col("f", 64),
        "base_limb3": Col("f", 64),
        "exponent": Col("word"),
        "exponentiation": Col("word"),
    },
)

SIG_SCHEMA = Schema(
    "sig",
    {
        "msg_hash": Col("word"),
        "sig_v": Col("f", 8),
        "sig_r": Col("word"),
        "sig_s": Col("word"),
        "recovered_addr": Col("f", 160),
        "is_valid": Col("f", 1),
    },
)

ECC_SCHEMA = Schema(
    "ecc",
    {
        "op_type": Col("f", 8),
        "px": Col("word"),
        "py": Col("word"),
        "qx": Col("word"),
        "qy": Col("word"),
        "input_rlc": Col("f", 254),
        "out_x": Col("f", 254),
        "out_y": Col("f", 254),
        "is_valid": Col("f", 1),
    },
)
