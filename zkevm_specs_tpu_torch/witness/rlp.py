"""Minimal RLP encoder (witness generation); a copy of
``zkevm_specs_tpu/witness/rlp.py``.

The reference pulls in the `rlp` package; here the encoding (ethereum
yellow-paper appendix B) is implemented directly — only encoding of
byte-strings, ints and nested lists is needed by the spec.
"""
from __future__ import annotations

from typing import Union

Encodable = Union[int, bytes, bytearray, list, tuple]


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    length_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(length_bytes)]) + length_bytes


def _int_to_bytes(value: int) -> bytes:
    assert value >= 0
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def rlp_encode(item: Encodable) -> bytes:
    if isinstance(item, int):
        item = _int_to_bytes(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")
