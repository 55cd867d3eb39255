"""CRC32C (Castagnoli) and the per-frame checksum table of a byte payload
— the counterpart of ``dsml_tpu/runtime/native.py``'s ``crc32c`` and of
``dsml_tpu/comm/migration.py``'s ``payload_chunk_crcs`` at
``MIGRATE_CHUNK`` frames (the device server's 256 KiB stream chunk).

Shard migration (``comm/migration.py``) and the serving handoff codec
(``serving/handoff.py``) frame their payloads with these. :func:`crc32c`
runs the native runtime's ``ds_crc32c`` (``runtime/native.py``, built on
first use); :func:`crc32c_py`, one table lookup a byte in Python, is its
plain version.
"""

from __future__ import annotations

__all__ = ["MIGRATE_CHUNK", "crc32c", "crc32c_py", "payload_chunk_crcs"]

# one CRC frame of a migration or handoff payload (the stream's DataChunk)
MIGRATE_CHUNK = 1 << 18

_CRC32C_TABLE: list | None = None


def _crc32c_table() -> list:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            tbl.append(c)
        _CRC32C_TABLE = tbl
    return _CRC32C_TABLE


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like) with the native ``ds_crc32c``; pass
    the previous return value as ``crc`` to roll the checksum across
    chunks. Equal to the JAX package's ``runtime.native.crc32c``."""
    from dsml_tpu_torch.runtime import native

    return native.crc32c(data, crc)


def crc32c_py(data, crc: int = 0) -> int:
    """Plain version of :func:`crc32c`: table-driven, one byte at a time."""
    data = data if isinstance(data, (bytes, bytearray)) else bytes(data)
    tbl = _crc32c_table()
    c = ~crc & 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF


def payload_chunk_crcs(payload: bytes) -> list[int]:
    """CRC32C per ``MIGRATE_CHUNK`` frame, at absolute payload offsets (a
    resumed suffix re-validates against the original frame table); an
    empty payload has one frame, the CRC of no bytes."""
    return [
        crc32c(payload[off : off + MIGRATE_CHUNK])
        for off in range(0, len(payload), MIGRATE_CHUNK)
    ] or [crc32c(b"")]
