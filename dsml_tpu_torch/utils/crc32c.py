"""CRC32C (Castagnoli) and the per-frame checksum table of a byte payload
— the port's own copy of ``dsml_tpu/runtime/native.py``'s table-driven
``_crc32c_py`` and of ``dsml_tpu/comm/migration.py``'s
``payload_chunk_crcs`` at ``MIGRATE_CHUNK`` frames
(``dsml_tpu/comm/device_server.py``'s 256 KiB stream chunk).

The serving handoff codec (``serving/handoff.py``) frames its payload with
these. Pure Python, one table lookup a byte. The C route of the JAX
package (``runtime/native.py``) comes with the control plane (ROADMAP.md
queue 1, item 14), whose ``comm/migration.py`` and ``runtime/native.py``
re-export these names.
"""

from __future__ import annotations

__all__ = ["MIGRATE_CHUNK", "crc32c", "payload_chunk_crcs"]

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
    """CRC32C of ``data`` (bytes-like); pass the previous return value as
    ``crc`` to roll the checksum across chunks. Equal to the JAX package's
    ``runtime.native.crc32c`` (C kernel or Python fallback) on any input."""
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
