"""KV-cache handoff: moving a prefilled request to a decode worker — the
port's counterpart of ``dsml_tpu/serving/handoff.py``.

A :class:`Handoff` carries everything a decode worker needs to continue a
request whose prefill ran elsewhere: the prompt's 1-row KV cache (or its
shipped pages), the next-token logits at the last prompt position, and
the request's identity and timing. Two transports here:

- **In process** (workers share a host): the ``Handoff`` object itself is
  the transfer. Its cache rows or pages stay on the prefill worker's
  device, and ``ContinuousBatcher.inject`` scatters them into the decode
  worker's cache or pool there: no host round trip.
- **CRC-framed byte codec** (:func:`encode_handoff` /
  :func:`decode_handoff`): the cache leaves and the logits serialize into
  one contiguous payload framed like the migration stream path —
  ``MIGRATE_CHUNK`` frames, CRC32C per frame (``utils/crc32c.py``) — so
  one corrupt chunk fails one frame and aborts the handoff
  (:class:`HandoffIntegrityError`) before any byte reaches a cache.
  :func:`frame_transport` round-trips a handoff through it with
  validation on. The header and the payload are the JAX package's, byte
  for byte: either package decodes the other's frame. numpy has no
  bfloat16, so a bf16 leaf travels as its raw bytes under the dtype name
  ``"bfloat16"``, as the JAX header names it. Decoded leaves come back as
  CPU tensors; ``inject`` places them on the worker's device.

- **Across hosts** (:func:`register_with_donor` /
  :func:`fetch_from_migrator`): the prefill host's device server publishes
  every leaf on its ``StateDonor`` and sends a descriptor (the codec's
  header, no payload); the decode host pulls each leaf over the hardened
  P2P streams with a ``ShardMigrator`` (``comm/migration.py``): CRC32C
  frames, resumable offsets, donor-death retries. :func:`stream_transport`
  makes that pair a router's ``transport=``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsml_tpu_torch.utils.crc32c import payload_chunk_crcs

__all__ = [
    "HANDOFF_SCHEMA",
    "Handoff",
    "HandoffIntegrityError",
    "decode_handoff",
    "encode_handoff",
    "fetch_from_migrator",
    "frame_transport",
    "register_with_donor",
    "stream_transport",
]

HANDOFF_SCHEMA = "dsml.serving.handoff/1"

# the header's dtype names (numpy's, as the JAX package writes them)
_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8", torch.int32: "int32",
                torch.int64: "int64"}
_TORCH_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


class HandoffIntegrityError(RuntimeError):
    """The handoff payload failed CRC32C frame validation (or its sizes
    disagree with the header). Corrupted rows never land in a decode
    cache: the caller re-fetches or re-prefills from the prompt, which
    reproduces identical rows."""


@dataclasses.dataclass
class Handoff:
    """One prefilled request in flight between worker roles.

    ``cache1`` is the per-layer 1-row KV cache (``model.init_cache(1)``
    layout: plain k/v or quantized k/k_s/v/v_s entries), filled for
    positions ``[0, prefill_len)``. ``logits`` is the last prompt
    position's next-token row; the decode worker samples the first token
    from it under the (seed, ``key_rid``, step) noise. ``submitted_at`` /
    ``prefill_done_at`` are ``time.monotonic`` marks the router uses for
    the end-to-end TTFT and for splitting prefill wait from decode wait.

    A paged handoff (``page_size`` set) carries the shipped PAGES in
    ``cache1`` instead: per-layer dicts with a leading shipped-page axis
    ``[n_ship, H, page_size, ·]`` in the decode pool's own entry layout,
    which the decode worker installs verbatim. ``prefix_rows`` leading
    rows are not shipped: the decode worker shares its own registered
    prefix pages for them (a page multiple).

    ``trace_id`` is the request's trace identity (``obs.TraceContext``),
    minted at ``Router.submit`` and carried through the codec's header;
    ``parent_span`` names the emitting stage's span."""

    frid: int
    prompt: np.ndarray          # [L] int
    max_new_tokens: int
    prefill_len: int
    cache1: list                # per-layer {entry: tensor [1, H, max_seq, ·]} or pages
    logits: object              # [vocab] tensor (numpy accepted)
    submitted_at: float = 0.0
    prefill_done_at: float = 0.0
    key_rid: int | None = None
    page_size: int | None = None
    prefix_rows: int = 0
    trace_id: str | None = None
    parent_span: str = ""


def _leaves(cache1) -> list:
    """Deterministic leaf order — (layer index, sorted entry keys) — so
    encoder and decoder agree on the payload layout without negotiation."""
    out = []
    for i, layer in enumerate(cache1):
        for key in sorted(layer):
            out.append((i, key, layer[key]))
    return out


def _host_bytes(arr) -> tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or array, read once from
    the device."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"handoff leaf dtype {t.dtype} has no codec name")
        return name, list(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(arr))
    return str(a.dtype), list(a.shape), a.tobytes()


def encode_handoff(handoff: Handoff) -> dict:
    """Serialize a handoff into ``{"header", "payload", "chunk_crcs"}``:
    one contiguous byte payload (cache leaves in :func:`_leaves` order,
    the f32 logits last) plus the CRC32C frame table at ``MIGRATE_CHUNK``
    granularity. The header is JSON-able: a wire implementation ships it
    over its control channel and the payload over the data plane."""
    parts, leaves = [], []
    for i, key, arr in _leaves(handoff.cache1):
        name, shape, raw = _host_bytes(arr)
        parts.append(raw)
        leaves.append({"layer": i, "entry": key, "dtype": name, "shape": shape,
                       "nbytes": len(raw)})
    logits = handoff.logits
    logits = (logits.detach().float() if isinstance(logits, torch.Tensor)
              else np.asarray(logits).astype(np.float32, copy=False))
    parts.append(_host_bytes(logits)[2])
    payload = b"".join(parts)
    header = {
        "schema": HANDOFF_SCHEMA,
        "frid": int(handoff.frid),
        "key_rid": None if handoff.key_rid is None else int(handoff.key_rid),
        "prompt": [int(t) for t in handoff.prompt],
        "max_new_tokens": int(handoff.max_new_tokens),
        "prefill_len": int(handoff.prefill_len),
        "submitted_at": float(handoff.submitted_at),
        "prefill_done_at": float(handoff.prefill_done_at),
        "n_layers": len(handoff.cache1),
        "page_size": handoff.page_size,
        "prefix_rows": int(handoff.prefix_rows),
        "trace_id": handoff.trace_id,
        "parent_span": handoff.parent_span,
        "leaves": leaves,
        "logits_nbytes": len(parts[-1]),
        "total_nbytes": len(payload),
    }
    return {"header": header, "payload": payload, "chunk_crcs": payload_chunk_crcs(payload)}


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (a header name) over a copy of ``raw``."""
    dt = _TORCH_DTYPES.get(dtype)
    if dt is None:
        raise HandoffIntegrityError(f"handoff leaf dtype {dtype!r} is not one the codec carries")
    flat = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    return flat.view(dt).reshape([int(s) for s in shape])


def decode_handoff(frame: dict, validate: bool = True) -> Handoff:
    """Reconstruct a :class:`Handoff` from :func:`encode_handoff` output
    (of either package), validating every CRC32C frame first
    (``validate=False`` skips only the CRC pass — sizes are always
    checked). Cache leaves and logits come back as CPU tensors;
    ``ContinuousBatcher.inject`` places them on its device."""
    header, payload = frame["header"], frame["payload"]
    if header.get("schema") != HANDOFF_SCHEMA:
        raise HandoffIntegrityError(f"unknown handoff schema {header.get('schema')!r}")
    if len(payload) != int(header["total_nbytes"]):
        raise HandoffIntegrityError(
            f"payload is {len(payload)} bytes, header says {header['total_nbytes']}")
    if validate:
        got = payload_chunk_crcs(payload)
        want = list(frame["chunk_crcs"])
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or bad:
            raise HandoffIntegrityError(
                f"CRC32C mismatch on handoff frid={header['frid']}: "
                f"frame(s) {bad[:8]} of {len(got)} failed validation")
    cache1: list = [{} for _ in range(int(header["n_layers"]))]
    off = 0
    for leaf in header["leaves"]:
        n = int(leaf["nbytes"])
        cache1[int(leaf["layer"])][leaf["entry"]] = _tensor(payload[off : off + n], leaf["dtype"],
                                                            leaf["shape"])
        off += n
    n_logits = int(header["logits_nbytes"])
    logits = _tensor(payload[off : off + n_logits], "float32", [n_logits // 4])
    return Handoff(
        frid=int(header["frid"]),
        prompt=np.asarray(header["prompt"], np.int64),
        max_new_tokens=int(header["max_new_tokens"]),
        prefill_len=int(header["prefill_len"]),
        cache1=cache1,
        logits=logits,
        submitted_at=float(header["submitted_at"]),
        prefill_done_at=float(header["prefill_done_at"]),
        key_rid=header.get("key_rid"),
        page_size=header.get("page_size"),
        prefix_rows=int(header.get("prefix_rows", 0)),
        trace_id=header.get("trace_id"),
        parent_span=str(header.get("parent_span") or ""),
    )


def frame_transport(handoff: Handoff) -> Handoff:
    """Round-trip a handoff through the CRC-framed codec with validation:
    the transport that proves the wire framing never perturbs tokens. A
    deployment across hosts replaces this hop with a stream pull."""
    return decode_handoff(encode_handoff(handoff))


def register_with_donor(donor, handoff: Handoff, prefix: str | None = None) -> dict:
    """Publish a handoff on the prefill host's device server: every cache
    leaf (and the logits row) registers with the server's ``StateDonor``
    under ``<prefix>/<layer>/<entry>`` (``<prefix>/logits``), and the
    returned descriptor — the codec's header and the key prefix, no
    payload — travels to the decode host over any control channel. The
    bytes move over ``BeginSend``/``StreamSend`` when the decode host pulls
    (:func:`fetch_from_migrator`). Call ``donor.unregister(prefix)`` once
    the pull completes: handoffs are per-request transients."""
    prefix = prefix if prefix is not None else f"handoff/{int(handoff.frid)}"
    leaves, total = [], 0
    for i, key, arr in _leaves(handoff.cache1):
        t = arr.detach().contiguous().cpu() if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(arr))
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"handoff leaf dtype {t.dtype} has no codec name")
        donor.register_array(f"{prefix}/{i}/{key}", t, trace_id=handoff.trace_id)
        nbytes = t.numel() * t.element_size()
        leaves.append({"layer": i, "entry": key, "dtype": name, "shape": list(t.shape),
                       "nbytes": nbytes})
        total += nbytes
    logits = handoff.logits
    logits = (logits.detach().float().reshape(-1).cpu() if isinstance(logits, torch.Tensor)
              else torch.from_numpy(np.asarray(logits, np.float32).reshape(-1).copy()))
    donor.register_array(f"{prefix}/logits", logits, trace_id=handoff.trace_id)
    header = {
        "schema": HANDOFF_SCHEMA,
        "frid": int(handoff.frid),
        "key_rid": None if handoff.key_rid is None else int(handoff.key_rid),
        "prompt": [int(t) for t in handoff.prompt],
        "max_new_tokens": int(handoff.max_new_tokens),
        "prefill_len": int(handoff.prefill_len),
        "submitted_at": float(handoff.submitted_at),
        "prefill_done_at": float(handoff.prefill_done_at),
        "n_layers": len(handoff.cache1),
        "page_size": handoff.page_size,
        "prefix_rows": int(handoff.prefix_rows),
        "trace_id": handoff.trace_id,
        "parent_span": handoff.parent_span,
        "leaves": leaves,
        "logits_nbytes": logits.numel() * 4,
        "total_nbytes": total + logits.numel() * 4,
    }
    return {"prefix": prefix, "header": header}


def fetch_from_migrator(migrator, descriptor: dict) -> Handoff:
    """Pull a published handoff over the hardened P2P streams: one
    ``ShardMigrator.fetch_piece`` per leaf (whole-tensor pieces), each
    CRC32C-validated frame by frame with resumable offsets and donor-death
    retries. Raises ``comm.migration.MigrationError`` when a leaf cannot be
    delivered (the router's contract is then a re-prefill). Leaves come
    back as CPU tensors; ``inject`` places them on the worker's device."""
    from dsml_tpu_torch.obs import TraceContext, get_tracer

    header = descriptor["header"]
    prefix = descriptor["prefix"]
    ctx = TraceContext.from_header(header)
    cache1: list = [{} for _ in range(int(header["n_layers"]))]
    # the pull is the cross-host hop: a trace-tagged span (and flow step)
    # on the decode host's timeline
    with get_tracer().request_span("handoff_pull", ctx, flow="step", frid=int(header["frid"]),
                                   nbytes=int(header["total_nbytes"])):
        for leaf in header["leaves"]:
            piece = [[0, int(s)] for s in leaf["shape"]]
            cache1[int(leaf["layer"])][leaf["entry"]] = migrator.fetch_piece(
                f"{prefix}/{leaf['layer']}/{leaf['entry']}", piece, leaf["dtype"],
                trace_id=header.get("trace_id"))
        vocab = int(header["logits_nbytes"]) // 4
        logits = migrator.fetch_piece(f"{prefix}/logits", [[0, vocab]], "float32",
                                      trace_id=header.get("trace_id")).reshape(-1)
    return Handoff(
        frid=int(header["frid"]),
        prompt=np.asarray(header["prompt"], np.int64),
        max_new_tokens=int(header["max_new_tokens"]),
        prefill_len=int(header["prefill_len"]),
        cache1=cache1,
        logits=logits,
        submitted_at=float(header["submitted_at"]),
        prefill_done_at=float(header["prefill_done_at"]),
        key_rid=header.get("key_rid"),
        page_size=header.get("page_size"),
        prefix_rows=int(header.get("prefix_rows", 0)),
        trace_id=header.get("trace_id"),
        parent_span=str(header.get("parent_span") or ""),
    )


def stream_transport(donor, migrator):
    """A router ``transport=`` that moves every handoff across hosts:
    published on the prefill host's ``StateDonor`` (``donor``), pulled by
    the decode host's ``ShardMigrator`` (``migrator``), then unregistered."""

    def transport(handoff: Handoff) -> Handoff:
        desc = register_with_donor(donor, handoff)
        try:
            return fetch_from_migrator(migrator, desc)
        finally:
            donor.unregister(desc["prefix"])

    return transport
