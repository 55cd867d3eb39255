"""Context-parallel ring attention over the flash kernels — the counterpart
of ``dsml_tpu/ops/ring_attention.py``: the sequence sharded across the
ranks of a ring group (the ``cp`` or ``sp`` axis, ``parallel/mesh.py``), K/V blocks
STREAMED around the ring instead of any rank holding full-length
attention.

- **Bidirectional ring2 schedule**: the per-rank K/V shard splits into two
  halves that rotate in OPPOSITE directions through
  ``ops.collectives.ring_pass``, so each direction carries half the volume.
- **Causal hop skipping**: a visiting K/V half whose source rank lies
  strictly later in the sequence is fully masked for every resident query;
  the flash call is skipped (rank and hop are Python ints here, so the
  predicate is a host bool), leaving the merge identity (0, -1e30).
- **KV re-streaming backward**: the autograd function saves only this
  rank's residents (q, k, v, out, lse). The backward streams K/V around the
  ring a second time, recomputing each hop's block gradients from the
  merged statistics (``ops.flash.flash_block_grads``): dq accumulates
  locally while the f32 dk/dv accumulators ride the ring WITH their blocks
  and take one final hop home.

Per-hop (out, lse) pairs merge with logsumexp weights, which reconstructs
exact full attention. Three hop schedules (``DSML_RING_FUSED``,
:func:`ring_fused_mode`) compute the same merges in the same order:
``off`` rotates the residents after each hop's flash calls, ``sendahead``
starts the rotation before them (a side stream on the card), ``dma``
hands each direction's hop to ``ops.flash.flash_stream_hop``, whose CUDA
kernel (kernel 4, ``csrc/flash_stream.cu``) computes the block and streams
the residents into the neighbour's receive slot in one launch. The
zigzag layout (:func:`zigzag_indices`) balances causal work across ranks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dsml_tpu_torch.ops.collectives import ring_pass, ring_pass_start
from dsml_tpu_torch.ops.flash import flash_attention, flash_block_grads, flash_fwd, flash_stream_hop

__all__ = ["ring_attention", "ring_fused_mode", "ring_kv_wire_bytes", "causal_keep_fraction",
           "causal_critical_path_fraction", "zigzag_indices", "zigzag_inverse"]

_LSE_FLOOR = -1e30  # "nothing seen": logaddexp identity, exp(floor − x) = 0
_FUSED = {"": None, "0": None, "off": None, "none": None, "false": None,
          "1": "sendahead", "on": "sendahead", "true": "sendahead", "sendahead": "sendahead",
          "auto": "sendahead", "dma": "dma"}


def ring_fused_mode() -> str | None:
    """The hop schedule ``DSML_RING_FUSED`` names: unset, "0" or "off" →
    None (rotate after each hop's flash calls); "1", "on" or "sendahead" →
    "sendahead" (the next hop's rotation starts before this hop's flash
    calls); "dma" → "dma" (the fused kernel streams the residents). Read at
    every call; any other value raises."""
    raw = os.environ.get("DSML_RING_FUSED", "").strip().lower()
    if raw not in _FUSED:
        raise ValueError(f"DSML_RING_FUSED={raw!r}: choose off, sendahead or dma")
    return _FUSED[raw]


def _halves(s_local: int) -> list[tuple[int, int, int]]:
    """(row_start, row_len, ring direction) for the two KV half-shards.
    The first (ceil) half rotates forward, the second backward; a length-0
    half (s_local == 1) drops out entirely."""
    h0 = (s_local + 1) // 2
    return [(start, length, sign)
            for start, length, sign in ((0, h0, +1), (h0, s_local - h0, -1))
            if length > 0]


# ---- zigzag/striped shard layout (the causal load-balance fix) ---------------
# Rank r holds stripes {r, 2n−1−r} of 2n: an early stripe paired with a late
# one, so every rank executes the same (2n+1) of its 4n stripe pairs.


def zigzag_indices(n_ranks: int, s_global: int) -> np.ndarray:
    """Row permutation placing stripes {r, 2n−1−r} on rank r: sharding
    ``x[..., zigzag_indices(n, S), :]`` contiguously gives every rank its
    zigzag shard. Requires ``s_global % (2·n_ranks) == 0``."""
    n = int(n_ranks)
    if s_global % (2 * n):
        raise ValueError(f"zigzag needs 2·cp stripes: {s_global} rows not divisible by {2 * n}")
    stripe = s_global // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * stripe, (r + 1) * stripe))
        order.extend(range((2 * n - 1 - r) * stripe, (2 * n - r) * stripe))
    return np.asarray(order, np.int32)


def zigzag_inverse(n_ranks: int, s_global: int) -> np.ndarray:
    """Inverse permutation: ``out[..., zigzag_inverse(n, S), :]`` restores
    global row order from a zigzag-sharded result."""
    perm = zigzag_indices(n_ranks, s_global)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return inv


def _zig_halves(s_local: int) -> list[tuple[int, int, int]]:
    """The zigzag KV split: the two resident stripes are the two ring
    halves (early stripe forward, late stripe backward)."""
    if s_local % 2:
        raise ValueError(f"zigzag needs an even per-rank length, got {s_local}")
    st = s_local // 2
    return [(0, st, +1), (st, st, -1)]


def _q_blocks(layout: str, rank: int, s_local: int, n: int):
    """(row_start, row_len, global_start) for this rank's query blocks:
    one block at rank·s_local (contiguous), or the two stripes at their
    interleaved global origins (zigzag)."""
    if layout == "zigzag":
        st = s_local // 2
        return [(0, st, rank * st), (st, st, (2 * n - 1 - rank) * st)]
    return [(0, s_local, rank * s_local)]


def _kv_global_start(layout: str, src: int, start: int, s_local: int, n: int) -> int:
    """Global position of a visiting KV half's first row, given its source
    rank and local row offset."""
    if layout == "zigzag":
        st = s_local // 2
        return src * st if start == 0 else (2 * n - 1 - src) * st
    return src * s_local + start


def _merge(run_out, run_lse, o, lse):
    """Fold one hop's (out, lse) into the running pair with logsumexp
    weights (both f32). Skipped hops contribute (0, _LSE_FLOOR): weight 0."""
    new_lse = torch.logaddexp(run_lse, lse)
    w_prev = torch.exp(run_lse - new_lse)[..., None]
    w_new = torch.exp(lse - new_lse)[..., None]
    return w_prev * run_out + w_new * o, new_lse


def _keep_pair(layout: str, causal: bool, hop: int, src: int, rank: int, k_start: int,
               q_gs: int, q_len: int) -> bool:
    """Whether the (q block, visiting kv half) pair has any unmasked score.
    Contiguous: hop 0 always, later hops when ``src <= rank``. Zigzag: the
    stripe-level rule ``kv_start <= q_end`` at every hop."""
    if not causal:
        return True
    if layout == "zigzag":
        return k_start <= q_gs + q_len - 1
    return hop == 0 or src <= rank


def _flash_lse(q, k, v, causal, q_start, k_start):
    """The flash forward of one pair, [b, h, s, d] in, (out in q's type,
    lse f32) out; no autograd (the ring's own backward re-streams)."""
    b, h, s_q, d = q.shape
    out, lse = flash_fwd(q.reshape(b * h, s_q, d).contiguous(),
                         k.reshape(b * h, -1, d).contiguous(),
                         v.reshape(b * h, -1, d).contiguous(), causal, q_start, k_start)
    return out.view(b, h, s_q, d), lse.view(b, h, s_q)


def _layout_halves(layout: str, s_local: int):
    return _halves(s_local) if layout == "contiguous" else _zig_halves(s_local)


def _ring_fwd_pass(q, k, v, group, causal, layout, fused):
    """n-hop bidirectional forward → (out f32, lse f32) of this rank's query
    shard. ``fused`` picks the hop schedule, never the math."""
    n, rank = group.size, group.rank
    b, h, s_local, d = q.shape
    run_out = torch.zeros(b, h, s_local, d, dtype=torch.float32, device=q.device)
    run_lse = torch.full((b, h, s_local), _LSE_FLOOR, dtype=torch.float32, device=q.device)
    halves = _layout_halves(layout, s_local)
    qblocks = _q_blocks(layout, rank, s_local, n)
    resident = {sign: (k[:, :, start:start + length].contiguous(),
                       v[:, :, start:start + length].contiguous())
                for start, length, sign in halves}
    for hop in range(n):
        incoming: dict = {}
        if fused == "sendahead" and hop != n - 1:
            # the next hop's rotation starts before this hop's math
            incoming = {sign: ring_pass_start(kv, group, sign) for sign, kv in resident.items()}
        for start, length, sign in halves:
            kh, vh = resident[sign]
            src = (rank - sign * hop) % n  # whose half is resident this hop
            k_start = _kv_global_start(layout, src, start, s_local, n)
            for q_idx, (q_row, q_len, q_gs) in enumerate(qblocks):
                qb = q[:, :, q_row:q_row + q_len]
                keep = _keep_pair(layout, causal, hop, src, rank, k_start, q_gs, q_len)
                if fused == "dma" and hop != n - 1 and q_idx == 0:
                    # the hop rides the first q block's kernel: flash + the
                    # stream of (kh, vh) into the next rank's slot; masked
                    # hops still move their bytes
                    o, lse, k_nxt, v_nxt = flash_stream_hop(qb, kh, vh, keep, group, sign, causal,
                                                            q_gs, k_start)
                    incoming[sign] = (k_nxt, v_nxt)
                elif keep:
                    o, lse = _flash_lse(qb, kh, vh, causal, q_gs, k_start)
                else:
                    o = torch.zeros(b, h, q_len, d, dtype=torch.float32, device=q.device)
                    lse = torch.full((b, h, q_len), _LSE_FLOOR, dtype=torch.float32,
                                     device=q.device)
                rows = slice(q_row, q_row + q_len)
                run_out[:, :, rows], run_lse[:, :, rows] = _merge(
                    run_out[:, :, rows], run_lse[:, :, rows], o.float(), lse)
        if hop != n - 1:
            if fused == "sendahead":
                resident = {sign: tuple(p.wait()) for sign, p in incoming.items()}
            elif fused == "dma":
                resident = incoming
            else:
                resident = {sign: tuple(ring_pass(kv, group, sign)) for sign, kv in resident.items()}
    return run_out, run_lse


def _ring_bwd(q, k, v, out, lse, g, group, causal, layout, fused):
    """The KV re-streaming backward: dq accumulates locally, (k, v, dk, dv)
    of each half travel together and the accumulators take a final hop
    home. With a fused schedule the K/V legs rotate ahead of the hop's
    math and the accumulators behind it."""
    n, rank = group.size, group.rank
    b, h, s_local, d = q.shape
    dq = torch.zeros(b, h, s_local, d, dtype=torch.float32, device=q.device)
    halves = _layout_halves(layout, s_local)
    qblocks = _q_blocks(layout, rank, s_local, n)
    state = {sign: (k[:, :, start:start + length].contiguous(),
                    v[:, :, start:start + length].contiguous(),
                    torch.zeros(b, h, length, d, dtype=torch.float32, device=q.device),
                    torch.zeros(b, h, length, d, dtype=torch.float32, device=q.device))
             for start, length, sign in halves}

    for hop in range(n):
        kv_ahead: dict = {}
        if fused and hop != n - 1:
            kv_ahead = {sign: ring_pass_start((s[0], s[1]), group, sign)
                        for sign, s in state.items()}
        for start, length, sign in halves:
            kh, vh, dkh, dvh = state[sign]
            src = (rank - sign * hop) % n
            k_start = _kv_global_start(layout, src, start, s_local, n)
            for q_row, q_len, q_gs in qblocks:
                if not _keep_pair(layout, causal, hop, src, rank, k_start, q_gs, q_len):
                    continue  # a fully masked pair contributes zeros
                rows = slice(q_row, q_row + q_len)
                dq_p, dk_p, dv_p = flash_block_grads(
                    q[:, :, rows], kh, vh, out[:, :, rows], lse[:, :, rows], g[:, :, rows],
                    None, causal, q_gs, k_start)
                dq[:, :, rows] += dq_p
                dkh = dkh + dk_p
                dvh = dvh + dv_p
            state[sign] = (kh, vh, dkh, dvh)
        if hop != n - 1:
            if fused:
                state = {sign: tuple(kv_ahead[sign].wait()) + tuple(ring_pass((s[2], s[3]), group, sign))
                         for sign, s in state.items()}
            else:
                state = {sign: tuple(ring_pass(s, group, sign)) for sign, s in state.items()}

    # after hop n−1 each half belongs to rank (rank + sign) mod n: one more
    # rotation in the same direction lands every accumulator on its owner
    homed = {sign: ring_pass((s[2], s[3]), group, sign) for sign, s in state.items()}
    order = [sign for _, _, sign in halves]  # row order: forward half first
    dk = torch.cat([homed[s][0] for s in order], dim=2)
    dv = torch.cat([homed[s][1] for s in order], dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, layout, fused):
        out, lse = _ring_fwd_pass(q, k, v, group, causal, layout, fused)
        out = out.to(q.dtype)
        # residuals are this rank's RESIDENTS only: O(S/cp)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, layout, fused)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, group, causal: bool = True, layout: str = "contiguous",
                   fused: str | None = "env"):
    """Exact attention over a sequence sharded across ``group`` (a
    ``RingGroup``): q/k/v are this rank's shard [batch, heads, S/cp,
    head_dim]. ``fused`` picks the hop schedule: ``"env"`` (default) reads
    ``DSML_RING_FUSED`` (:func:`ring_fused_mode`), ``None``/"off" rotates
    after each hop, ``"sendahead"`` before it, ``"dma"`` through the fused
    kernel. ``layout="zigzag"`` reads each rank's rows as its two stripes
    (:func:`zigzag_indices`; even per-rank length). Differentiable; a group
    of one (or ``None``) is single-device flash attention."""
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    if fused == "env":
        fused = ring_fused_mode()
    elif fused in ("off", "none", "0"):
        fused = None
    if fused not in (None, "sendahead", "dma"):
        raise ValueError(f"fused must be None, 'sendahead' or 'dma', got {fused!r}")
    if group is None or group.size == 1:
        return flash_attention(q, k, v, causal)
    if layout == "zigzag" and q.shape[2] % 2:
        raise ValueError(f"zigzag needs an even per-rank length, got {q.shape[2]}")
    return _Ring.apply(q, k, v, group, causal, layout, fused)


def ring_kv_wire_bytes(s_local: int, n_ranks: int, n_heads: int, head_dim: int, batch: int = 1,
                       itemsize: int = 4, bidirectional: bool = True,
                       backward: bool = False) -> int:
    """EXACT per-rank wire bytes of one ring-attention call. Forward: n−1
    hops, each moving this rank's resident K and V halves. Backward: the
    same K/V re-stream with f32 dk/dv riding along, plus the final homing
    hop of the accumulators. Causal skipping saves math only: every block
    still tours the ring."""
    if n_ranks <= 1:
        return 0
    h0 = (s_local + 1) // 2
    halves = [x for x in ((h0, s_local - h0) if bidirectional else (s_local,)) if x]
    rows = batch * n_heads * head_dim
    kv_hop = sum(2 * rows * x * itemsize for x in halves)  # k + v
    if not backward:
        return (n_ranks - 1) * kv_hop
    dkv_hop = sum(2 * rows * x * 4 for x in halves)  # f32 dk + dv
    return (n_ranks - 1) * (kv_hop + dkv_hop) + dkv_hop


def causal_keep_fraction(n_ranks: int, layout: str = "contiguous") -> float:
    """MEAN fraction of the hop grid causal skipping still executes:
    (n+1)/(2n) contiguous, (2n+1)/(4n) zigzag."""
    n = int(n_ranks)
    if n <= 1:
        return 1.0
    if layout == "zigzag":
        return (2 * n + 1) / (4 * n)
    return (n + 1) / (2 * n)


def causal_critical_path_fraction(n_ranks: int, layout: str = "contiguous") -> float:
    """The SLOWEST rank's executed fraction: 1.0 contiguous (rank n−1 runs
    its whole grid), the mean (2n+1)/(4n) zigzag."""
    n = int(n_ranks)
    if n <= 1:
        return 1.0
    if layout == "zigzag":
        return (2 * n + 1) / (4 * n)
    return 1.0
