"""Speculative decoding with prompt-lookup (n-gram) drafting — the
counterpart of ``dsml_tpu/models/speculative.py``.

Greedy KV-cache decode emits one token per model call. Speculative decoding
scores a WINDOW of C candidate tokens in one call (``model.verify_step``,
the multi-query decode of chunked prefill) and accepts the longest prefix
that matches the model's own greedy choices, so one call can yield up to C
tokens. The draft comes from prompt lookup: the tokens that followed the
most recent earlier occurrence of the history's trailing n-gram (no draft
model).

Token-level guarantee: greedy speculative output equals plain greedy
``generate``. Verify feeds [last_accepted, d_1..d_{C-1}] at positions
p..p+C-1; g_i = argmax(logits[i]) is the greedy continuation after window
token i; d_{i+1} is accepted iff it equals g_i and every earlier draft was
accepted; the first mismatch emits g_acc, the model's own token. Rejected
drafts leave K/V rows past the accepted prefix, which the next window (it
starts at the first such row and is as long) overwrites before any query
reads them.

The JAX package runs the whole loop inside one ``lax.while_loop``. Here the
loop runs on the host, one verify call an iteration, with the drafting,
acceptance and history update on the device (:func:`lookup_draft_batch`
over the history buffer); the loop's condition reads one scalar back from
the device before each iteration, the loop's only host sync, counted in
``stats["host_syncs"]``. The continuous batcher's speculative tick drafts
on the host through :func:`lookup_draft_host`, the same rule.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate_speculative", "lookup_draft_host", "lookup_draft_batch"]


def lookup_draft_host(history: np.ndarray, n: int, k: int) -> np.ndarray:
    """Prompt-lookup draft on the host (numpy): the ``k`` tokens that
    followed the most recent earlier occurrence of ``history``'s trailing
    n-gram; the last token repeated when there is none (acceptance then
    falls to the one-token floor: a wrong draft costs speed, never
    tokens). The window that is the trailing gram itself is excluded;
    windows overlapping it are not (``j + n - 1 < len - 1``), the device
    rule's ``j + n - 1 < pos``."""
    history = np.asarray(history)
    length = len(history)
    n = min(n, length)
    gram = history[length - n:]
    win = np.lib.stride_tricks.sliding_window_view(history, n)  # [L-n+1, n]
    matches = np.flatnonzero(np.all(win[: length - n] == gram, axis=1))
    if len(matches) == 0:
        return np.full(k, history[-1], np.int32)
    best = int(matches[-1])
    src = history[best + n : best + n + k].astype(np.int32)
    if len(src) < k:  # a match near the end: pad with the last token
        src = np.concatenate([src, np.full(k - len(src), history[-1], np.int32)])
    return src


def lookup_draft_batch(hbuf: torch.Tensor, pos: torch.Tensor, window: int,
                       ngram: int) -> torch.Tensor:
    """Prompt-lookup draft on the device: for each row of ``hbuf`` [b,
    max_seq] whose last accepted token sits at ``pos[b]``, the ``window - 1``
    tokens that followed the most recent match of the trailing
    ``ngram``-gram strictly inside the accepted history (``j + ngram - 1 <
    pos``); no match repeats the last token. A follower past ``pos`` (a
    match near the end) reads the last accepted token instead, as the host
    rule pads. Returns [b, window - 1] in ``hbuf``'s type."""
    b, max_seq = hbuf.shape
    n, c = ngram, window
    dev = hbuf.device
    jidx = torch.arange(max_seq - n + 1, device=dev)
    # gram[b] = hbuf[b, pos-n+1 .. pos] (the start clamped as lax.dynamic_slice clamps it)
    start = (pos - (n - 1)).clamp(0, max_seq - n)
    gram = hbuf.gather(1, start[:, None] + torch.arange(n, device=dev))  # [b, n]
    match = torch.ones((b, max_seq - n + 1), dtype=torch.bool, device=dev)
    for i in range(n):  # n is 2-3: shifted equalities, no gather
        match &= hbuf[:, i: max_seq - n + 1 + i] == gram[:, i: i + 1]
    legal = jidx[None, :] <= pos[:, None] - n
    best = torch.where(match & legal, jidx[None, :], -1).amax(1)  # [b]
    found = best >= 0
    src = best[:, None] + n + torch.arange(c - 1, device=dev)[None, :]
    src = torch.where(src <= pos[:, None], src, pos[:, None])
    draft = hbuf.gather(1, src)
    return torch.where(found[:, None], draft, gram[:, -1:])


def generate_speculative(
    model,
    prompt,  # [b, t] integer ids (tensor or numpy)
    max_new_tokens: int,
    window: int = 8,
    ngram: int = 2,
    return_calls: bool = False,
    stats: dict | None = None,
):
    """Greedy decode through prompt-lookup speculative decoding: tokens [b,
    max_new_tokens] int64 equal to ``model.generate(prompt, max_new_tokens)``
    at temperature 0, in fewer model calls whenever the generated text
    revisits earlier spans.

    ``window`` — tokens scored per verify call (1 committed + window−1
    drafted); ``ngram`` — the lookup's match length (2-3).
    ``return_calls=True`` also returns the number of verify calls (plain
    greedy decode makes ``max_new_tokens`` model calls). ``stats``, when
    given a dict, receives ``n_calls`` and ``host_syncs`` (the loop
    condition's read-backs: ``n_calls + 1``).

    Requires ``t >= ngram`` and ``t + max_new_tokens + window <= max_seq``
    (the verify window of a just-finishing row stays inside the cache)."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, t = prompt.shape
    model._check_generate_args(t, max_new_tokens, 0.0, 0, 0.0)
    if window < 2:
        raise ValueError(f"window must be >= 2 (1 real + >=1 draft), got {window}")
    if ngram < 1 or t < ngram:
        raise ValueError(f"need prompt_len ({t}) >= ngram ({ngram}) >= 1")
    max_seq = model.config.max_seq
    if t + max_new_tokens + window > max_seq:
        raise ValueError(
            f"prompt ({t}) + max_new ({max_new_tokens}) + window ({window}) "
            f"must fit max_seq={max_seq} (the final verify "
            "window writes cache rows past the last emitted token)"
        )
    dev, c = model.device, window
    with torch.no_grad():
        # the history buffer: the prompt, then each ACCEPTED token at its
        # position; the output is hbuf[:, t : t + max_new]
        hbuf = torch.zeros((b, max_seq), dtype=torch.long, device=dev)
        hbuf[:, :t] = prompt
        logits0, cache = model.prefill(prompt, last_index=t - 1)
        hbuf[:, t] = logits0.argmax(-1)
        pos = torch.full((b,), t, dtype=torch.long, device=dev)  # the last accepted token
        n_gen = torch.ones((b,), dtype=torch.long, device=dev)
        i_idx = torch.arange(c, device=dev)[None, :]
        calls = syncs = 0
        while True:
            syncs += 1
            if int(n_gen.min()) >= max_new_tokens:
                break
            draft = lookup_draft_batch(hbuf, pos, c, ngram)
            last = hbuf.gather(1, pos[:, None])
            logits, cache = model.verify_step(cache, torch.cat([last, draft], 1), pos)
            g = logits.argmax(-1)  # [b, C]
            # accepted: the longest prefix of drafts on the greedy chain
            acc = torch.cumprod((draft == g[:, : c - 1]).long(), 1).sum(1)
            vshift = torch.cat([draft, torch.zeros_like(draft[:, :1])], 1)
            emit = torch.where(i_idx < acc[:, None], vshift,
                               torch.where(i_idx == acc[:, None], g.gather(1, acc[:, None]), 0))
            # rows that reached max_new freeze: their writes land past the
            # output and their position stops
            adv = torch.minimum(acc + 1, (max_new_tokens - n_gen).clamp_min(0))
            hbuf.scatter_(1, pos[:, None] + 1 + i_idx, emit)
            pos, n_gen = pos + adv, n_gen + adv
            calls += 1
    if stats is not None:
        stats.update(n_calls=calls, host_syncs=syncs)
    tokens = hbuf[:, t: t + max_new_tokens]
    return (tokens, calls) if return_calls else tokens
