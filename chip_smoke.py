"""Smoke test of the PyTorch/CUDA port (``dsml_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dsml_tpu_torch/ops/csrc/`` with
``nvcc``, holds each against its plain PyTorch version at the shapes its
path gives it, then drives the port's two paths and checks that each went
through its kernels:

- serving: ``GPT2.generate`` on GPT-2-small (124M, vocab 50257) in bf16
  with weights from seed 0, batch 8, a 512-token prompt and 32 greedy
  tokens (the prefill's attention is the flash forward kernel);
- training: GPT-2-small bf16 train steps at batch 8 × 1024,
  ``GPT2.loss(attn_impl="flash")`` with dense logits, ``backward()`` and
  AdamW(3e-4, weight_decay=0.01) — the JAX bench's headline step — through
  the flash forward and both backward kernels.

Each phase prints one JSON line; a phase that fails ends the run with a
non-zero exit and no result line. The line before the last is the card's
name and power limit as ``nvidia-smi`` prints them; the last line is
``{"ok": true, "device": {...}}``.

Phases: device, build, kernel (flash_fwd against ``_flash_fwd_reference``
at b=8, h=12, d=64, s=512 and a ragged s=700, bf16 and f32, causal and not,
plus an offset case; times of the kernel, the plain version and, as a
yardstick the port never calls, ``F.scaled_dot_product_attention``),
kernel_bwd (flash_bwd_dq and flash_bwd_dkv against ``_flash_bwd_reference``
at [96, 1024, 64], a ragged s=700, an offset case and d=128, bf16 and f32,
causal and not, with and without an lse cotangent; times of each kernel,
the plain backward and SDPA's backward), slice (the generate run, its
launch counts, bf16 prefill logits against the plain attention prefill, f32
greedy tokens of the kernel run against the plain run), trace (device-busy
time of a prefill, a decode step and a train step from a profiler trace),
cli (``dsml_tpu_torch.cli.generate_text`` once), train (the train steps,
their launch counts, step ms, tokens/s and MFU, a falling loss, and f32
gradients of the kernel path against the plain-attention path), train_cli
(``dsml_tpu_torch.cli.train_gpt2`` for 4 steps and the MNIST ``Trainer``
for one epoch), kernels (one line for the whole run).

Float32 matmuls stay in full f32 (TF32 off, PyTorch's default, set here
explicitly): the f32 phases compare two paths at f32 tolerances.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# card peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, device-memory bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel against its plain version on the same inputs. f32: both sum in f32
# in another order. bf16: both compute in f32 from the same bf16 inputs; out
# is rounded to bf16 on both sides (one bf16 ulp at |out| < 4 is <= 1/64)
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4}, torch.bfloat16: {"out": 2e-2, "lse": 1e-3}}
# prefill logits, kernel path against the plain-attention path. f32: the
# JAX suite's tolerance for the same comparison. bf16: the plain path rounds
# scores, probabilities and the attention output to bf16 in every layer,
# the kernel only its output; over 12 layers that is a few bf16 ulps of a
# logit of magnitude 2-4 (ulp 1/64). A wrong mask or a dropped tile moves
# the logits by O(1).
TOL_LOGITS = {torch.float32: 2e-4, torch.bfloat16: 1e-1}
MARGIN = 1e-3  # f32 greedy: below this top-2 margin a step compares logits, not tokens

B, H, D, S = 8, 12, 64, 512  # GPT-2-small's prefill attention shape in the slice
NEW_TOKENS = 32
F32_TOKENS = 8

# the backward kernels against their plain version, as a share of the
# largest |gradient| of the tensor compared. f32: both sum in f32 in
# another order. bf16: both compute in f32 from the same bf16 inputs and
# round the result to bf16 (one bf16 ulp is at most 2^-7 of the largest
# entry)
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_B, TRAIN_S = 8, 1024  # the JAX bench's GPT-2-small train step
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# f32 gradients, flash kernels against plain attention, as a share of each
# tensor's largest |gradient|: f32 sums in another order through 12 layers
# (a dropped tile or a wrong mask moves them by O(1))
TOL_TRAIN_GRADS = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(bh, s_q, s_kv, d, dtype, causal, q_start=0, k_start=0):
    """Least time for one flash forward: the larger of its bytes (q, k, v
    read once, out and the f32 lse written once) over the memory rate and
    its operations (2·d multiply-adds per kept score in each of q·kᵀ and
    p·v, counting only the scores the mask keeps) over the peak rate of the
    inputs' type. Returns (ms, "bytes" | "operations")."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = bh * (s_q * d * 2 + s_kv * d * 2) * elt + bh * s_q * 4
    rows = q_start + np.arange(s_q) - k_start + 1
    kept = np.clip(rows, 0, s_kv).sum() if causal else s_q * s_kv
    flops = 4.0 * d * bh * float(kept)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_bound_ms(bh, s_q, s_kv, d, dtype, causal, products, n_out):
    """Least time for one backward kernel: the larger of its bytes (q, k, v
    and do read once, the f32 lse and delta read once, ``n_out`` gradient
    tensors of the inputs' shape written once) over the memory rate and its
    operations (``products`` products of 2·d operations per kept score)
    over the peak rate of the inputs' type."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (bh * (2 * s_q * d + 2 * s_kv * d) * elt + bh * s_q * 4 * 2
              + n_out * bh * s_kv * d * elt)
    rows = np.arange(s_q) + 1
    kept = np.clip(rows, 0, s_kv).sum() if causal else s_q * s_kv
    flops = products * 2.0 * d * bh * float(kept)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_bwd(tflash, dev):
    """flash_bwd_dq and flash_bwd_dkv against _flash_bwd_reference, then
    their times at the train step's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bh_train = TRAIN_B * H

    def inputs(bh, s_q, s_kv, d, dtype, q_start, causal, glse):
        q, do = (torch.randn(bh, s_q, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, s_kv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        out, lse = tflash._flash_fwd_reference(q, k, v, causal, q_start, 0)
        g_lse = torch.randn(bh, s_q, generator=gen, device=dev) if glse else None
        return q, k, v, out, lse, do, g_lse

    cases = [  # (bh, s_q, s_kv, d, q_start, causal, with an lse cotangent)
        (bh_train, TRAIN_S, TRAIN_S, D, 0, True, False), (bh_train, TRAIN_S, TRAIN_S, D, 0, False, True),
        (bh_train, 700, 700, D, 0, True, True), (bh_train, 700, 700, D, 0, False, False),
        (bh_train, 256, 512, D, 256, True, True), (16, TRAIN_S, TRAIN_S, 128, 0, True, True),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for bh, s_q, s_kv, d, q_start, causal, glse in cases:
            args = inputs(bh, s_q, s_kv, d, dtype, q_start, causal, glse)
            got = tflash.flash_bwd(*args, causal, q_start, 0)
            torch.cuda.synchronize()
            want = tflash._flash_bwd_reference(*args, causal, q_start, 0)
            errs, rel = {}, 0.0
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                errs[name] = err
                rel = max(rel, err / max(w.float().abs().max().item(), 1e-30))
            ok = (all(g.shape == a.shape and g.dtype == dtype for g, a in zip(got, args[:3]))
                  and all(bool(torch.isfinite(g).all()) for g in got) and rel <= TOL_BWD[dtype])
            emit({"phase": "kernel_bwd", "kernels": ["flash_bwd_dq", "flash_bwd_dkv"],
                  "dtype": str(dtype)[6:], "bh": bh, "s_q": s_q, "s_kv": s_kv, "d": d,
                  "q_start": q_start, "causal": causal, "g_lse": glse, "max_abs_err": errs,
                  "max_err_over_max_abs": rel, "tol": TOL_BWD[dtype], "ok": ok})
            check(ok, f"flash_bwd disagrees with its plain version ({dtype}, s_q={s_q}, "
                      f"s_kv={s_kv}, d={d}, q_start={q_start}, causal={causal}, g_lse={glse})")
            if (dtype, s_q, d, causal) == (torch.bfloat16, TRAIN_S, D, True):
                main_err = errs

    # times at the train step's shape: bf16 [96, 1024, 64], causal, no lse cotangent
    q, k, v, out, lse, do, _ = inputs(bh_train, TRAIN_S, TRAIN_S, D, torch.bfloat16, 0, True, False)
    reps = 10
    per_kernel = device_kernel_ms(lambda: [tflash.flash_bwd(q, k, v, out, lse, do) for _ in range(reps)])
    ms = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        found = [t / reps for k_name, t in per_kernel.items() if f"{name}_kernel" in k_name]
        check(len(found) == 1, f"the profiler trace shows no single {name} kernel: {sorted(per_kernel)}")
        ms[name] = found[0]
    wrapper_ms = cuda_ms(lambda: tflash.flash_bwd(q, k, v, out, lse, do))
    plain_ms = cuda_ms(lambda: tflash._flash_bwd_reference(q, k, v, out, lse, do))
    q4, k4, v4, do4 = (t.view(TRAIN_B, H, TRAIN_S, D).detach().requires_grad_() for t in (q, k, v, do))

    def sdpa(backward):
        o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        if backward:
            torch.autograd.grad(o, (q4, k4, v4), do4)

    library_ms = cuda_ms(lambda: sdpa(True)) - cuda_ms(lambda: sdpa(False))
    timing = {}
    for name, products, n_out in (("flash_bwd_dq", 3, 1), ("flash_bwd_dkv", 4, 2)):
        bound_ms, bound_by = backward_bound_ms(bh_train, TRAIN_S, TRAIN_S, D, torch.bfloat16,
                                               True, products, n_out)
        timing[name] = {"ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "kernel_time", "kernels": ["flash_bwd_dq", "flash_bwd_dkv"],
          "shape": [bh_train, TRAIN_S, D], "dtype": "bfloat16", "causal": True,
          "flash_bwd_ms": wrapper_ms, "plain_note": "plain_ms and library_ms are whole backwards "
          "(dq, dk and dv); library_ms is SDPA forward+backward minus forward", **timing})
    return main_err, timing


def phase_kernel(tflash, dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(bh, s_q, s_kv, d, dtype):
        return [torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
                for s in (s_q, s_kv, s_kv)]

    cases = [(S, S, 0, True), (S, S, 0, False), (700, 700, 0, True), (700, 700, 0, False),
             (256, 512, 256, True)]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for s_q, s_kv, q_start, causal in cases:
            for d, bh in ((D, B * H), (128, 16)) if (s_q, causal) == (S, True) else ((D, B * H),):
                q, k, v = qkv(bh, s_q, s_kv, d, dtype)
                out, lse = tflash.flash_fwd(q, k, v, causal, q_start, 0)
                torch.cuda.synchronize()
                ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, causal, q_start, 0)
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse = (lse - ref_lse).abs().max().item()
                tol = TOL[dtype]
                ok = (out.shape == q.shape and out.dtype == dtype and lse.shape == (bh, s_q)
                      and bool(torch.isfinite(out).all()) and err_out <= tol["out"]
                      and err_lse <= tol["lse"])
                emit({"phase": "kernel", "kernel": "flash_fwd", "dtype": str(dtype)[6:],
                      "bh": bh, "s_q": s_q, "s_kv": s_kv, "d": d, "q_start": q_start,
                      "causal": causal, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                      "tol_out": tol["out"], "tol_lse": tol["lse"], "ok": ok})
                check(ok, f"flash_fwd disagrees with its plain version ({dtype}, s_q={s_q}, "
                          f"s_kv={s_kv}, d={d}, q_start={q_start}, causal={causal})")
                if (dtype, s_q, d, causal) == (torch.bfloat16, S, D, True):
                    main_err = err_out

    # times at the prefill's shape: bf16 [b·h, 512, 64], causal
    q, k, v = qkv(B * H, S, S, D, torch.bfloat16)
    q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
    ms = cuda_ms(lambda: tflash.flash_fwd(q, k, v, True))
    plain_ms = cuda_ms(lambda: tflash._flash_fwd_reference(q, k, v, True))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(B * H, S, S, D, torch.bfloat16, True)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel_time", "kernel": "flash_fwd", "shape": [B * H, S, D],
          "dtype": "bfloat16", "causal": True, **timing})
    return main_err, timing


def greedy_trace(model, prompt, n, forced=None):
    """Greedy tokens [b, n] and f32 logits [b, n, vocab] from prefill and
    decode steps; the steps after the first are fed ``forced``'s tokens when
    given (teacher forcing), else the run's own."""
    logits, cache = model.prefill(prompt)
    toks, logs = [], []
    for i in range(n):
        logs.append(logits.float())
        toks.append(logits.argmax(-1))
        if i + 1 < n:
            feed = toks[-1] if forced is None else forced[:, i]
            logits, cache = model.decode_step(cache, feed, prompt.shape[1] + i)
    return torch.stack(toks, 1), torch.stack(logs, 1)


def phase_slice(tflash, dev, card):
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    model = GPT2(cfg, device=dev).init(0)
    prompt_np = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    prompt = torch.as_tensor(prompt_np, device=dev)
    model.generate(prompt, 2)  # warm-up: cuBLAS handles, the kernel's library
    torch.cuda.synchronize()

    # the main path, counted
    tflash.flash_fwd_launches = 0
    t0 = time.perf_counter()
    out = model.generate(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = tflash.flash_fwd_launches
    check(launches == cfg.n_layer,
          f"flash_fwd launched {launches} times in one generate, expected n_layer={cfg.n_layer}")
    check(out.shape == (B, NEW_TOKENS) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"generate returned {tuple(out.shape)} tokens in [{int(out.min())}, {int(out.max())}]")

    prefill_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_flash, _ = model.prefill(prompt)
        torch.cuda.synchronize()
        prefill_times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(prefill_times)
    decode_ms = (generate_ms - prefill_ms) / (NEW_TOKENS - 1)

    # bf16 prefill logits: kernel path against the plain-attention path,
    # and both against the f32 model from the same seed
    model._prefill_use_flash = lambda t: False
    logits_plain, _ = model.prefill(prompt)
    del model._prefill_use_flash
    err_bf16 = (logits_flash.float() - logits_plain.float()).abs().max().item()
    finite = bool(torch.isfinite(logits_flash).all())
    check(finite and logits_flash.shape == (B, cfg.vocab_size), "bf16 prefill logits")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = GPT2(cfg32, device=dev).init(0)
    logits32_flash, _ = model32.prefill(prompt)
    model32._prefill_use_flash = lambda t: False
    toks_plain, logs_plain = greedy_trace(model32, prompt, F32_TOKENS)
    logits32_plain = logs_plain[:, 0]
    del model32._prefill_use_flash
    toks_kernel, logs_kernel = greedy_trace(model32, prompt, F32_TOKENS, forced=toks_plain)
    err_f32 = (logits32_flash - logits32_plain).abs().max().item()
    err_vs_f32 = {"flash_bf16": (logits_flash.float() - logits32_plain).abs().max().item(),
                  "plain_bf16": (logits_plain.float() - logits32_plain).abs().max().item()}

    near_ties, mismatches = [], 0
    top2 = logs_plain.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # [b, n]
    for row, step in zip(*torch.nonzero(toks_kernel != toks_plain, as_tuple=True)):
        row, step = int(row), int(step)
        m = margin[row, step].item()
        if m < MARGIN:
            gap = (logs_kernel[row, step] - logs_plain[row, step]).abs().max().item()
            near_ties.append({"row": row, "step": step, "margin": m, "max_abs_err_logits": gap})
            mismatches += gap > TOL_LOGITS[torch.float32]
        else:
            mismatches += 1
    emit({"phase": "slice", "model": "gpt2-small", "params": sum(p.numel() for p in model.parameters()),
          "dtype": "bfloat16", "batch": B, "prompt": S, "new_tokens": NEW_TOKENS,
          "flash_fwd_launches": launches, "n_layer": cfg.n_layer,
          "prefill_ms": prefill_ms, "generate_ms": generate_ms,
          "decode_ms_per_token": decode_ms, "decode_tokens_per_s": B * 1e3 / decode_ms,
          "prefill_logits_max_abs_err_bf16": err_bf16, "tol_bf16": TOL_LOGITS[torch.bfloat16],
          "prefill_logits_max_abs_err_vs_f32_plain": err_vs_f32,
          "prefill_logits_max_abs_err_f32": err_f32, "tol_f32": TOL_LOGITS[torch.float32],
          "f32_greedy_tokens_equal": bool(torch.equal(toks_kernel, toks_plain)),
          "f32_near_ties": near_ties, "card": card})
    check(err_bf16 <= TOL_LOGITS[torch.bfloat16],
          f"bf16 prefill logits: kernel vs plain max abs err {err_bf16}")
    check(err_f32 <= TOL_LOGITS[torch.float32],
          f"f32 prefill logits: kernel vs plain max abs err {err_f32}")
    check(mismatches == 0, f"f32 greedy tokens: {mismatches} steps differ beyond the margin rule")
    return launches, model, prompt


def device_kernel_ms(fn) -> dict[str, float]:
    """{kernel name: device ms} of the kernels ``fn`` launches, summed from
    a ``torch.profiler`` trace; empty where the trace holds no device
    events. Names are cut to 80 characters, which sums the instances of one
    template (PyTorch's elementwise kernels) under one name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:80]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def device_busy_ms(fn):
    """(device ms, {kernel name: ms} of the 6 costliest) of the kernels
    ``fn`` launches (kernels of one stream do not overlap); (None, {})
    where the trace holds no device events."""
    by_name = device_kernel_ms(fn)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return (sum(by_name.values()) if by_name else None), top


def phase_trace(model, prompt):
    """Where a prefill and a decode step spend their time: device-busy ms
    from a profiler trace against the wall ms of the same call untraced."""
    logits, cache = model.prefill(prompt)
    tok = logits.argmax(-1)
    calls = {"prefill": lambda: model.prefill(prompt),
             "decode_step": lambda: model.decode_step(cache, tok, S)}
    row = {"phase": "trace"}
    for name, fn in calls.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        busy, top = device_busy_ms(fn)
        row[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "device_idle_share": None if busy is None else 1 - busy / wall,
                     "top_kernels_ms": top}
    emit(row)


def train_counts(tflash):
    return {"flash_fwd": tflash.flash_fwd_launches, "flash_bwd_dq": tflash.flash_bwd_dq_launches,
            "flash_bwd_dkv": tflash.flash_bwd_dkv_launches}


def reset_counts(tflash):
    tflash.flash_fwd_launches = tflash.flash_bwd_dq_launches = tflash.flash_bwd_dkv_launches = 0


def phase_train(tflash, dev, card):
    """The train step on GPT-2-small bf16 at batch 8 × 1024 (flash
    attention, dense logits, AdamW(3e-4, weight_decay=0.01)) on one batch
    repeated: launch counts, step time, tokens/s, MFU and a falling loss;
    then f32 gradients of the kernel path against the plain-attention
    path at batch 2."""
    from dsml_tpu_torch.models.common import transformer_train_flops
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = GPT2(cfg, device=dev).init(0)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, attn_impl="flash")
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted
    reset_counts(tflash)
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = train_counts(tflash)
    losses = torch.stack(losses).float().tolist()
    flops = transformer_train_flops(cfg, TRAIN_B * TRAIN_S, TRAIN_S)
    row = {"phase": "train", "model": "gpt2-small", "params": model.n_params(), "dtype": "bfloat16",
           "batch": TRAIN_B, "seq": TRAIN_S, "attn_impl": "flash", "xent_chunk": 0,
           "optimizer": "AdamW(3e-4, weight_decay=0.01)", "steps": TRAIN_STEPS,
           "launches": counts, "step_ms": step_ms,
           "tokens_per_s": TRAIN_B * TRAIN_S * 1e3 / step_ms, "model_flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "card": card}
    want = cfg.n_layer * TRAIN_STEPS
    check(all(n == want for n in counts.values()),
          f"train steps launched {counts}, expected {want} of each ({cfg.n_layer} per step)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train loss not finite and falling on a repeated batch: {losses}")

    # f32, batch 2: gradients through the kernels against plain attention
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = GPT2(cfg32, device=dev).init(0)
    grads = {}
    for impl in ("flash", "xla"):
        model32.zero_grad(set_to_none=True)
        model32.loss(x[:2], y[:2], attn_impl=impl).backward()
        grads[impl] = {n: p.grad.detach().clone() for n, p in model32.named_parameters()}
    worst, worst_name = 0.0, None
    for name, g in grads["xla"].items():
        rel = (grads["flash"][name] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, worst_name = rel, name
    row.update({"f32_grads_max_err_over_max_abs": worst, "f32_grads_worst_tensor": worst_name,
                "tol_f32_grads": TOL_TRAIN_GRADS})
    emit(row)
    check(worst <= TOL_TRAIN_GRADS,
          f"f32 gradients: flash kernels vs plain attention {worst} of max |g| in {worst_name}")
    del model32, grads
    return counts, step


def phase_train_trace(step):
    """Where a train step spends its time: device-busy ms from a profiler
    trace against the wall ms of untraced steps."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    by_name = device_kernel_ms(step)
    busy = sum(by_name.values()) if by_name else None
    by_kind = {"flash": 0.0, "gemm": 0.0, "elementwise_reduce": 0.0, "other": 0.0}
    for name, t in by_name.items():
        kind = ("flash" if "flash_" in name else
                "gemm" if any(w in name for w in ("gemm", "nvjet", "cutlass")) else
                "elementwise_reduce" if any(w in name for w in ("elementwise", "reduce", "vectorized"))
                else "other")
        by_kind[kind] += t
    emit({"phase": "trace", "train_step": {
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall, "by_kind_ms": by_kind,
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])}})


def phase_train_cli(tflash):
    """The training entry points: cli.train_gpt2 on GPT-2-small bf16 with
    the flash kernels, and the MNIST Trainer for one epoch."""
    from dsml_tpu_torch.cli import train_gpt2
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils.data import load_mnist

    reset_counts(tflash)
    out = train_gpt2.main(["--model", "small", "--attn", "flash", "--dtype", "bfloat16",
                           "--steps", "4", "--batch_size", "8", "--grad_accum", "1",
                           "--log_every", "1", "--warmup_steps", "1"])
    counts = train_counts(tflash)
    ok_cli = all(n == 4 * 12 for n in counts.values()) and np.isfinite(out["last_loss"])
    data = load_mnist(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mnist"))
    t0 = time.perf_counter()
    _, history, test_acc = Trainer(MLP(device="cuda"), TrainConfig(epochs=1)).train(data)
    mnist_s = time.perf_counter() - t0
    emit({"phase": "train_cli", "entry": "python -m dsml_tpu_torch.cli.train_gpt2", **out,
          "launches": counts, "mnist_trainer": {"epochs": 1, "n_train": data.n_train,
                                                "avg_loss": history[0]["avg_loss"],
                                                "test_accuracy": test_acc, "seconds": mnist_s}})
    check(ok_cli, f"the train_gpt2 entry point: launches {counts}, result {out}")
    check(np.isfinite(history[0]["avg_loss"]) and test_acc > 0.5,
          f"the MNIST trainer: loss {history[0]['avg_loss']}, test accuracy {test_acc}")


def phase_cli(tflash):
    from dsml_tpu_torch.cli import generate_text

    tflash.flash_fwd_launches = 0
    texts = generate_text.main(["--model", "small", "--prompt_len", "512", "--n_samples", "2",
                                "--max_new_tokens", "4", "--temperature", "0"])
    launches = tflash.flash_fwd_launches
    emit({"phase": "cli", "entry": "python -m dsml_tpu_torch.cli.generate_text",
          "continuations": len(texts), "flash_fwd_launches": launches})
    check(len(texts) == 2 and launches == 12, "the generate_text entry point")


def main() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke test needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dsml_tpu_torch.ops import _build
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.utils.platform import card_name_and_power_limit, resolve_device

    dev = resolve_device("cuda:0")
    card = card_name_and_power_limit()
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "sources": sorted(reports), "seconds": time.perf_counter() - t0,
          "ptxas": {name: [line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line]
                    for name, log in reports.items()}})

    main_err, timing = phase_kernel(tflash, dev)
    bwd_err, bwd_timing = phase_kernel_bwd(tflash, dev)
    launches, model, prompt = phase_slice(tflash, dev, card)
    phase_trace(model, prompt)
    del model
    phase_cli(tflash)
    train_launches, step = phase_train(tflash, dev, card)
    phase_train_trace(step)
    del step
    torch.cuda.empty_cache()
    phase_train_cli(tflash)

    bwd_source = "dsml_tpu_torch/ops/csrc/flash_bwd.cu"
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "dsml_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "dsml_tpu/ops/flash.py:198", "launches": launches,
         "max_abs_err": main_err, **timing},
        {"name": "flash_bwd_dq", "route": "cuda", "source": bwd_source,
         "replaces": "dsml_tpu/ops/flash.py:481", "launches": train_launches["flash_bwd_dq"],
         "max_abs_err": bwd_err["dq"], **bwd_timing["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": bwd_source,
         "replaces": "dsml_tpu/ops/flash.py:526", "launches": train_launches["flash_bwd_dkv"],
         "max_abs_err": max(bwd_err["dk"], bwd_err["dv"]), **bwd_timing["flash_bwd_dkv"]},
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
