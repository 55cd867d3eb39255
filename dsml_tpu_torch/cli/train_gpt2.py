"""Train GPT-2 on byte tokens on one device — the single-device path of
``examples/train_gpt2.py``.

Tokens are the bytes of ``--data FILE`` or, without one, of a generated
story corpus (simple grammatical sentences, so the loss measures sequence
structure, not noise). Each optimizer step draws ``--batch_size`` random
windows (``lm_window_batches`` behind ``prefetch_batches``), splits them
into ``--grad_accum`` microbatches whose gradients are summed and averaged,
clips by global norm (optax's rule) and applies AdamW on a warmup-cosine
schedule. Every ``--log_every`` steps it logs "step N: loss = L, T
tokens/s".

    python -m dsml_tpu_torch.cli.train_gpt2 --device cpu --model tiny --steps 3
    python -m dsml_tpu_torch.cli.train_gpt2 --model small --attn flash --dtype bfloat16 \\
        --steps 50 --grad_accum 1

Runs on the CUDA card unless ``--device cpu``. Pipeline, tensor, sequence
and context parallelism, Llama, BPE, the prose corpus, checkpoints,
profiles and adafactor come with later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class GPT2TrainConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    model: str = field("tiny", help="GPT-2 preset: tiny | small (124M) | medium | large | xl")
    family: str = field("gpt2", help="model family: gpt2 (llama: a later slice)")
    dtype: str = field("", help="params/activations dtype: float32 | bfloat16 ('' = model default)")
    remat: bool = field(False, help="rematerialize each block's activations in backward (less memory, more FLOPs)")
    data: str = field("", help="UTF-8 text file to train on; '' = generated stories ('prose': a later slice)")
    tokenizer: str = field("", help="'' = byte-level (vocab 256); 'bpe': a later slice")
    bpe_vocab: int = field(2048, help="BPE vocab size (with --tokenizer bpe)")
    steps: int = field(50, help="optimizer steps")
    batch_size: int = field(8, help="GLOBAL batch size (rows per optimizer step)")
    seq_len: int = field(0, help="sequence length (0 = model max)")
    grad_accum: int = field(2, help="gradient-accumulation microbatches per step")
    pp: int = field(1, help="pipeline-parallel stages (model-parallel slice)")
    schedule: str = field("gpipe", help="pipeline schedule (pp > 1)")
    n_micro: int = field(2, help="pipeline microbatches per step (pp > 1)")
    dp: int = field(0, help="data-parallel size (0 = this device)")
    sp: int = field(1, help="sequence-parallel size (long-context slice)")
    cp: int = field(1, help="context-parallel size (long-context slice)")
    tp: int = field(1, help="tensor-parallel size (model-parallel slice)")
    attn: str = field("", help="attention impl: flash | xla ('' = plain attention, what the JAX example runs on one device)")
    lr: float = field(3e-4, help="peak learning rate")
    optimizer: str = field("adamw", help="adamw (adafactor: a later slice)")
    clip_norm: float = field(1.0, help="global-norm gradient clip (0 = off)")
    warmup_steps: int = field(10, help="linear warmup steps")
    seed: int = field(0, help="init/data seed")
    log_every: int = field(10, help="log every N steps")
    eval_every: int = field(0, help="held-out loss every N steps (0 = off)")
    profile_dir: str = field("", help="profiler trace directory (a later slice)")
    checkpoint_dir: str = field("", help="checkpoint directory (checkpointing slice)")


_WORDS = {
    "subj": ["the cat", "a dog", "the girl", "a boy", "the robot", "her friend"],
    "verb": ["found", "chased", "painted", "built", "lost", "shared"],
    "obj": ["a ball", "the kite", "a tiny boat", "the red box", "a shiny coin"],
    "end": ["and smiled.", "and ran home.", "by the river.", "under the tree."],
}


def _generated_stories(n_chars: int, seed: int) -> bytes:
    """TinyStories-shaped filler: the JAX example's generator, byte for
    byte."""
    rng = np.random.default_rng(seed)
    parts = []
    size = 0
    while size < n_chars:
        s = (
            f"{rng.choice(_WORDS['subj'])} {rng.choice(_WORDS['verb'])} "
            f"{rng.choice(_WORDS['obj'])} {rng.choice(_WORDS['end'])} "
        )
        parts.append(s)
        size += len(s)
    return "".join(parts).encode()


def _check_supported(cfg: GPT2TrainConfig) -> None:
    later = {
        "--pp/--tp > 1 (the model-parallel slice)": cfg.pp > 1 or cfg.tp > 1,
        "--sp/--cp > 1 (the long-context slice)": cfg.sp > 1 or cfg.cp > 1,
        "--dp > 1 (the data-parallel slice)": cfg.dp > 1,
        "--family llama (the Llama slice)": cfg.family == "llama",
        "--tokenizer bpe (a later slice, with utils/tokenizer.py)": cfg.tokenizer == "bpe",
        "--data prose (a later slice: the corpus reads the JAX package's docstrings)": cfg.data == "prose",
        "--checkpoint_dir (the checkpointing slice)": bool(cfg.checkpoint_dir),
        "--profile_dir (a later slice, with utils/tracing.py)": bool(cfg.profile_dir),
        "--optimizer adafactor (a later slice)": cfg.optimizer == "adafactor",
    }
    for what, asked in later.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet")
    if cfg.family != "gpt2":
        raise SystemExit(f"unknown --family {cfg.family!r} (gpt2 | llama)")
    if cfg.tokenizer:
        raise SystemExit(f"unknown --tokenizer {cfg.tokenizer!r} (use '' or 'bpe')")
    if cfg.optimizer != "adamw":
        raise SystemExit(f"unknown --optimizer {cfg.optimizer!r} (adamw | adafactor)")
    if cfg.attn not in ("", "flash", "xla"):
        raise SystemExit(f"--attn {cfg.attn!r}: this port runs flash | xla on one device")


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: scale every gradient by
    ``max_norm / norm`` only when the global norm exceeds ``max_norm``
    (``t / norm * max_norm``, in the gradient's type; no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). No host sync. Returns the norm."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def train_step(model, optimizer, lr: float, x: torch.Tensor, y: torch.Tensor,
               grad_accum: int = 1, clip_norm: float = 0.0, attn_impl: str = "xla") -> torch.Tensor:
    """One optimizer step on the batch ``x``/``y`` [b, s], as the JAX
    hybrid step takes it: the gradients of ``grad_accum`` equal
    microbatches summed and divided by ``grad_accum``, clipped by global
    norm when ``clip_norm > 0``, then ``optimizer`` at learning rate
    ``lr``. Returns the mean loss (a device scalar, not synced)."""
    micro = x.shape[0] // grad_accum
    optimizer.zero_grad(set_to_none=True)
    loss = 0.0
    for m in range(grad_accum):
        sl = slice(m * micro, (m + 1) * micro)
        micro_loss = model.loss(x[sl], y[sl], attn_impl=attn_impl)
        micro_loss.backward()
        loss = loss + micro_loss.detach()
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]]
    if grad_accum > 1:
        torch._foreach_div_(grads, grad_accum)
    if clip_norm > 0:
        clip_by_global_norm(grads, clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return loss / grad_accum


def main(argv=None) -> dict:
    cfg = GPT2TrainConfig.parse_args(argv)
    _check_supported(cfg)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.utils.data import carve_lm_eval_split, lm_window_batches, prefetch_batches
    from dsml_tpu_torch.utils.logging import get_logger
    from dsml_tpu_torch.utils.schedules import make_schedule

    log = get_logger("gpt2")
    if cfg.batch_size % cfg.grad_accum:
        raise SystemExit(
            f"batch_size={cfg.batch_size} must be divisible by grad_accum={cfg.grad_accum}"
        )
    try:
        model, model_cfg = model_by_family("gpt2", cfg.model, device=cfg.device, vocab_size=256)
    except ValueError as e:
        raise SystemExit(str(e))
    replace = {}
    if cfg.dtype:
        replace["dtype"] = cfg.dtype
    if cfg.remat:
        replace["remat"] = True
    if replace:
        model_cfg = dataclasses.replace(model_cfg, **replace)
        model = type(model)(model_cfg, device=cfg.device)
    model.init(cfg.seed)
    seq = cfg.seq_len or model_cfg.max_seq
    attn_impl = cfg.attn or "xla"

    if cfg.data:
        if not os.path.exists(cfg.data):
            raise FileNotFoundError(f"--data {cfg.data!r} does not exist ('' = generated stories)")
        with open(cfg.data, "rb") as f:
            corpus = f.read()
        log.info("training on %s (%d bytes)", cfg.data, len(corpus))
    else:
        need = cfg.steps * cfg.batch_size * (seq + 1) * 2
        corpus = _generated_stories(max(need, 1 << 20), cfg.seed)
        log.info("no --data file; generated %d bytes of story corpus", len(corpus))
    tokens = np.frombuffer(corpus, np.uint8).astype(np.int32) % model_cfg.vocab_size
    eval_tokens = None
    if cfg.eval_every:
        tokens, eval_tokens = carve_lm_eval_split(tokens, seq, cfg.batch_size)
        if eval_tokens is None:
            log.warning("corpus (%d tokens) too small to carve an eval split at seq=%d; "
                        "eval disabled", len(tokens), seq)

    # the same pieces as the JAX example's optax.chain(clip_by_global_norm,
    # adamw(schedule)): adamw's default weight decay there is 1e-4
    schedule = make_schedule("cosine", cfg.lr, cfg.steps, cfg.warmup_steps)
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-4)
    log.info("GPT-2 %s on %s: %.1fM params, %s, attn=%s, seq=%d, batch=%d x accum=%d",
             cfg.model, model.device, model.n_params() / 1e6, model_cfg.dtype, attn_impl, seq,
             cfg.batch_size, cfg.grad_accum)

    def device_batch(x, y):
        return (torch.as_tensor(x).to(model.device).long(),
                torch.as_tensor(y).to(model.device).long())

    if eval_tokens is not None:
        eval_x, eval_y = device_batch(*next(lm_window_batches(eval_tokens, seq, cfg.batch_size,
                                                              seed=1234)))
    batches = prefetch_batches(lm_window_batches(tokens, seq, cfg.batch_size, seed=cfg.seed))
    t0 = time.monotonic()
    tokens_done = 0
    first_loss = loss = None
    for i in range(1, cfg.steps + 1):
        x, y = device_batch(*next(batches))
        loss = train_step(model, optimizer, schedule(i - 1), x, y, cfg.grad_accum,
                          cfg.clip_norm, attn_impl)
        tokens_done += x.numel()
        if first_loss is None:
            first_loss = float(loss)
        if i % cfg.log_every == 0 or i == cfg.steps:
            loss_f = float(loss)
            tps = tokens_done / max(time.monotonic() - t0, 1e-9)
            log.info("step %d: loss = %.4f, %.0f tokens/s", i, loss_f, tps)
        if eval_tokens is not None and (i % cfg.eval_every == 0 or i == cfg.steps):
            with torch.no_grad():
                el = float(model.loss(eval_x, eval_y, attn_impl=attn_impl))
            log.info("step %d: eval loss = %.4f, perplexity = %.2f", i, el, float(np.exp(el)))
    return {"first_loss": first_loss, "last_loss": float(loss)}


if __name__ == "__main__":
    main()
