"""Train GPT-2 or Llama on byte tokens — ``examples/train_gpt2.py`` on one
device or on a pp × dp × fsdp × (sp or cp) × tp mesh.

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
    python -m dsml_tpu_torch.cli.train_gpt2 --model small --cp 2 --dtype bfloat16 --steps 4
    python -m dsml_tpu_torch.cli.train_gpt2 --model small --dp 2 --attn flash --dtype bfloat16 \\
        --steps 4 --grad_accum 1
    python -m dsml_tpu_torch.cli.train_gpt2 --family llama --model tinyllama_1b --attn flash \\
        --dtype bfloat16 --steps 3 --batch_size 2 --grad_accum 1
    python -m dsml_tpu_torch.cli.train_gpt2 --family llama --model tinyllama_1b --tp 2 \\
        --attn flash --dtype bfloat16 --steps 3 --batch_size 2 --grad_accum 1
    python -m dsml_tpu_torch.cli.train_gpt2 --model small --pp 2 --schedule 1f1b --n_micro 4 \\
        --attn flash --dtype bfloat16 --steps 3 --batch_size 8 --grad_accum 1
    python -m dsml_tpu_torch.cli.train_gpt2 --model small --sp 2 --attn ulysses_flash \\
        --dtype bfloat16 --steps 3 --grad_accum 1
    python -m dsml_tpu_torch.cli.train_gpt2 --family llama --model tinyllama_1b --cp 2 --tp 2 \\
        --dtype bfloat16 --steps 3 --batch_size 2 --grad_accum 1

``--dp N``, ``--fsdp N``, ``--sp N``, ``--cp N``, ``--tp N`` or ``--pp N``
spawns one rank (``torch.multiprocessing``) per mesh position, joined over
gloo through a rendezvous file in a temporary directory; they run
``parallel.hybrid.make_hybrid_train_step``: with ``--dp`` each rank trains
on its rows of the global batch and the gradients are averaged through the
process group's own ``all_reduce`` (``dp_sync="xla"``, as the JAX example);
with ``--fsdp`` the rows split further and each rank holds ZeRO-3 shards of
the weights; with ``--sp`` or ``--cp`` (one of the two) the sequence is
sharded over the sequence ring, attention ``--attn`` routed as the JAX
model routes it (``ring`` | ``ring2`` | ``ulysses`` | ``ulysses_flash`` |
``ring_flash``; ``flash`` and ``xla`` take the XLA ring there; the default
is ``ring2`` with ``--cp``, ``ring`` otherwise); with ``--tp`` each rank
holds its Megatron shard of the model; with ``--pp`` its pipeline stage,
running ``--schedule gpipe|1f1b`` over ``--n_micro`` microbatches (lowered
to the largest count that divides a rank's rows, with a note, as the JAX
example does). Every axis composes with the others. Rank r runs on
``cuda:{r % device_count}`` (logged per rank: with fewer cards than ranks,
ranks share a card), or on the CPU with ``--device cpu``. Rank 0 logs the
steps; a failing rank fails the run.

``--checkpoint_dir DIR`` resumes from the newest step there (the
parameters and the optimizer's state in the JAX package's trees, so a
checkpoint of ``examples/train_gpt2.py`` resumes here and the reverse),
runs ``--steps`` more updates on the cosine horizon ``start + steps`` with
the batch stream seeded ``seed + start``, and saves step ``start +
steps`` at the end. On a mesh every rank saves and restores its own
blocks of the JAX ``init_hybrid`` tree (``checkpoint.optim_state.
mesh_state``: tp and fsdp shards, the stacked pp layer axis, the rest
replicated over dp and the sequence axis; the lowest rank holding a block
writes it), and all ranks wait for the commit.
``--eval_every K`` logs the held-out loss and perplexity every K steps on
every mesh (under ``--pp`` the pipelined forward over ``--n_micro``
microbatches).

Runs on the CUDA card unless ``--device cpu``. BPE, the prose corpus,
profiles and adafactor come with later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from dsml_tpu_torch.models.gpt2 import GPT2
from dsml_tpu_torch.utils.config import Config, field


# the optax state of the JAX example's optax.chain(clip or identity, adamw)
OPT_STATE_KIND = "clip_adamw"


@dataclasses.dataclass
class GPT2TrainConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    model: str = field("tiny", help="gpt2 family: tiny | small (124M) | medium | large | xl; llama family: tiny | tinyllama_1b | llama2_7b | llama3_8b | mixtral_8x7b")
    family: str = field("gpt2", help="model family: gpt2 | llama (RMSNorm/RoPE/SwiGLU/GQA)")
    dtype: str = field("", help="params/activations dtype: float32 | bfloat16 ('' = model default)")
    remat: bool = field(False, help="rematerialize each block's activations in backward (less memory, more FLOPs)")
    data: str = field("", help="UTF-8 text file to train on; '' = generated stories ('prose': a later slice)")
    tokenizer: str = field("", help="'' = byte-level (vocab 256); 'bpe': a later slice")
    bpe_vocab: int = field(2048, help="BPE vocab size (with --tokenizer bpe)")
    steps: int = field(50, help="optimizer steps")
    batch_size: int = field(8, help="GLOBAL batch size (rows per optimizer step)")
    seq_len: int = field(0, help="sequence length (0 = model max)")
    grad_accum: int = field(2, help="gradient-accumulation microbatches per step")
    pp: int = field(1, help="pipeline-parallel stages: spawns this many ranks per dp x tp position")
    schedule: str = field("gpipe", help="pipeline schedule (pp > 1): gpipe | 1f1b")
    n_micro: int = field(2, help="pipeline microbatches per step (pp > 1)")
    dp: int = field(0, help="data-parallel size: spawns this many ranks (0 or 1 = this device)")
    fsdp: int = field(1, help="ZeRO-3 size: the rows split further, the weights sharded over this many ranks")
    sp: int = field(1, help="sequence-parallel size (the XLA ring's axis): spawns this many ranks per position")
    cp: int = field(1, help="context-parallel size (the flash ring's axis): spawns this many ranks per position")
    tp: int = field(1, help="tensor-parallel size: spawns this many ranks per dp x pp position")
    attn: str = field("", help="attention impl: ring | ring2 | ulysses | ulysses_flash | ring_flash | flash | xla ('' = plain attention on one device, ring2 on cp meshes, ring otherwise, as the JAX example)")
    lr: float = field(3e-4, help="peak learning rate")
    optimizer: str = field("adamw", help="adamw (adafactor: a later slice)")
    clip_norm: float = field(1.0, help="global-norm gradient clip (0 = off)")
    warmup_steps: int = field(10, help="linear warmup steps")
    seed: int = field(0, help="init/data seed")
    log_every: int = field(10, help="log every N steps")
    eval_every: int = field(0, help="held-out loss every N steps (0 = off)")
    profile_dir: str = field("", help="profiler trace directory (a later slice)")
    checkpoint_dir: str = field("", help="checkpoint directory: resume from its newest step, save at the end ('' = none)")


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
        "--tokenizer bpe (a later slice, with utils/tokenizer.py)": cfg.tokenizer == "bpe",
        "--data prose (a later slice: the corpus reads the JAX package's docstrings)": cfg.data == "prose",
        "--profile_dir (a later slice, with utils/tracing.py)": bool(cfg.profile_dir),
        "--optimizer adafactor (a later slice)": cfg.optimizer == "adafactor",
    }
    for what, asked in later.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet")
    if cfg.family not in ("gpt2", "llama"):
        raise SystemExit(f"unknown --family {cfg.family!r} (gpt2 | llama)")
    if cfg.tokenizer:
        raise SystemExit(f"unknown --tokenizer {cfg.tokenizer!r} (use '' or 'bpe')")
    if cfg.optimizer != "adamw":
        raise SystemExit(f"unknown --optimizer {cfg.optimizer!r} (adamw | adafactor)")
    if cfg.attn and cfg.attn not in GPT2._ATTN_IMPLS:
        raise SystemExit(f"--attn {cfg.attn!r}: choose from {' | '.join(GPT2._ATTN_IMPLS)}")
    if cfg.sp > 1 and cfg.cp > 1:
        raise SystemExit(f"--sp {cfg.sp} and --cp {cfg.cp}: pick ONE sequence ring")
    if cfg.schedule not in ("gpipe", "1f1b"):
        raise SystemExit(f"unknown --schedule {cfg.schedule!r} (gpipe | 1f1b)")


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
    rows = max(cfg.dp, 1) * cfg.fsdp  # the batch rows split over dp × fsdp
    if cfg.batch_size % (cfg.grad_accum * rows):
        raise SystemExit(
            f"batch_size={cfg.batch_size} must be divisible by grad_accum*dp*fsdp="
            f"{cfg.grad_accum * rows}"
        )
    if cfg.pp > 1:
        rows_per_rank = cfg.batch_size // (cfg.grad_accum * rows)
        n_micro = cfg.n_micro
        while rows_per_rank % n_micro:
            n_micro -= 1  # largest feasible microbatch count ≥ 1
        if n_micro != cfg.n_micro:
            print(f"note: n_micro={cfg.n_micro} does not divide the {rows_per_rank} "
                  f"rows per dp rank; using n_micro={n_micro}")
            cfg = dataclasses.replace(cfg, n_micro=n_micro)
    if _mesh_spec(cfg).n_devices > 1:
        return _spawn(cfg)
    return _train(cfg)


def _mesh_spec(cfg: GPT2TrainConfig):
    from dsml_tpu_torch.parallel.mesh import MeshSpec

    return MeshSpec(pp=cfg.pp, dp=max(cfg.dp, 1), fsdp=cfg.fsdp, sp=cfg.sp, cp=cfg.cp, tp=cfg.tp)


def _spawn(cfg: GPT2TrainConfig) -> dict:
    """Run the mesh's ranks of :func:`_rank` and return rank 0's result; a
    rank that raises fails the run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dsml_ranks_") as tmp:
        mp.spawn(_rank, args=(cfg, tmp), nprocs=_mesh_spec(cfg).n_devices, join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            return json.load(f)


def _rank(rank: int, cfg: GPT2TrainConfig, tmp: str) -> None:
    import torch.distributed as dist

    from dsml_tpu_torch.parallel.mesh import build_mesh
    from dsml_tpu_torch.utils.logging import get_logger

    # rank r on cuda:{r % device_count}: a placement, never a CPU fallback
    device = "cpu" if torch.device(cfg.device).type == "cpu" else None
    spec = _mesh_spec(cfg)
    world = spec.n_devices
    if device == "cpu":
        # the ranks share the host: each takes an equal part of half its
        # cores (more threads a rank starve gloo's transport threads)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    mesh = build_mesh(spec, rank, world, os.path.join(tmp, "rendezvous"), device)
    axes = " x ".join(a for a, n in mesh.shape.items() if n > 1)
    get_logger("gpt2").info("%s rank %d of %d on %s", axes, rank, world, mesh.device)
    try:
        out = _train(cfg, mesh)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        mesh.close()
        dist.destroy_process_group()


def _train(cfg: GPT2TrainConfig, mesh=None) -> dict:
    """The training loop on one device, or as one rank of ``mesh`` (the
    hybrid step on its mesh; rank 0 logs)."""
    from dsml_tpu_torch.checkpoint.optim_state import (load_mesh_state, load_optax_state,
                                                       load_param_tree, mesh_state, optax_state,
                                                       param_tree)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.utils.data import carve_lm_eval_split, lm_window_batches, prefetch_batches
    from dsml_tpu_torch.utils.logging import get_logger
    from dsml_tpu_torch.utils.schedules import make_schedule

    log = get_logger("gpt2")
    quiet = mesh is not None and mesh.rank != 0
    device = cfg.device if mesh is None else mesh.device
    try:
        model, model_cfg = model_by_family(cfg.family, cfg.model, device="meta", vocab_size=256)
    except ValueError as e:
        raise SystemExit(str(e))
    replace = {}
    if cfg.dtype:
        replace["dtype"] = cfg.dtype
    if cfg.remat:
        replace["remat"] = True
    model_cfg = dataclasses.replace(model_cfg, **replace)
    if mesh is not None:
        from dsml_tpu_torch.parallel.hybrid import hybrid_model

        model = hybrid_model(type(model), model_cfg, mesh)  # this rank's tp shard / pp stage
    else:
        model = type(model)(model_cfg, device=device)
    seq = cfg.seq_len or model_cfg.max_seq

    if cfg.data:
        if not os.path.exists(cfg.data):
            raise FileNotFoundError(f"--data {cfg.data!r} does not exist ('' = generated stories)")
        with open(cfg.data, "rb") as f:
            corpus = f.read()
        if not quiet:
            log.info("training on %s (%d bytes)", cfg.data, len(corpus))
    else:
        need = cfg.steps * cfg.batch_size * (seq + 1) * 2
        corpus = _generated_stories(max(need, 1 << 20), cfg.seed)
        if not quiet:
            log.info("no --data file; generated %d bytes of story corpus", len(corpus))
    tokens = np.frombuffer(corpus, np.uint8).astype(np.int32) % model_cfg.vocab_size
    eval_tokens = None
    if cfg.eval_every:
        tokens, eval_tokens = carve_lm_eval_split(tokens, seq, cfg.batch_size)
        if eval_tokens is None:
            log.warning("corpus (%d tokens) too small to carve an eval split at seq=%d; "
                        "eval disabled", len(tokens), seq)

    # probe the checkpoint FIRST: a resumed update count sits at start_step,
    # so the cosine horizon must cover start_step + cfg.steps
    ckpt = None
    start_step = 0
    if cfg.checkpoint_dir:
        from dsml_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(cfg.checkpoint_dir, mesh=mesh)
        start_step = ckpt.latest_step() or 0
    if start_step == 0:  # a resume restores every weight: no draw to overwrite
        model.init(cfg.seed)
    # the same pieces as the JAX example's optax.chain(clip_by_global_norm,
    # adamw(schedule)): adamw's default weight decay there is 1e-4
    schedule = make_schedule("cosine", cfg.lr, start_step + cfg.steps, cfg.warmup_steps)
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-4)
    if mesh is not None:
        from dsml_tpu_torch.parallel.hybrid import shard_fsdp

        model, optimizer = shard_fsdp(model, optimizer, mesh)  # ZeRO-3 shards under --fsdp
    count = 0  # updates done: the schedule's argument

    def state_tree(n: int) -> dict:
        """The checkpointed trees after ``n`` updates (this rank's blocks
        on a mesh)."""
        if mesh is not None:
            return mesh_state(model, optimizer, mesh, OPT_STATE_KIND, n)
        return {"params": param_tree(model),
                "opt_state": optax_state(optimizer, model, OPT_STATE_KIND, n)}

    if start_step > 0:
        state = ckpt.restore(template=state_tree(0))
        if mesh is not None:
            count = load_mesh_state(model, optimizer, mesh, OPT_STATE_KIND, state)
        else:
            load_param_tree(model, state["params"])
            count = load_optax_state(optimizer, model, OPT_STATE_KIND, state["opt_state"])
        if not quiet:
            log.info("resumed from checkpoint at step %d", start_step)
    if mesh is None:
        attn_impl = cfg.attn or "xla"

        def run_step(lr, x, y):
            return train_step(model, optimizer, lr, x, y, cfg.grad_accum, cfg.clip_norm, attn_impl)

        def eval_loss(x, y):
            return model.loss(x, y, attn_impl=attn_impl)
    else:
        from dsml_tpu_torch.parallel.hybrid import (default_attn_impl, hybrid_eval_loss,
                                                    make_hybrid_train_step)

        attn_impl = cfg.attn or default_attn_impl(mesh)
        hybrid_step = make_hybrid_train_step(model, optimizer, mesh, attn_impl=attn_impl,
                                             grad_accum=cfg.grad_accum, clip_norm=cfg.clip_norm,
                                             n_microbatches=cfg.n_micro, schedule=cfg.schedule)

        def run_step(lr, x, y):
            return hybrid_step(x, y, lr)

        def eval_loss(x, y):
            return hybrid_eval_loss(model, mesh, attn_impl, x, y, cfg.n_micro)
    if not quiet:
        log.info("%s %s on %s: %.1fM params, %s, attn=%s, seq=%d, batch=%d x accum=%d%s",
                 "Llama" if cfg.family == "llama" else "GPT-2", cfg.model, model.device,
                 model.n_params() / 1e6, model_cfg.dtype, attn_impl, seq, cfg.batch_size,
                 cfg.grad_accum,
                 "" if mesh is None else ", " + ", ".join(
                     f"{a}={n}" for a, n in mesh.shape.items() if n > 1 or a == "dp")
                 + (" (params: this rank's shard)" if model.is_partial else ""))

    def device_batch(x, y):
        # the hybrid step takes the global batch and moves only its own share
        dev = model.device if mesh is None else "cpu"
        return torch.as_tensor(x).to(dev).long(), torch.as_tensor(y).to(dev).long()

    if eval_tokens is not None:
        eval_x, eval_y = device_batch(*next(lm_window_batches(eval_tokens, seq, cfg.batch_size,
                                                              seed=1234)))
    # the stream moves on past what the earlier run consumed
    batches = prefetch_batches(lm_window_batches(tokens, seq, cfg.batch_size,
                                                 seed=cfg.seed + start_step))
    t0 = time.monotonic()
    tokens_done = 0
    first_loss = loss = None
    for i in range(1, cfg.steps + 1):
        x, y = device_batch(*next(batches))
        loss = run_step(schedule(count), x, y)
        count += 1
        tokens_done += x.numel()
        if first_loss is None:
            first_loss = float(loss)
        if (i % cfg.log_every == 0 or i == cfg.steps) and not quiet:
            loss_f = float(loss)
            tps = tokens_done / max(time.monotonic() - t0, 1e-9)
            log.info("step %d: loss = %.4f, %.0f tokens/s", i, loss_f, tps)
        if eval_tokens is not None and (i % cfg.eval_every == 0 or i == cfg.steps):
            with torch.no_grad():
                el = float(eval_loss(eval_x, eval_y))
            if not quiet:
                log.info("step %d: eval loss = %.4f, perplexity = %.2f", i, el, float(np.exp(el)))
    if ckpt is not None:
        ckpt.save(start_step + cfg.steps, **state_tree(count))
        ckpt.close()
    return {"first_loss": first_loss, "last_loss": float(loss)}


if __name__ == "__main__":
    main()
