"""Sample text from a byte-tokenised GPT-2 or Llama with fresh weights — the
port's counterpart of ``examples/generate_text.py``: one prefill (through
the flash kernel once the prompt reaches 512 tokens on the card), then the
KV-cache decode loop, then the continuations printed one per line.

    python -m dsml_tpu_torch.cli.generate_text --model small --prompt "the cat " \\
        --prompt_len 512 --max_new_tokens 32 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --family llama --model tinyllama_1b \\
        --max_new_tokens 8 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --family llama --model tinyllama_1b --tp 2 \\
        --max_new_tokens 8 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --device cpu --model tiny --max_new_tokens 4

``--checkpoint_dir DIR`` serves the parameters of the newest step there (a
``train_gpt2`` run of either package, of the same ``--family`` and
``--model``: a weights-only partial restore) instead of fresh weights.

``--tp N`` serves tensor-parallel, as the JAX example's ``--tp``: it spawns N
ranks (one process each, joined over a ``MeshSpec(tp=N)`` mesh through a
rendezvous file in a temporary directory; rank r runs on ``cuda:{r %
device_count}``, so ranks share a card when there are fewer cards), each
holding its Megatron shard of the weights (drawn from the same seed, or
restored from ``--checkpoint_dir``) and running ``GPT2.generate_spmd``.
Rank 0 prints; the continuations equal ``--tp 1``'s on the same device.
The model's heads and vocabulary must divide by N (GPT-2's 50257 does not).

Runs on the CUDA card unless ``--device cpu``. BPE prompts come with a
later slice; speculative decoding is ``cli/decode_speculative.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class GenerateConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    family: str = field("gpt2", help="model family: gpt2 | llama")
    model: str = field("tiny", help="preset (gpt2: tiny|small|medium|large|xl; llama: tiny|tinyllama_1b|llama2_7b|llama3_8b|mixtral_8x7b)")
    prompt: str = field("the cat ", help="prompt text (byte-tokenised)")
    prompt_len: int = field(0, help="repeat the prompt up to this many tokens (0 = as given; >= 512 reaches the flash kernel on the card)")
    n_samples: int = field(2, help="continuations to sample (the batch)")
    max_new_tokens: int = field(64, help="tokens (bytes) to generate per sample")
    temperature: float = field(0.8, help="0 = greedy")
    top_k: int = field(32, help="0 = full distribution")
    top_p: float = field(0.0, help="nucleus sampling mass (0 = off)")
    checkpoint_dir: str = field("", help="train_gpt2 checkpoint directory to serve ('' = fresh weights)")
    seed: int = field(0, help="seed of the fresh weights and of the sampler")
    eos: int = field(-1, help="stop token id (-1 = none); rows pad with it after stopping")
    tp: int = field(1, help="tensor-parallel serving: spawns this many ranks, each holding its shard of heads, vocab and KV cache (generate_spmd); rank 0 prints")


def main(argv=None) -> list[str]:
    cfg = GenerateConfig.parse_args(argv)
    if not cfg.prompt:
        raise SystemExit("--prompt must be non-empty")
    if cfg.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {cfg.tp}")
    if cfg.tp > 1:
        return _spawn(cfg)
    return _generate(cfg)


def _spawn(cfg: GenerateConfig) -> list[str]:
    """Run the ``--tp`` ranks of :func:`_rank` and return rank 0's
    continuations; a rank that raises fails the run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dsml_ranks_") as tmp:
        mp.spawn(_rank, args=(cfg, tmp), nprocs=cfg.tp, join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            return json.load(f)


def _rank(rank: int, cfg: GenerateConfig, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from dsml_tpu_torch.utils.logging import get_logger

    # rank r on cuda:{r % device_count}: a placement, never a CPU fallback
    device = "cpu" if torch.device(cfg.device).type == "cpu" else None
    mesh = build_mesh(MeshSpec(tp=cfg.tp), rank, cfg.tp, os.path.join(tmp, "rendezvous"), device)
    get_logger("generate").info("tp rank %d of %d on %s", rank, cfg.tp, mesh.device)
    try:
        texts = _generate(cfg, mesh)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(texts, f)
    finally:
        mesh.close()
        dist.destroy_process_group()


def _generate(cfg: GenerateConfig, mesh=None) -> list[str]:
    """The continuations on one device, or as one rank of a tp ``mesh``
    (rank 0 logs and prints)."""
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.utils.logging import get_logger

    log = get_logger("generate")
    quiet = mesh is not None and mesh.rank != 0
    try:
        # tiny = byte tokens; the other presets keep GPT-2's vocabulary
        model, model_cfg = model_by_family(cfg.family, cfg.model,
                                           device=cfg.device if mesh is None else "meta",
                                           **({"vocab_size": 256} if cfg.model == "tiny" else {}))
        if mesh is not None:
            model = type(model)(model_cfg, device=mesh.device, tp_group=mesh.group("tp"))
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.checkpoint_dir:
        from dsml_tpu_torch.checkpoint.optim_state import restore_params
        from dsml_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(cfg.checkpoint_dir)
        try:
            restore_params(ckpt, model)  # a shard keeps its blocks of the whole arrays
        finally:
            ckpt.close()
        if not quiet:
            log.info("loaded checkpoint from %s", cfg.checkpoint_dir)
    else:
        model.init(cfg.seed)
    ids = np.frombuffer(cfg.prompt.encode(), np.uint8).astype(np.int64) % model_cfg.vocab_size
    if cfg.prompt_len:
        ids = np.resize(ids, cfg.prompt_len)  # repeats the prompt up to the length
    prompt = np.tile(ids, (cfg.n_samples, 1))
    if not quiet:
        log.info("%s-%s on %s%s: batch %d, prompt %d tokens, %d new", cfg.family, cfg.model,
                 model.device, "" if mesh is None else f" (tp = {cfg.tp})", cfg.n_samples,
                 prompt.shape[1], cfg.max_new_tokens)
    kwargs = dict(temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p, seed=cfg.seed,
                  eos_id=None if cfg.eos < 0 else cfg.eos)
    if mesh is None:
        out = model.generate(prompt, cfg.max_new_tokens, **kwargs)
    else:
        out = model.generate_spmd(prompt, cfg.max_new_tokens, mesh, **kwargs)
    texts = []
    for row in out.cpu().numpy():
        text = bytes(int(t) % 256 for t in row).decode("utf-8", errors="replace")
        texts.append(text)
        if not quiet:
            print(f"{cfg.prompt!r} -> {text!r}", flush=True)
    return texts


if __name__ == "__main__":
    main()
