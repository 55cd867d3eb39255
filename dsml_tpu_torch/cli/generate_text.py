"""Sample text from a byte-tokenised GPT-2 with fresh weights — the port's
counterpart of ``examples/generate_text.py``: one prefill (through the flash
kernel once the prompt reaches 512 tokens on the card), then the KV-cache
decode loop, then the continuations printed one per line.

    python -m dsml_tpu_torch.cli.generate_text --model small --prompt "the cat " \\
        --prompt_len 512 --max_new_tokens 32 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --device cpu --model tiny --max_new_tokens 4

Runs on the CUDA card unless ``--device cpu``. Checkpoints, BPE prompts,
speculative decoding and tensor-parallel serving come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class GenerateConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    model: str = field("tiny", help="GPT-2 preset: tiny|small|medium|large|xl")
    prompt: str = field("the cat ", help="prompt text (byte-tokenised)")
    prompt_len: int = field(0, help="repeat the prompt up to this many tokens (0 = as given; >= 512 reaches the flash kernel on the card)")
    n_samples: int = field(2, help="continuations to sample (the batch)")
    max_new_tokens: int = field(64, help="tokens (bytes) to generate per sample")
    temperature: float = field(0.8, help="0 = greedy")
    top_k: int = field(32, help="0 = full distribution")
    top_p: float = field(0.0, help="nucleus sampling mass (0 = off)")
    seed: int = field(0, help="seed of the fresh weights and of the sampler")
    eos: int = field(-1, help="stop token id (-1 = none); rows pad with it after stopping")


def main(argv=None) -> list[str]:
    cfg = GenerateConfig.parse_args(argv)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.utils.logging import get_logger

    log = get_logger("generate")
    if not cfg.prompt:
        raise SystemExit("--prompt must be non-empty")
    try:
        # tiny = byte tokens; the other presets keep GPT-2's vocabulary
        model, model_cfg = model_by_family("gpt2", cfg.model, device=cfg.device,
                                           **({"vocab_size": 256} if cfg.model == "tiny" else {}))
    except ValueError as e:
        raise SystemExit(str(e))
    model.init(cfg.seed)
    ids = np.frombuffer(cfg.prompt.encode(), np.uint8).astype(np.int64) % model_cfg.vocab_size
    if cfg.prompt_len:
        ids = np.resize(ids, cfg.prompt_len)  # repeats the prompt up to the length
    prompt = np.tile(ids, (cfg.n_samples, 1))
    log.info("gpt2-%s on %s: batch %d, prompt %d tokens, %d new", cfg.model, model.device,
             cfg.n_samples, prompt.shape[1], cfg.max_new_tokens)
    out = model.generate(
        prompt, cfg.max_new_tokens, temperature=cfg.temperature, top_k=cfg.top_k,
        top_p=cfg.top_p, seed=cfg.seed, eos_id=None if cfg.eos < 0 else cfg.eos,
    )
    texts = []
    for row in out.cpu().numpy():
        text = bytes(int(t) % 256 for t in row).decode("utf-8", errors="replace")
        texts.append(text)
        print(f"{cfg.prompt!r} -> {text!r}")
    return texts


if __name__ == "__main__":
    main()
