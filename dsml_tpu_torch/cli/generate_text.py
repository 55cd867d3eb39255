"""Sample text from a byte-tokenised GPT-2 or Llama with fresh weights — the
port's counterpart of ``examples/generate_text.py``: one prefill (through
the flash kernel once the prompt reaches 512 tokens on the card), then the
KV-cache decode loop, then the continuations printed one per line.

    python -m dsml_tpu_torch.cli.generate_text --model small --prompt "the cat " \\
        --prompt_len 512 --max_new_tokens 32 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --family llama --model tinyllama_1b \\
        --max_new_tokens 8 --temperature 0
    python -m dsml_tpu_torch.cli.generate_text --device cpu --model tiny --max_new_tokens 4

``--checkpoint_dir DIR`` serves the parameters of the newest step there (a
``train_gpt2`` run of either package, of the same ``--family`` and
``--model``: a weights-only partial restore) instead of fresh weights.

Runs on the CUDA card unless ``--device cpu``. BPE prompts and
tensor-parallel serving come with later slices; speculative decoding is
``cli/decode_speculative.py``.
"""

from __future__ import annotations

import dataclasses

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


def main(argv=None) -> list[str]:
    cfg = GenerateConfig.parse_args(argv)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.utils.logging import get_logger

    log = get_logger("generate")
    if not cfg.prompt:
        raise SystemExit("--prompt must be non-empty")
    try:
        # tiny = byte tokens; the other presets keep GPT-2's vocabulary
        model, model_cfg = model_by_family(cfg.family, cfg.model, device=cfg.device,
                                           **({"vocab_size": 256} if cfg.model == "tiny" else {}))
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.checkpoint_dir:
        from dsml_tpu_torch.checkpoint.optim_state import load_param_tree, param_tree
        from dsml_tpu_torch.utils.checkpoint import Checkpointer

        # every parameter is restored: the module's own tensors are the template
        ckpt = Checkpointer(cfg.checkpoint_dir)
        try:
            state = ckpt.restore(template={"params": param_tree(model)}, partial=True)
        finally:
            ckpt.close()
        load_param_tree(model, state["params"])
        log.info("loaded checkpoint from %s", cfg.checkpoint_dir)
    else:
        model.init(cfg.seed)
    ids = np.frombuffer(cfg.prompt.encode(), np.uint8).astype(np.int64) % model_cfg.vocab_size
    if cfg.prompt_len:
        ids = np.resize(ids, cfg.prompt_len)  # repeats the prompt up to the length
    prompt = np.tile(ids, (cfg.n_samples, 1))
    log.info("%s-%s on %s: batch %d, prompt %d tokens, %d new", cfg.family, cfg.model, model.device,
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
