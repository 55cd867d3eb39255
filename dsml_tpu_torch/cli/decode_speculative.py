"""Speculative decoding demo: prompt-lookup drafts and multi-query verify —
the port's counterpart of ``examples/decode_speculative.py``.

Runs greedy decode twice on the same prompt, plain ``generate`` and
``models.speculative.generate_speculative``, checks that the tokens are
identical, and logs each one's wall time and tokens/s, the tokens per
verify call (plain greedy decode makes one token per model call) and the
speculative loop's host syncs. The prompt repeats a block, the regime
prompt lookup exploits; a model with fresh weights also emits repetitive
text, so drafts land even at tiny scale.

    python -m dsml_tpu_torch.cli.decode_speculative --device cpu --model tiny
    python -m dsml_tpu_torch.cli.decode_speculative --family llama --model tinyllama_1b

Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class SpecConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    family: str = field("gpt2", help="model family: gpt2 | llama")
    model: str = field("tiny", help="model preset (tiny for the demo)")
    batch: int = field(2, help="rows decoded together")
    prompt_len: int = field(32, help="prompt tokens (a repeated block)")
    max_new: int = field(48, help="tokens to generate")
    window: int = field(6, help="tokens scored per verify call (1 + drafts)")
    ngram: int = field(2, help="lookup n-gram length")
    seed: int = field(0, help="weights and workload seed")


def main(argv=None) -> dict:
    cfg = SpecConfig.parse_args(argv)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.models.speculative import generate_speculative
    from dsml_tpu_torch.utils.logging import get_logger

    log = get_logger("spec")
    try:
        model, mcfg = model_by_family(cfg.family, cfg.model, device=cfg.device)
    except ValueError as e:
        raise SystemExit(str(e))
    model.init(cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    block = rng.integers(0, mcfg.vocab_size, (max(cfg.prompt_len // 4, cfg.ngram),))
    prompt = np.tile(block, 4)[: cfg.prompt_len][None, :].repeat(cfg.batch, 0).astype(np.int64)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        fn()  # warm-up: the kernels' build, cuBLAS handles, the allocator
        sync()
        t0 = time.monotonic()
        out = fn()
        sync()
        return out, time.monotonic() - t0

    ref, greedy_s = timed(lambda: model.generate(prompt, cfg.max_new).cpu().numpy())
    stats: dict = {}
    spec, spec_s = timed(lambda: generate_speculative(
        model, prompt, cfg.max_new, window=cfg.window, ngram=cfg.ngram, stats=stats
    ).cpu().numpy())
    if not np.array_equal(ref, spec):
        raise SystemExit("speculative output diverged from greedy generate")
    calls, total = stats["n_calls"], cfg.batch * cfg.max_new
    log.info("%s-%s on %s: tokens identical to greedy generate (%d tokens x %d rows)",
             cfg.family, cfg.model, model.device, cfg.max_new, cfg.batch)
    log.info("greedy     : %.3fs  (%.1f tok/s, 1.00 tokens/model-call)", greedy_s, total / greedy_s)
    log.info("speculative: %.3fs  (%.1f tok/s, %.2f tokens/verify-call, %d calls, %d host syncs)",
             spec_s, total / spec_s, cfg.max_new / max(calls, 1), calls, stats["host_syncs"])
    return {"tokens_identical": True, "greedy_s": greedy_s, "speculative_s": spec_s,
            "greedy_tokens_per_s": total / greedy_s, "speculative_tokens_per_s": total / spec_s,
            "verify_calls": calls, "tokens_per_verify_call": cfg.max_new / max(calls, 1),
            "host_syncs": stats["host_syncs"]}


if __name__ == "__main__":
    main()
