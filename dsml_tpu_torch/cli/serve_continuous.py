"""Continuous-batching demo: mixed-length requests through
``dsml_tpu_torch.serving.ContinuousBatcher`` against the static-batch
baseline — the port of ``examples/serve_continuous.py``.

Requests with different prompt and output lengths are served slot by slot:
a finished request's slot is refilled from the queue at once, where a
static batch idles every lane until the group's longest request finishes.
Logs the workload, each strategy's wall time, decode-lane utilization and
tokens/s. ``--paged_kv`` serves from a page pool (fp, int8 or int4 pages;
on the card through the CUDA paged-attention kernels) and needs
``--prefill_chunk > 0``.

    python -m dsml_tpu_torch.cli.serve_continuous --device cpu --model tiny --requests 6 \\
        --paged_kv int4 --prefill_chunk 8
    python -m dsml_tpu_torch.cli.serve_continuous --model small --paged_kv int4 \\
        --prefill_chunk 64 --requests 16

Runs on the CUDA card unless ``--device cpu``. ``--turbo``, ``--adaptive``
and ``--family llama`` come with later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class ServeConfig(Config):
    device: str = field("cuda", help="torch device: cuda | cpu")
    family: str = field("gpt2", help="model family: gpt2 (llama: a later slice)")
    model: str = field("tiny", help="model preset (tiny for the demo)")
    n_slots: int = field(4, help="decode slots (concurrent requests)")
    quantum: int = field(1, help="tokens decoded per scheduler tick (one host fetch per tick)")
    adaptive: int = field(0, help="adaptive early-exit tick budget (a later slice; 0 = off)")
    turbo: int = field(0, help="turbo factor (a later slice; 0 = off)")
    prefill_chunk: int = field(0, help="chunked-prefill admission: prefill C "
                               "tokens per tick with decode quanta between a "
                               "long prompt's chunks (0 = whole-prompt)")
    requests: int = field(12, help="number of requests in the workload")
    max_new_max: int = field(24, help="largest per-request token budget")
    temperature: float = field(0.0, help="0 = greedy")
    seed: int = field(0, help="workload seed")
    paged_kv: str = field("off", help="KV cache: off (dense) | fp | int8 | int4 (paged pool)")
    page_size: int = field(16, help="rows per KV page (paged_kv)")
    n_pages: int = field(0, help="pages in the pool (0 = every slot can hold max_seq rows)")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    cfg = ServeConfig.parse_args(argv)
    from dsml_tpu_torch.models import model_by_family
    from dsml_tpu_torch.serving import ContinuousBatcher
    from dsml_tpu_torch.utils.logging import get_logger

    log = get_logger("serve")
    if cfg.turbo or cfg.adaptive:
        raise NotImplementedError("--turbo and --adaptive come with the speculative/turbo slice")
    if cfg.paged_kv not in ("off", "fp", "int8", "int4"):
        raise SystemExit(f"--paged_kv must be off, fp, int8 or int4, got {cfg.paged_kv!r}")
    paged = False if cfg.paged_kv == "off" else cfg.paged_kv
    if paged and cfg.prefill_chunk <= 0:
        raise SystemExit("--paged_kv needs --prefill_chunk > 0 (paged admission is chunked)")
    model, mcfg = model_by_family(cfg.family, cfg.model, device=cfg.device)
    model.init(cfg.seed)

    rng = np.random.default_rng(cfg.seed)
    lengths = rng.integers(4, min(64, mcfg.max_seq // 2), cfg.requests)
    budgets = rng.integers(2, cfg.max_new_max + 1, cfg.requests)
    prompts = [rng.integers(0, mcfg.vocab_size, (l,)).astype(np.int64) for l in lengths]
    total_tokens = int(budgets.sum())
    log.info(
        "workload: %d requests, prompts %d-%d tokens, budgets %d-%d, %d total new tokens",
        cfg.requests, lengths.min(), lengths.max(), budgets.min(), budgets.max(), total_tokens,
    )

    # ---- continuous batching -------------------------------------------------
    srv = ContinuousBatcher(
        model, n_slots=cfg.n_slots, temperature=cfg.temperature, seed=cfg.seed,
        prompt_buckets=(16, 32, 64), decode_quantum=cfg.quantum,
        prefill_chunk=cfg.prefill_chunk, paged_kv=paged, page_size=cfg.page_size,
        n_pages=cfg.n_pages,
    )
    # warm-up pass: the kernels' build, cuBLAS handles, the allocator
    for p, n in zip(prompts, budgets):
        srv.submit(p, int(n))
    srv.run()
    for p, n in zip(prompts, budgets):
        srv.submit(p, int(n))
    plain0, prefill0 = srv.n_plain_ticks, srv.n_prefill_dispatches
    _sync(cfg.device)
    t0 = time.monotonic()
    steps = 0
    useful_ticks = 0  # decode-lane ticks that produced a wanted token
    # drained when nothing is queued, decoding, mid-admission or preempted
    while srv.n_queued or srv.n_active or srv.n_pending or srv.n_preempted:
        useful_ticks += sum(len(v) for v in srv.step().values())
        steps += 1
    _sync(cfg.device)
    cont_s = time.monotonic() - t0
    srv.collect()
    n_plain = srv.n_plain_ticks - plain0
    # each request's first token comes from its prefill, not a decode lane
    useful_ticks -= cfg.requests
    lane_capacity = n_plain * cfg.quantum * cfg.n_slots

    # ---- static-batch baseline: groups of n_slots, each waiting for its
    # longest budget (what a plain batched `generate` loop does) ----------------
    def run_static():
        for i in range(0, cfg.requests, cfg.n_slots):
            group = list(range(i, min(i + cfg.n_slots, cfg.requests)))
            n_max = int(max(budgets[g] for g in group))
            width = int(max(lengths[g] for g in group))
            batch = np.zeros((len(group), width), np.int64)
            for row, g in enumerate(group):
                batch[row, width - lengths[g]:] = prompts[g]  # left-pad
            model.generate(batch, n_max, temperature=cfg.temperature, seed=cfg.seed).cpu()

    run_static()  # warm-up
    _sync(cfg.device)
    t0 = time.monotonic()
    run_static()
    static_s = time.monotonic() - t0
    static_useful = 0
    static_ticks = 0
    for i in range(0, cfg.requests, cfg.n_slots):
        group = list(range(i, min(i + cfg.n_slots, cfg.requests)))
        n_max = int(max(budgets[g] for g in group))
        # decode ticks per lane = n_max - 1 (the first token comes from prefill)
        static_useful += sum(int(budgets[g]) - 1 for g in group)
        static_ticks += (n_max - 1) * cfg.n_slots
    static_util = static_useful / max(static_ticks, 1)
    util = useful_ticks / max(lane_capacity, 1)

    log.info("continuous: %.2fs (%d scheduler steps, lane utilization %.0f%%, "
             "%d plain decode dispatches, %d prefill dispatches)",
             cont_s, steps, 100 * util, n_plain, srv.n_prefill_dispatches - prefill0)
    log.info("static    : %.2fs (lane utilization %.0f%% — idle lanes wait for the "
             "group's longest request)", static_s, 100 * static_util)
    log.info("tokens/s: continuous %.1f vs static %.1f",
             total_tokens / cont_s, total_tokens / static_s)
    if paged:
        log.info("paged KV (%s): %d pages of %d rows, %d free after the drain",
                 cfg.paged_kv, srv.n_pages, cfg.page_size, srv.free_pages)
    log.info("reading the numbers: every continuous tick is a host round trip "
             "over eager decode steps; continuous batching wins lane UTILIZATION "
             "(above), online arrival (it starts serving at once) and tail latency — "
             "raise --quantum to amortize the per-tick host cost")
    return {"requests": cfg.requests, "total_tokens": total_tokens, "continuous_s": cont_s,
            "static_s": static_s, "tokens_per_s": total_tokens / cont_s,
            "static_tokens_per_s": total_tokens / static_s, "lane_utilization": util,
            "static_lane_utilization": static_util, "steps": steps, "n_plain_ticks": n_plain,
            "n_prefill_dispatches": srv.n_prefill_dispatches - prefill0,
            "paged_kv": cfg.paged_kv, "n_pages": srv.n_pages, "free_pages": srv.free_pages}


if __name__ == "__main__":
    main()
