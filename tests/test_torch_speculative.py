"""The port's speculative decoding and the rest of the continuous batcher's
tick (``dsml_tpu_torch.models.speculative``; ``turbo_factor``,
``adaptive_quantum`` and ``speculative_*`` of
``dsml_tpu_torch.serving.ContinuousBatcher``) against the JAX package's, on
the CPU in f32 at ``GPT2Config.tiny()`` and ``LlamaConfig.tiny()``.

Drafting is bit for bit (the host rule and the device rule, on random and
repetitive histories); ``generate_speculative`` gives JAX's tokens (equal to
greedy ``generate``) in the same number of verify calls; the batcher under
turbo, adaptive and the speculative tick (dense, paged int4, preemption,
an adaptive window) gives the JAX batcher's tokens and tick counters; the
validation raises where JAX's does; the entry points run. The counterparts
of ``tests/test_serving.py``'s speculative and turbo tests,
``tests/test_serving_adaptive.py`` and ``tests/test_paged_kv.py``'s
speculative tests."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.models import llama as jllama
from dsml_tpu.models import speculative as jspec
from dsml_tpu.serving import ContinuousBatcher as JaxBatcher
from dsml_tpu_torch.cli import decode_speculative, serve_continuous
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models import speculative as tspec
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.serving import ContinuousBatcher
from dsml_tpu_torch.serving import batcher as tbatcher

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"gpt2": (jgpt2.GPT2, jgpt2.GPT2Config, tgpt2.GPT2, tgpt2.GPT2Config),
            "llama": (jllama.Llama, jllama.LlamaConfig, tllama.Llama, tllama.LlamaConfig)}
# the batcher's tick counters and EWMAs the two packages must agree on
COUNTERS = ("n_plain_ticks", "n_turbo_ticks", "n_adaptive_ticks", "n_spec_ticks",
            "spec_window_used", "accept_ewma", "commit_ewma")


@pytest.fixture(scope="module")
def models():
    """{family: (jax model, jax params, port model)} from one seed each."""
    out = {}
    for family, (jcls, jcfg, tcls, tcfg) in FAMILIES.items():
        jmodel = jcls(jcfg.tiny())
        jparams = jmodel.init(18)
        tmodel = tcls(tcfg.tiny(), device="cpu")
        tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
        out[family] = (jmodel, jparams, tmodel)
    return out


def _repetitive(n_prompts, seed, lengths):
    """Prompts that repeat a short block, so that prompt lookup drafts."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(1, 60, 5), 40)[:n].astype(np.int64) for n in lengths[:n_prompts]]


# ---- drafting --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_lookup_draft_host_equals_jax(kind):
    rng = np.random.default_rng(0)
    for _ in range(200):
        length = int(rng.integers(1, 40))
        hist = (rng.integers(0, 4, length) if kind == "repetitive"
                else rng.integers(0, 10_000, length))
        for n in (1, 2, 3):
            for k in (1, 3, 7):
                np.testing.assert_array_equal(tspec.lookup_draft_host(hist, n, k),
                                              jspec.lookup_draft_host(hist, n, k))


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_lookup_draft_batch_equals_jax_and_the_host_rule(kind):
    rng = np.random.default_rng(1)
    hbuf = rng.integers(0, 4 if kind == "repetitive" else 500, (6, 96))
    pos = np.array([2, 5, 17, 40, 80, 95 - 7])
    for window, ngram in ((2, 1), (5, 2), (8, 3)):
        want = np.asarray(jspec.lookup_draft_batch(jnp.asarray(hbuf, jnp.int32),
                                                   jnp.asarray(pos, jnp.int32), window, ngram))
        got = tspec.lookup_draft_batch(torch.from_numpy(hbuf), torch.from_numpy(pos),
                                       window, ngram).numpy()
        np.testing.assert_array_equal(got, want)
        for b in range(len(pos)):  # the one drafting rule, host and device
            np.testing.assert_array_equal(
                got[b], tspec.lookup_draft_host(hbuf[b, : pos[b] + 1], ngram, window - 1))


# ---- generate_speculative --------------------------------------------------------


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_generate_speculative_equals_jax_and_greedy(models, family):
    jmodel, jparams, tmodel = models[family]
    prompt = np.stack(_repetitive(2, 3, [24, 24]))
    want, want_calls = jspec.generate_speculative(jmodel, jparams, jnp.asarray(prompt, jnp.int32),
                                                  30, window=5, return_calls=True)
    stats = {}
    got, calls = tspec.generate_speculative(tmodel, prompt, 30, window=5, return_calls=True,
                                            stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tmodel.generate(prompt, 30).numpy())
    assert calls == want_calls and calls < 30
    assert stats == {"n_calls": calls, "host_syncs": calls + 1}


def test_generate_speculative_validation_equals_jax(models):
    jmodel, jparams, tmodel = models["gpt2"]
    max_seq = tmodel.config.max_seq
    for prompt_len, max_new, kw in ((8, 4, dict(window=1)), (1, 4, dict(ngram=2)),
                                    (8, 4, dict(ngram=0)), (64, max_seq - 70, dict(window=8)),
                                    (8, 0, {})):
        prompt = np.ones((1, prompt_len), np.int64)
        with pytest.raises(ValueError) as jerr:
            jspec.generate_speculative(jmodel, jparams, jnp.asarray(prompt, jnp.int32), max_new,
                                       **kw)
        with pytest.raises(ValueError) as terr:
            tspec.generate_speculative(tmodel, prompt, max_new, **kw)
        assert str(terr.value) == str(jerr.value)


# ---- the batcher's ticks against the JAX batcher ------------------------------------


def _serve(batcher, prompts, budgets, staggered=True):
    """Submit three requests, step once, submit the rest, drain → tokens."""
    cut = 3 if staggered else len(prompts)
    rids = [batcher.submit(p, n) for p, n in zip(prompts[:cut], budgets[:cut])]
    if staggered:
        batcher.step()
    rids += [batcher.submit(p, n) for p, n in zip(prompts[cut:], budgets[cut:])]
    out = batcher.run()
    return [[int(t) for t in out[r]] for r in rids]


PAGED = dict(prefill_chunk=8, paged_kv="int4", page_size=8)
TICKS = {  # case: (family, the model's kv_quant, batcher options)
    "turbo": ("gpt2", False, dict(decode_quantum=2, turbo_factor=3)),
    "turbo_llama_int8": ("llama", "int8", dict(decode_quantum=2, turbo_factor=3)),
    "adaptive": ("gpt2", False, dict(adaptive_quantum=64)),
    "adaptive_llama_chunked": ("llama", False, dict(adaptive_quantum=32, prefill_chunk=16)),
    "speculative": ("gpt2", False, dict(speculative_window=5)),
    "speculative_llama_chunked": ("llama", False, dict(speculative_window=4, prefill_chunk=8)),
    "speculative_paged": ("gpt2", False, dict(speculative_window=4, n_pages=40, **PAGED)),
    "speculative_llama_paged": ("llama", False, dict(speculative_window=4, n_pages=40, **PAGED)),
    "speculative_adaptive_paged": ("llama", False, dict(speculative_window=6,
                                                        speculative_adaptive=True, n_pages=40,
                                                        **PAGED)),
    "speculative_preemption": ("llama", False, dict(speculative_window=4, n_pages=8,
                                                    preemption=True, **PAGED)),
}


@pytest.mark.parametrize("case", list(TICKS))
def test_batcher_ticks_equal_jax(models, case):
    """Staggered arrivals through both batchers from the same weights:
    tokens bit for bit and every tick counter and acceptance EWMA equal;
    the tokens also equal the port's plain batcher (the ticks are pure
    scheduling)."""
    family, kv_quant, kw = TICKS[case]
    jmodel, jparams, tmodel = models[family]
    if kv_quant:
        jmodel = type(jmodel)(dataclasses.replace(jmodel.config, kv_quant=kv_quant))
        quantized = type(tmodel)(dataclasses.replace(tmodel.config, kv_quant=kv_quant),
                                 device="cpu")
        quantized.load_state_dict(tmodel.state_dict())
        tmodel = quantized
    prompts = _repetitive(5, 7, [5, 21, 12, 30, 9])
    budgets = [14, 4, 20, 7, 11]
    common = dict(n_slots=2, prompt_buckets=(8, 16, 32))
    jsrv = JaxBatcher(jmodel, jparams, **common, **kw)
    tsrv = ContinuousBatcher(tmodel, **common, **kw)
    want = _serve(jsrv, [p.astype(np.int32) for p in prompts], budgets)
    got = _serve(tsrv, prompts, budgets)
    assert got == want
    assert {c: getattr(tsrv, c) for c in COUNTERS} == {c: getattr(jsrv, c) for c in COUNTERS}
    plain_kw = {k: v for k, v in kw.items() if k in ("prefill_chunk", "paged_kv", "page_size",
                                                     "n_pages")}
    assert _serve(ContinuousBatcher(tmodel, **common, **plain_kw), prompts, budgets) == got
    if "paged_kv" in kw:
        assert tsrv.free_pages == tsrv.n_pages - 1
    if "preemption" in kw:
        assert tsrv.n_preemptions == jsrv.n_preemptions > 0
    if "speculative_window" in kw:
        assert tsrv.n_spec_ticks > 0 and tsrv.accept_ewma > 0
        assert tsrv.predicted_tpot_s() is not None


def test_adaptive_eos_stop_equals_jax(models):
    """An EOS ends the adaptive tick at its step (tokens read back every
    ADAPTIVE_EOS_CHECK steps, the steps past it dropped), the freed slot
    admits the queued request on the next tick, and the counts equal the
    JAX batcher's."""
    jmodel, jparams, tmodel = models["llama"]
    prompts = _repetitive(3, 4, [5, 9, 7])
    ref = tmodel.generate(prompts[0][None], 12).numpy()[0].tolist()
    eos = ref[3]
    runs = []
    for srv, cast in ((JaxBatcher(jmodel, jparams, n_slots=2, eos_id=eos, prompt_buckets=(16,),
                                  adaptive_quantum=40), np.int32),
                      (ContinuousBatcher(tmodel, n_slots=2, eos_id=eos, prompt_buckets=(16,),
                                         adaptive_quantum=40), np.int64)):
        runs.append((_serve(srv, [p.astype(cast) for p in prompts], [30] * 3, staggered=False),
                     srv))
    (want, jsrv), (got, tsrv) = runs
    assert got == want
    assert got[0] == ref[: ref.index(eos) + 1]
    assert tsrv.n_adaptive_ticks == jsrv.n_adaptive_ticks > 0
    assert tsrv.n_plain_ticks == jsrv.n_plain_ticks
    # no request ran the whole 40-step budget: every tick read its tokens
    # back in groups of ADAPTIVE_EOS_CHECK steps
    assert tsrv.n_adaptive_syncs > tsrv.n_adaptive_ticks
    # request 0's EOS ends a group of ADAPTIVE_EOS_CHECK steps early: the
    # steps past it were decoded and dropped
    assert 0 < tsrv.n_adaptive_steps_dropped < tbatcher.ADAPTIVE_EOS_CHECK * tsrv.n_adaptive_ticks
    plain = ContinuousBatcher(tmodel, n_slots=2, eos_id=eos, prompt_buckets=(16,))
    assert _serve(plain, prompts, [30] * 3, staggered=False) == got


def test_adaptive_without_eos_costs_one_sync_a_tick(models):
    _, _, tmodel = models["gpt2"]
    srv = ContinuousBatcher(tmodel, n_slots=2, prompt_buckets=(16,), adaptive_quantum=64)
    _serve(srv, _repetitive(3, 5, [5, 9, 7]), [12, 3, 20], staggered=False)
    assert srv.n_adaptive_syncs == srv.n_adaptive_ticks > 0


def test_speculative_eos_stops_mid_window(models):
    """A slot stops AT its EOS even when the window would commit more
    (tests/test_serving.py's slow speculative test, its EOS leg)."""
    jmodel, jparams, tmodel = models["gpt2"]
    prompt = _repetitive(1, 6, [12])[0]
    ref = tmodel.generate(prompt[None], 6).numpy()[0].tolist()
    eos = ref[2]
    outs = []
    for srv, cast in ((JaxBatcher(jmodel, jparams, n_slots=1, eos_id=eos, prompt_buckets=(16,),
                                  speculative_window=5), np.int32),
                      (ContinuousBatcher(tmodel, n_slots=1, eos_id=eos, prompt_buckets=(16,),
                                         speculative_window=5), np.int64)):
        rid = srv.submit(prompt.astype(cast), 6)
        outs.append([int(t) for t in srv.run()[rid]])
    assert outs[1] == outs[0] == ref[: ref.index(eos) + 1]


def test_acceptance_window_map_and_censoring(models):
    """The adaptive window's width map (optimistic max before a
    measurement, floor 2, cap, monotone), and a retirement mid-window
    censors the acceptance sample unless the window was accepted whole."""
    _, _, tmodel = models["llama"]
    srv = ContinuousBatcher(tmodel, n_slots=2, speculative_window=8, speculative_adaptive=True,
                            n_pages=40, **PAGED)
    assert srv._spec_window_for_tick() == 8
    widths = []
    for acc in (0.0, 0.25, 0.5, 0.75, 1.0):
        srv.accept_ewma = acc
        widths.append(srv._spec_window_for_tick())
    assert widths[0] == 2 and widths[-1] == 8 and widths == sorted(widths)
    assert srv.predicted_tpot_s() is None  # nothing measured yet
    one = ContinuousBatcher(tmodel, n_slots=1, speculative_window=4, n_pages=40, **PAGED)
    one.submit(_repetitive(1, 11, [12])[0], 2)
    one.run()  # budget 2 < window 4: the first window retires mid-flight
    assert one.accept_ewma in (None, 1.0)


# ---- validation ------------------------------------------------------------------------


BAD = [
    dict(turbo_factor=1), dict(turbo_factor=-2), dict(turbo_factor=2, speculative_window=4),
    dict(decode_quantum=64, turbo_factor=2), dict(adaptive_quantum=1),
    dict(adaptive_quantum=4096), dict(adaptive_quantum=8, turbo_factor=2),
    dict(adaptive_quantum=8, speculative_window=4), dict(speculative_window=1),
    dict(speculative_window=4, speculative_ngram=0), dict(speculative_window=4, temperature=0.5),
    dict(speculative_window=4, decode_quantum=2), dict(speculative_adaptive=True),
]


@pytest.mark.parametrize("kw", BAD, ids=[",".join(f"{k}={v}" for k, v in kw.items()) for kw in BAD])
def test_constructor_validation_equals_jax(models, kw):
    jmodel, jparams, tmodel = models["gpt2"]
    with pytest.raises(ValueError) as jerr:
        JaxBatcher(jmodel, jparams, **kw)
    with pytest.raises(ValueError) as terr:
        ContinuousBatcher(tmodel, **kw)
    words = lambda e: str(e.value).replace("—", "-").split()[:4]  # noqa: E731
    assert words(terr) == words(jerr)


def test_speculative_submit_budget_and_paged_reserve(models):
    _, _, tmodel = models["gpt2"]
    max_seq = tmodel.config.max_seq
    srv = ContinuousBatcher(tmodel, speculative_window=8)
    with pytest.raises(ValueError, match="speculative_window"):
        # a just-finishing request's window rows would escape the cache
        srv.submit(np.zeros(64, np.int64), max_seq - 64 - 2)
    srv.submit(np.zeros(64, np.int64), max_seq - 64 - 7)
    paged = ContinuousBatcher(tmodel, speculative_window=4, n_pages=40, **PAGED)
    plain = ContinuousBatcher(tmodel, n_pages=40, **PAGED)
    assert paged._reserve_rows(20, 10, 0) == plain._reserve_rows(20, 10, 0) + 3
    assert tbatcher.ADAPTIVE_EOS_CHECK >= 1


# ---- entry points ------------------------------------------------------------------------


def test_decode_speculative_cli_runs(capfd):
    for family in ("gpt2", "llama"):
        out = decode_speculative.main(["--device", "cpu", "--family", family, "--model", "tiny",
                                       "--max_new", "24"])
        assert out["tokens_identical"] and 1 <= out["verify_calls"] <= 24
        assert out["host_syncs"] == out["verify_calls"] + 1


@pytest.mark.parametrize("flags", [["--turbo", "2", "--quantum", "2"], ["--adaptive", "16"]],
                         ids=["turbo", "adaptive"])
def test_serve_continuous_cli_llama_turbo_and_adaptive(flags):
    out = serve_continuous.main(["--device", "cpu", "--family", "llama", "--model", "tiny",
                                 "--requests", "6", *flags])
    if "--turbo" in flags:
        assert out["n_turbo_ticks"] > 0 and 0 < out["lane_utilization"] <= 1
    else:
        assert out["n_adaptive_ticks"] > 0 and out["n_adaptive_syncs"] == out["n_adaptive_ticks"]


def test_serve_continuous_cli_logs_the_dispatch_report():
    proc = subprocess.run(
        [sys.executable, "-m", "dsml_tpu_torch.cli.serve_continuous", "--device", "cpu",
         "--family", "llama", "--model", "tiny", "--requests", "6", "--adaptive", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "adaptive early-exit decode dispatches" in proc.stderr, proc.stderr
