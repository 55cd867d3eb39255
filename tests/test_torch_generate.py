"""The port's serving loop (``GPT2.decode_step`` / ``generate`` /
``sample_token_logits``) against the JAX package's, at ``GPT2Config.tiny()``
in f32 on the CPU: teacher-forced decode logits agree, greedy tokens are
identical (with and without EOS), and sampling keeps the JAX truncation
rules. Sampled tokens cannot match the JAX package's, whose noise comes
from ``jax.random``; they are held to seed determinism and to the support
and frequencies of the JAX sampler on the same logits."""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu_torch.models import gpt2 as tgpt2

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)  # f32 both sides, another summation order


@pytest.fixture(scope="module")
def pair():
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config.tiny())
    return jmodel, jmodel.init(5), tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(5)


def _prompt(b, t, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(np.int32)


def test_teacher_forced_decode_logits_match(pair):
    jmodel, jparams, tmodel = pair
    toks = _prompt(2, 14, seed=1)
    t0 = 6
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks[:, :t0]))
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks[:, :t0]).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    step = jax.jit(jmodel.decode_step)
    for pos in range(t0, t0 + 8):
        jlog, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos]), jnp.asarray(pos, jnp.int32))
        tlog, tcache = tmodel.decode_step(tcache, torch.from_numpy(toks[:, pos]).long(), pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL, err_msg=f"pos {pos}")
    for g, w in zip(tcache, jcache):
        np.testing.assert_allclose(g["k"].numpy(), np.asarray(w["k"]), **TOL)


def _margins(tmodel, prompt, tokens):
    """Top-2 logit margin at each generated position, teacher-forced with
    ``tokens`` — printed when a greedy comparison fails."""
    logits, cache = tmodel.prefill(torch.from_numpy(prompt).long())
    out = []
    for i in range(tokens.shape[1]):
        top2 = logits.topk(2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).min().item())
        if i + 1 < tokens.shape[1]:
            logits, cache = tmodel.decode_step(cache, torch.from_numpy(tokens[:, i]).long(),
                                               prompt.shape[1] + i)
    return out


@pytest.mark.parametrize("with_eos", [False, True])
def test_greedy_generate_tokens_identical(pair, with_eos):
    jmodel, jparams, tmodel = pair
    prompt = _prompt(3, 10, seed=2)
    eos = None
    if with_eos:
        # a token the greedy run emits mid-way, so rows stop at different steps
        free = np.asarray(jmodel.generate(jparams, jnp.asarray(prompt), 12))
        eos = int(free[0, 4])
    want = np.asarray(jmodel.generate(jparams, jnp.asarray(prompt), 12, eos_id=eos))
    got = tmodel.generate(prompt, 12, eos_id=eos).numpy()
    assert got.shape == (3, 12) and got.dtype == np.int64
    if with_eos:
        assert (want == eos).any()
    assert np.array_equal(got, want), (
        f"greedy tokens differ:\nport {got}\njax  {want}\n"
        f"top-2 margins per step: {_margins(tmodel, prompt, want)}"
    )


def test_sampled_generate_is_seed_deterministic(pair):
    *_, tmodel = pair
    prompt = _prompt(2, 8, seed=3)
    kw = dict(temperature=0.8, top_k=32, top_p=0.9)
    a = tmodel.generate(prompt, 16, seed=4, **kw)
    assert torch.equal(a, tmodel.generate(prompt, 16, seed=4, **kw))
    assert not torch.equal(a, tmodel.generate(prompt, 16, seed=5, **kw))
    assert a.min() >= 0 and a.max() < 512


def _draws_jax(logits, n, **kw):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return np.asarray(jax.vmap(lambda k: jgpt2.sample_token_logits(jnp.asarray(logits), k, **kw))(keys))


def _draws_torch(logits, n, **kw):
    gen = torch.Generator().manual_seed(0)
    return tgpt2.sample_token_logits(
        torch.from_numpy(logits).expand(n, -1), gen, **kw
    ).numpy()


@pytest.mark.parametrize(
    "kw",
    [dict(temperature=1.0, top_k=3), dict(temperature=0.7, top_p=0.6),
     dict(temperature=1.3, top_k=5, top_p=0.8), dict(temperature=1.0)],
    ids=["top_k_tie", "top_p", "both", "full"],
)
def test_sampler_keeps_jax_support_and_frequencies(kw):
    # tokens 2 and 3 tie at the 3rd-largest value: top_k=3 keeps both
    logits = np.array([2.0, 2.6, 1.5, 1.5, 0.3, -0.4, 1.1, -2.0], np.float32)
    n = 4000
    want = _draws_jax(logits, n, **kw)
    got = _draws_torch(logits, n, **kw)
    assert set(got) == set(want)
    if kw.get("top_k") == 3:
        assert set(got) == {0, 1, 2, 3}
    f_want = np.bincount(want, minlength=8) / n
    f_got = np.bincount(got, minlength=8) / n
    # 4000 draws: a frequency's standard error is <= 0.008
    np.testing.assert_allclose(f_got, f_want, atol=0.04)


def test_greedy_sampler_takes_the_first_maximum():
    logits = np.array([[0.5, 3.0, 3.0, 1.0], [2.0, -1.0, 2.0, 2.0]], np.float32)
    got = tgpt2.sample_token_logits(torch.from_numpy(logits), None, 0.0)
    want = np.asarray(jgpt2.sample_token_logits(jnp.asarray(logits), None, 0.0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "args",
    [(10, 0, 0.0, 0, 0.0), (120, 9, 0.0, 0, 0.0), (10, 4, 0.0, -1, 0.0),
     (10, 4, 0.0, 513, 0.0), (10, 4, 0.0, 0, 1.5), (10, 4, -0.5, 0, 0.0)],
    ids=["no_tokens", "overflow", "neg_top_k", "big_top_k", "top_p", "temperature"],
)
def test_generate_args_raise_the_same_errors(pair, args):
    jmodel, _, tmodel = pair
    with pytest.raises(ValueError) as jerr:
        jmodel._check_generate_args(*args)
    with pytest.raises(ValueError) as terr:
        tmodel._check_generate_args(*args)
    assert str(terr.value) == str(jerr.value)


def test_cli_generates_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "dsml_tpu_torch.cli.generate_text", "--device", "cpu",
         "--model", "tiny", "--max_new_tokens", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [l for l in proc.stdout.splitlines() if " -> " in l]
    assert len(lines) == 2 and all(l.startswith("'the cat '") for l in lines), proc.stdout
