"""The port's chunked softmax cross-entropy (``dsml_tpu_torch.ops.xent``)
against the JAX package's ``chunked_softmax_xent`` and against the dense
log-softmax it replaces: value and gradients in h and wte, in f32 on the
CPU, with a vocab that is not a multiple of the chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.ops.xent import chunked_softmax_xent as jax_chunked_xent
from dsml_tpu_torch.ops.xent import chunked_softmax_xent

# f32 on both sides; the chunked online logsumexp sums in another order than
# the JAX scan and the dense softmax
TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 300


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 7, 32)).astype(np.float32)
    wte = (rng.standard_normal((VOCAB, 32)) * 0.3).astype(np.float32)
    targets = rng.integers(0, VOCAB, (2, 7)).astype(np.int32)
    targets[0, 0], targets[1, 1] = VOCAB - 1, 0  # the last, short chunk and the first
    return h, wte, targets


def _port(h, wte, targets, chunk):
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    loss = chunked_softmax_xent(ht, wt, torch.from_numpy(targets), chunk)
    loss.backward()
    return loss.item(), ht.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("chunk", [64, 128, 512])
def test_chunked_xent_matches_jax(chunk):
    h, wte, targets = _inputs(chunk)
    loss, dh, dw = _port(h, wte, targets, chunk)
    want_loss, (want_dh, want_dw) = jax.value_and_grad(
        lambda h, w: jax_chunked_xent(h, w, jnp.asarray(targets), chunk), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(wte))
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    np.testing.assert_allclose(dh, np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(dw, np.asarray(want_dw), **TOL)


@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_xent_matches_dense_log_softmax(chunk):
    h, wte, targets = _inputs(1)
    loss, dh, dw = _port(h, wte, targets, chunk)
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    logp = torch.log_softmax(ht @ wt.T, dim=-1)
    dense = -logp.gather(-1, torch.from_numpy(targets).long()[..., None]).mean()
    dense.backward()
    np.testing.assert_allclose(loss, dense.item(), **TOL)
    np.testing.assert_allclose(dh, ht.grad.numpy(), **TOL)
    np.testing.assert_allclose(dw, wt.grad.numpy(), **TOL)


def test_chunked_xent_keeps_bf16_gradient_types():
    h, wte, targets = _inputs(2)
    ht = torch.from_numpy(h).bfloat16().requires_grad_()
    wt = torch.from_numpy(wte).bfloat16().requires_grad_()
    loss = chunked_softmax_xent(ht, wt, torch.from_numpy(targets), 128)
    loss.backward()
    assert loss.dtype == torch.float32
    assert ht.grad.dtype == wt.grad.dtype == torch.bfloat16
