"""The port's `lm_head_loss` against the JAX package's on the CPU, on the
same numpy inputs: the per-token loss, dh and dW, at chunk widths that
divide, straddle and exceed the vocabulary, with labels of -1 and of V
(ignored: loss 0, gradient 0), in f32 and bf16; and the two packages'
materialising references against each other.

Tolerances, with their reasons:
- f32: 1e-5 (relative and absolute): both sum the same f32 terms, in
  other orders (chunked online logsumexp against XLA's reductions).
- bf16 inputs: the logits are f32 products of the bf16 values in both
  (exact products, f32 sums), so the loss holds at 1e-5; the gradients
  are rounded to bf16 at the end, so they may sit one bf16 step apart
  where the f32 values straddle a rounding boundary: 2^-8 relative plus
  1e-6 absolute.
- the references: 1e-5 on in-range labels (JAX's gathers an
  out-of-range label clipped; the port's gives it 0, as both
  `lm_head_loss`es do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.ops import fused_ce as jce
from cloud_tpu_torch.ops import fused_ce as tce

N, D, V = 24, 16, 50


def _inputs(seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    y = rng.integers(0, V, N).astype(np.int32)
    if ignore:
        y[::5] = -1   # padding
        y[1] = V      # out of range on the other side
    return h, w, y


def _jax_loss_and_grads(h, w, y, chunk):
    def total(a, b):
        return jnp.sum(jce.lm_head_loss(a, b, jnp.asarray(y), chunk))

    loss = jce.lm_head_loss(h, w, jnp.asarray(y), chunk)
    gh, gw = jax.grad(total, argnums=(0, 1))(h, w)
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (loss, gh, gw)]


def _port_loss_and_grads(h, w, y, chunk, dtype=torch.float32):
    ht = torch.tensor(h).to(dtype).requires_grad_()
    wt = torch.tensor(w).to(dtype).requires_grad_()
    loss = tce.lm_head_loss(ht, wt, torch.tensor(y), chunk=chunk)
    loss.sum().backward()
    assert loss.dtype == torch.float32
    assert ht.grad.dtype == wt.grad.dtype == dtype
    return [t.detach().float().numpy() for t in (loss, ht.grad, wt.grad)]


@pytest.mark.parametrize("chunk", [7, 16, 50, 128])
def test_loss_and_gradients_match_jax(chunk):
    h, w, y = _inputs()
    want = _jax_loss_and_grads(jnp.asarray(h), jnp.asarray(w), y, chunk)
    got = _port_loss_and_grads(h, w, y, chunk)
    for name, a, b in zip(("loss", "dh", "dW"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    ignored = (y < 0) | (y >= V)
    assert (got[0][ignored] == 0.0).all()


@pytest.mark.parametrize("chunk", [7, 16, 50, 128])
def test_bf16_inputs_match_jax(chunk):
    h, w, y = _inputs(seed=1)
    hb, wb = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = _jax_loss_and_grads(hb, wb, y, chunk)
    got = _port_loss_and_grads(np.asarray(hb.astype(jnp.float32)),
                               np.asarray(wb.astype(jnp.float32)), y, chunk,
                               dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("dh", "dW"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=1e-6,
                                   err_msg=name)


def test_ignored_positions_carry_no_gradient():
    """A row whose label is ignored contributes nothing: dh's row is 0,
    and dW equals the gradient of the kept rows alone."""
    h, w, y = _inputs(seed=2)
    _, dh, dw = _port_loss_and_grads(h, w, y, 16)
    ignored = (y < 0) | (y >= V)
    assert (dh[ignored] == 0.0).all()
    kept = ~ignored
    _, _, dw_kept = _port_loss_and_grads(h[kept], w, y[kept], 16)
    np.testing.assert_allclose(dw, dw_kept, rtol=1e-6, atol=1e-7)


def test_references_agree_on_in_range_labels():
    h, w, y = _inputs(seed=3, ignore=False)

    def jax_mean(a, b):
        return jnp.mean(jce.lm_head_loss_reference(a, b, jnp.asarray(y)))

    want = [jce.lm_head_loss_reference(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(y))]
    want += list(jax.grad(jax_mean, argnums=(0, 1))(jnp.asarray(h),
                                                    jnp.asarray(w)))
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = tce.lm_head_loss_reference(ht, wt, torch.tensor(y))
    loss.mean().backward()
    for name, a, b in zip(("loss", "dh", "dW"),
                          (loss.detach(), ht.grad, wt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("chunk", [7, 50, 1 << 20])
def test_chunked_loss_matches_its_reference(chunk):
    """Against the port's own materialising reference, ignored labels
    included (a chunk wider than V is one chunk)."""
    h, w, y = _inputs(seed=4)
    got = _port_loss_and_grads(h, w, y, chunk)
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = tce.lm_head_loss_reference(ht, wt, torch.tensor(y))
    loss.sum().backward()
    for name, a, b in zip(("loss", "dh", "dW"), got,
                          (loss.detach(), ht.grad, wt.grad)):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_rejects_mismatched_shapes():
    h, w, y = _inputs()
    with pytest.raises(ValueError, match="disagree"):
        tce.lm_head_loss(torch.tensor(h), torch.tensor(w.T.copy()),
                         torch.tensor(y))
    with pytest.raises(ValueError, match="hidden"):
        tce.lm_head_loss(torch.tensor(h)[None], torch.tensor(w),
                         torch.tensor(y))
