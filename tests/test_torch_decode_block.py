"""`ops.decode_block` (the decode forward's residual add + LayerNorm, the
window attention and the int8 page write) of the PyTorch port against
the JAX package on the CPU, where each wrapper runs its plain version:

- add_layer_norm against flax `nn.LayerNorm` of x + r (the JAX block's
  residual add and norm, `cloud_tpu/models/transformer.py:307,322`);
- window_attention against the arithmetic of JAX's `_decode_attention`
  (`cloud_tpu/models/transformer.py:86`: f32 logits of the compute-dtype
  q and K, the mask as -1e30, an f32 softmax whose weights are cast to
  the compute dtype, their product with V), written out in jnp;
- int8_page_write against JAX's `_quantized_page_write` (`:246`), bit
  for bit, with a dead slot's tokens zeroed as the paged decode does.

Tolerances, with their reasons:
- h: bit-equal (the same f32 add).
- y and the attention in f32: 1e-5 (the same f32 arithmetic; sums in
  another order).
- y and the attention in bf16: one bf16 step, 2^-7 relative (an f32
  result that differs in its last bits can round the other way), plus
  2e-2 absolute for the attention, whose bf16 weights may round the
  other way before the product with V.
- the int8 pages and scales: bit-equal (the same f32 operations).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu_torch.ops import decode_block as db

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 2e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_add_layer_norm_equals_flax(dtype, residual):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(5, 3, 64))).astype(np.float32)
    r = rng.normal(size=(5, 3, 64)).astype(np.float32)
    r = np.array(jnp.asarray(r, jdt).astype(jnp.float32))
    w = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    b = (0.1 * rng.normal(size=64)).astype(np.float32)
    h = x + r if residual else x
    norm = nn.LayerNorm(epsilon=1e-5, dtype=jdt)
    want = norm.apply({"params": {"scale": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}}, jnp.asarray(h))
    y, got_h = db.add_layer_norm(
        torch.from_numpy(x),
        torch.from_numpy(r).to(tdt) if residual else None,
        torch.from_numpy(w), torch.from_numpy(b), 1e-5, tdt)
    np.testing.assert_array_equal(got_h.numpy(), h)
    assert y.dtype == tdt
    rtol = TOL[dtype][0]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=rtol)


def _jax_window_attention(q, k, v, allowed, jdt):
    """JAX's `_decode_attention` arithmetic for one example: q [W, H, D],
    k / v [L, H, D], allowed [W, L]."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    q, k, v = (jnp.asarray(t, jdt) for t in (q, k, v))
    logits = jnp.einsum("qhd,khd->hqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    logits = jnp.where(jnp.asarray(allowed)[None], logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(jdt)
    return jnp.einsum("hqk,khd->qhd", weights, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,start", [(4, 40), (16, 0), (16, 30)])
def test_window_attention_equals_jax(dtype, rows, start):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(rows + start)
    length, heads, head_dim = 64, 4, 16
    q = rng.normal(size=(rows, heads, head_dim)).astype(np.float32)
    kv = rng.normal(size=(2, length, heads, head_dim)).astype(np.float32)
    last = start + np.arange(rows)
    allowed = np.arange(length)[None, :] <= last[:, None]
    allowed[:, 3] = False     # a slot that holds no real token
    want = _jax_window_attention(q, kv[0], kv[1], allowed, jdt)
    bias = torch.where(torch.from_numpy(allowed), 0.0, -1e30)
    k, v = (torch.from_numpy(t).to(tdt) for t in kv)
    got = db.window_attention(torch.from_numpy(q).to(tdt), k, v, bias)
    assert got.dtype == tdt and got.shape == (rows, heads, head_dim)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    # The batched plain route of wider windows gives the same rows.
    again = db.dense_decode_attention(
        torch.from_numpy(q).to(tdt)[None], k[None], v[None],
        bias[None, None], 1.0 / np.sqrt(head_dim))[0]
    assert torch.equal(again, got)


def test_int8_page_write_equals_jax():
    rng = np.random.default_rng(4)
    pages = rng.integers(-127, 128, size=(2, 6, 8, 2, 16)).astype(np.int8)
    scales = rng.uniform(0.0, 0.02, size=(2, 6, 2)).astype(np.float32)
    scales[:, 3] = 0.0
    x = (rng.normal(size=(2, 3, 2, 2, 16))
         * np.array([0.5, 3.0, 1.0])[None, :, None, None, None]).astype(
             np.float32)
    phys = np.array([[1, 1], [3, 3], [4, 5]])
    off = np.array([[2, 3], [0, 1], [7, 0]])
    valid = np.array([[True, True], [True, False], [False, True]])
    tp, ts = db.int8_page_write(
        torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy()),
        torch.from_numpy(x), torch.from_numpy(phys), torch.from_numpy(off),
        torch.from_numpy(valid))
    xz = x * valid[None, :, :, None, None]
    for kv in range(2):
        jp, js = jtf._quantized_page_write(
            jnp.asarray(pages[kv]), jnp.asarray(scales[kv]),
            jnp.asarray(xz[kv]), jnp.asarray(phys), jnp.asarray(off))
        np.testing.assert_array_equal(tp[kv].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts[kv].numpy(), np.asarray(js))


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="r must match"):
        db.add_layer_norm(x, torch.zeros(2, 4), torch.ones(8),
                          torch.zeros(8), 1e-5, torch.float32)
    with pytest.raises(ValueError, match="window_attention takes"):
        db.window_attention(torch.zeros(2, 1, 8), torch.zeros(5, 1, 8),
                            torch.zeros(5, 1, 8), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="runs on CPU or CUDA"):
        db.add_layer_norm(x.to("meta"), None, torch.ones(8).to("meta"),
                          torch.zeros(8).to("meta"), 1e-5, torch.float32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("plen", [0, 21, 48])
def test_page_gather_seeds_the_prefix_and_zeros_the_rest(quantized, plen):
    """JAX's `_gather_impl` (`cloud_tpu/serving/engine.py:852`): position
    l < plen from page gvec[l // P] at offset l % P (int8 pages times
    their per-page per-head scale, in f32), zeros past plen."""
    rng = np.random.default_rng(plen)
    layers, pages_n, page, heads, dim = 2, 7, 8, 2, 16
    if quantized:
        pages = rng.integers(-127, 128, size=(layers, 2, pages_n, page, heads,
                                              dim)).astype(np.int8)
        scales = rng.uniform(0, 0.1, size=(layers, 2, pages_n, heads)
                             ).astype(np.float32)
    else:
        pages = rng.normal(size=(layers, 2, pages_n, page, heads,
                                 dim)).astype(np.float32)
        scales = None
    gvec = np.array([3, 1, 6, 0, 0, 2, 5, 4])
    want = np.zeros((layers, 2, 1, len(gvec) * page, heads, dim), np.float32)
    for l in range(plen):
        src = pages[:, :, gvec[l // page], l % page].astype(np.float32)
        if quantized:
            src = src * scales[:, :, gvec[l // page], :, None]
        want[:, :, 0, l] = src
    out = torch.full(want.shape, 7.0)
    got = db.page_gather(
        torch.from_numpy(pages),
        None if scales is None else torch.from_numpy(scales),
        torch.from_numpy(gvec), torch.tensor(plen), out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), want)
