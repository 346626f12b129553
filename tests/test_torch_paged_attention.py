"""Paged decode attention: the PyTorch port's plain version against the
JAX package's gathered reference and its Pallas kernel in interpret
mode, on the same numpy inputs.

Tolerances: 2e-5 in f32 (the two frameworks sum the same products in
another order; `tests/unit/test_paged_attention.py` holds its own
impls to the same bound), 2e-2 in bf16 (one bf16 rounding of the
weights and of the output, as the JAX suite's bf16 bound). Rows with no
allowed key are compared exactly: the port, like the Pallas kernel,
writes zeros there.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_tpu.ops.paged_attention  # noqa: F401  (registers module)
import cloud_tpu_torch.ops.paged_attention  # noqa: F401

jpa = sys.modules["cloud_tpu.ops.paged_attention"]
tpa = sys.modules["cloud_tpu_torch.ops.paged_attention"]

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _scenario(slots=3, pages_per_slot=4, page_size=16, heads=2,
              head_dim=64, seq=1, seed=0):
    """numpy inputs: page 0 is scratch, slot i owns pages_per_slot
    distinct pages, positions stagger across page boundaries."""
    rng = np.random.default_rng(seed)
    num_pages = slots * pages_per_slot + 1
    cache_len = pages_per_slot * page_size
    shape = (num_pages, page_size, heads, head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    q = rng.normal(size=(slots, seq, heads, head_dim)).astype(np.float32)
    pt = (1 + np.arange(slots * pages_per_slot)).reshape(
        slots, pages_per_slot).astype(np.int32)
    pos = np.array([(7 + 11 * s) % (cache_len - seq)
                    for s in range(slots)])
    allowed = (np.arange(cache_len)[None, None, :]
               <= (pos[:, None] + np.arange(seq))[:, :, None])
    return q, kp, vp, pt, allowed


def _torch(arrays, dtype=None):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None and t.dtype == torch.float32:
            t = t.to(dtype)
        out.append(t)
    return out


def _jax(arrays, dtype=None):
    out = []
    for a in arrays:
        j = jnp.asarray(a)
        if dtype is not None and j.dtype == jnp.float32:
            j = j.astype(dtype)
        out.append(j)
    return out


def _compare(inputs, tol, scales=None, bf16=False):
    """Port plain version vs JAX reference and interpret-mode kernel."""
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (None, None)
    kw_t, kw_j = {}, {}
    if scales is not None:
        kw_t = dict(zip(("key_scales", "value_scales"), _torch(scales)))
        kw_j = dict(zip(("key_scales", "value_scales"), _jax(scales)))
    q, kp, vp, pt, allowed = inputs
    if scales is not None:
        tq, = _torch([q], tdt)
        jq, = _jax([q], jdt)
        tk, tv, tpt, tal = _torch([kp, vp, pt, allowed])
        jk, jv, jpt, jal = _jax([kp, vp, pt, allowed])
    else:
        tq, tk, tv, tpt, tal = _torch(inputs, tdt)
        jq, jk, jv, jpt, jal = _jax(inputs, jdt)
    port = tpa.paged_attention(tq, tk, tv, tpt, tal, **kw_t)
    assert port.dtype == (tq.dtype if scales is not None else tk.dtype)
    port = port.float().numpy()
    ref = np.asarray(jpa.paged_attention_reference(jq, jk, jv, jpt, jal,
                                                   **kw_j), np.float32)
    kern = np.asarray(jpa.paged_decode_attention(
        jq, jk, jv, jpt, jal, interpret=True, **kw_j), np.float32)
    live = allowed.any(-1)
    np.testing.assert_allclose(port[live], ref[live], atol=tol, rtol=tol)
    np.testing.assert_allclose(port, kern, atol=tol, rtol=tol)
    assert (port[~live] == 0).all()
    return port


@pytest.mark.parametrize("seq", [1, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_jax(seq, bf16):
    _compare(_scenario(seq=seq), BF16_TOL if bf16 else F32_TOL, bf16=bf16)


def test_shared_donor_pages():
    q, kp, vp, pt, allowed = _scenario(slots=3, seq=1)
    pt[1, :2] = pt[0, :2]
    pt[2, 0] = pt[0, 0]
    _compare((q, kp, vp, pt, allowed), F32_TOL)


def test_scratch_page_never_contributes():
    """Finite garbage in scratch page 0 behind masked positions moves no
    output bit."""
    q, kp, vp, pt, allowed = _scenario(slots=2, pages_per_slot=3, seq=1)
    pt[:, -1] = 0
    allowed[:, :, -16:] = False
    clean = _compare((q, kp, vp, pt, allowed), F32_TOL)
    kp[0] = 1e4
    vp[0] = -1e4
    dirty = _compare((q, kp, vp, pt, allowed), F32_TOL)
    np.testing.assert_array_equal(clean, dirty)


@pytest.mark.parametrize("seq", [1, 4])
def test_evicted_slot_rows_are_exact_zeros(seq):
    q, kp, vp, pt, allowed = _scenario(slots=3, seq=seq)
    pt[1] = 0
    allowed[1] = False
    allowed[2, -1] = False
    out = _compare((q, kp, vp, pt, allowed), F32_TOL)
    assert (out[1] == 0).all() and (out[2, -1] == 0).all()


def _int8(inputs, zero_page=None, seed=1):
    q, kp, vp, pt, allowed = inputs
    rng = np.random.default_rng(seed)
    num_pages, heads = kp.shape[0], kp.shape[2]
    k8 = np.clip(np.round(kp * 40), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vp * 40), -127, 127).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (num_pages, heads)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (num_pages, heads)).astype(np.float32)
    if zero_page is not None:
        k8[zero_page] = 0
        v8[zero_page] = 0
        ks[zero_page] = 0
        vs[zero_page] = 0
    return (q, k8, v8, pt, allowed), (ks, vs)


@pytest.mark.parametrize("zero_page", [None, 2])
@pytest.mark.parametrize("seq", [1, 4])
def test_int8_pages_match_jax(zero_page, seq):
    inputs, scales = _int8(_scenario(seq=seq), zero_page=zero_page)
    _compare(inputs, F32_TOL, scales=scales)


def test_int8_bf16_queries_match_jax():
    inputs, scales = _int8(_scenario(seq=1))
    _compare(inputs, BF16_TOL, scales=scales, bf16=True)


def test_shape_and_scale_validation():
    q, kp, vp, pt, allowed = _torch(_scenario())
    with pytest.raises(ValueError, match="allowed"):
        tpa.paged_attention(q, kp, vp, pt, allowed[:, :, :-1])
    with pytest.raises(ValueError, match="identical shapes"):
        tpa.paged_attention(q, kp, vp[:-1], pt, allowed)
    with pytest.raises(ValueError, match="match the pages"):
        tpa.paged_attention(q[:, :, :1], kp, vp, pt, allowed)
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(q, kp, vp, pt, allowed,
                            key_scales=torch.ones(kp.shape[0], 2))
    with pytest.raises(ValueError, match="int8 pages"):
        tpa.paged_attention(q, kp, vp, pt, allowed,
                            key_scales=torch.ones(kp.shape[0], 2),
                            value_scales=torch.ones(kp.shape[0], 2))
    k8, v8 = kp.to(torch.int8), vp.to(torch.int8)
    with pytest.raises(ValueError, match="num_pages, heads"):
        tpa.paged_attention(q, k8, v8, pt, allowed,
                            key_scales=torch.ones(3, 2),
                            value_scales=torch.ones(3, 2))


def test_kernel_module_imports_without_nvcc(monkeypatch):
    """Importing the build module and the wrapper needs no compiler;
    the build is deferred to the first CUDA launch."""
    monkeypatch.setenv("PATH", "/nonexistent")
    build = importlib.reload(
        importlib.import_module("cloud_tpu_torch.ops._build"))
    assert "paged_attention" in build.sources()
    assert build.library_path("paged_attention").endswith(".so")


def test_cuda_path_without_gpu_raises_not_falls_back(monkeypatch):
    """Without a card a CUDA tensor cannot be made, and the kernel path
    (what a CUDA tensor reaches) raises for want of the compiler and
    the card; it never runs the plain version instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the kernel would launch")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(tpa, "paged_attention_reference",
                        lambda *a, **k: pytest.fail("fell back"))
    q, kp, vp, pt, allowed = _torch(_scenario())
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        tpa._launch_kernel(q, kp, vp, pt, allowed, 0.125, None, None)


def test_cost_counts_pages_and_scales():
    fp = tpa.paged_attention_cost(8, 1, 12, 64, 16, 64)
    q8 = tpa.paged_attention_cost(8, 1, 12, 64, 16, 64,
                                  kv_dtype=torch.int8)
    assert fp["flops"] == 4.0 * 8 * 1024 * 12 * 64
    kv_fp = 2 * 8 * 1024 * 12 * 64 * 2
    assert fp["bytes_moved"] - q8["bytes_moved"] == kv_fp / 2 - (
        2 * 8 * 64 * 12 * 4)


def test_paged_decode_attention_is_the_jax_name():
    """`ops.paged_decode_attention` takes the JAX function's arguments
    and returns the port's `paged_attention` (here its plain version)
    within 2e-5 of JAX's `paged_decode_attention` on the CPU; the port
    has no interpret mode."""
    from cloud_tpu_torch import ops

    inputs = _scenario(seq=2)
    q, kp, vp, pt, allowed = _torch(inputs)
    got = ops.paged_decode_attention(q, kp, vp, pt, allowed, sm_scale=0.2,
                                     interpret=None)
    assert torch.equal(got, tpa.paged_attention(q, kp, vp, pt, allowed,
                                                sm_scale=0.2))
    want = jpa.paged_decode_attention(*_jax(inputs), sm_scale=0.2)
    live = inputs[-1].any(-1)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="interpret"):
        ops.paged_decode_attention(q, kp, vp, pt, allowed, interpret=True)
