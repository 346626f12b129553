"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a card. The
file imports no JAX, so it runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: 2e-2 on bf16 outputs (the kernel and the plain version sum
in another order and round P and the output to bf16 at other points);
rows with no allowed key must be exact zeros.
"""

import sys

import numpy as np
import pytest
import torch

import cloud_tpu_torch.ops.paged_attention  # noqa: F401

tpa = sys.modules["cloud_tpu_torch.ops.paged_attention"]

TOL = 2e-2


def _inputs(quantized, slots=4, seq=4, pages_per_slot=5, page_size=16,
            heads=3, head_dim=64, seed=0):
    rng = np.random.default_rng(seed)
    num_pages = slots * pages_per_slot + 1
    cache_len = pages_per_slot * page_size
    shape = (num_pages, page_size, heads, head_dim)
    table = (1 + rng.permutation(num_pages - 1)).reshape(
        slots, pages_per_slot).astype(np.int32)
    table[2, :2] = table[0, :2]          # shared pages
    lengths = rng.integers(seq + 1, cache_len + 1, size=slots)
    allowed = (np.arange(cache_len)[None, None, :]
               <= (lengths[:, None] - seq + np.arange(seq))[:, :, None])
    table[1] = 0                         # evicted slot: scratch only
    allowed[1] = False
    dev = torch.device("cuda")
    q = torch.tensor(rng.normal(size=(slots, seq, heads, head_dim)),
                     dtype=torch.bfloat16, device=dev)
    out = dict(q=q, page_table=torch.tensor(table, device=dev),
               allowed=torch.tensor(allowed, device=dev))
    if quantized:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.03, (num_pages, heads)).astype(np.float32)
        vs = rng.uniform(0.01, 0.03, (num_pages, heads)).astype(np.float32)
        ks[table[0, 0]] = vs[table[0, 0]] = 0.0
        out.update(key_pages=torch.tensor(k, device=dev),
                   value_pages=torch.tensor(v, device=dev),
                   key_scales=torch.tensor(ks, device=dev),
                   value_scales=torch.tensor(vs, device=dev))
    else:
        k = rng.normal(size=shape)
        v = rng.normal(size=shape)
        k[0], v[0] = 1e3, -1e3           # scratch garbage, never attended
        out.update(key_pages=torch.tensor(k, dtype=torch.bfloat16,
                                          device=dev),
                   value_pages=torch.tensor(v, dtype=torch.bfloat16,
                                            device=dev))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seq", [1, 4])
def test_kernel_matches_plain_version(quantized, seq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _inputs(quantized, seq=seq)
    args = (inp["q"], inp["key_pages"], inp["value_pages"],
            inp["page_table"], inp["allowed"])
    kw = ({"key_scales": inp["key_scales"],
           "value_scales": inp["value_scales"]} if quantized else {})
    name = "paged_attention_int8" if quantized else "paged_attention"
    before = tpa.launches[name]
    out = tpa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches[name] == before + 1
    ref = tpa.paged_attention_reference(*args, **kw)
    assert out.dtype == ref.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(),
                               atol=TOL, rtol=TOL)
    assert (out[1] == 0).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _inputs(False, seq=4)
    with pytest.raises(ValueError, match="f32|bf16"):
        tpa.paged_attention(inp["q"].float(), inp["key_pages"],
                            inp["value_pages"], inp["page_table"],
                            inp["allowed"])
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(inp["q"].transpose(0, 1).contiguous()
                            .transpose(0, 1), inp["key_pages"],
                            inp["value_pages"], inp["page_table"],
                            inp["allowed"])
