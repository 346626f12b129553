"""`LlamaLM` decode and `generate()` of the PyTorch port against the JAX
package's `LlamaLM(decode=True)` and `generate()` on the same numpy
parameters (`llama_params_from_flax`), f32 compute on the CPU, at 2
layers and narrow widths (d 64, 4 heads over 2 KV heads, d_ff 176,
max_seq_len 64); the norm and MLP run their plain versions on both
sides (the port's CPU route; JAX's lax references off the TPU).

Tolerances, with their reasons:
- decode logits, prefill and steps: 3e-5 relative and absolute. f32 on
  both sides; the frameworks sum the same products in another order,
  over 2 blocks, with |logits| up to ~4 (the training forward's parity
  test holds 2e-5; decode adds the cache round trip, which is exact in
  f32, and RoPE at logical positions, whose angles agree to a few f32
  steps). Only real query positions are compared: a padded query has
  no allowed key, and there JAX averages every one of the L cache slots
  while the port reads the written prefix alone; those logits are
  never read.
- greedy tokens: equal.
- a left-padded batch against its rows decoded alone: logits within
  1e-5 (the same model, other shapes), tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import decoding as jdecoding
from cloud_tpu.models import llama as jl
from cloud_tpu.models.transformer import generate as jgenerate
from cloud_tpu_torch.models import (LlamaLM, RopeScaling, decoding,
                                    generate, llama_params_from_flax)
from cloud_tpu_torch.monitoring import telemetry

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=176, max_seq_len=64, norm_eps=1e-5)
TOL = 3e-5

VARIANTS = {
    "base": {},
    "group1": dict(num_kv_heads=4),
    "group4": dict(num_kv_heads=1),
    "window": dict(sliding_window=5),
    "llama3_rope": dict(rope_style="rotate_half",
                        rope_scaling=dict(kind="llama3", factor=8.0,
                                          low_freq_factor=1.0,
                                          high_freq_factor=4.0,
                                          original_max_len=32)),
    "gemma2_softcaps": dict(post_block_norms=True, attn_logit_softcap=2.0,
                            final_logit_softcap=3.0, attn_scale=0.4,
                            attn_kinds=("local", "global"),
                            sliding_window=4, mlp_activation="gelu_tanh",
                            scale_embed=True),
    "gemma3_qk_norm": dict(qk_norm=True, post_block_norms=True,
                           rope_theta_local=100.0,
                           attn_kinds=("local", "global"),
                           sliding_window=6, attn_scale=0.3),
    "qkv_bias": dict(qkv_bias=True),
}


def _models(name, seed=3):
    kw = dict(CFG, **VARIANTS[name])
    jkw, tkw = dict(kw), dict(kw)
    if "rope_scaling" in kw:
        jkw["rope_scaling"] = jl.RopeScaling(**kw["rope_scaling"])
        tkw["rope_scaling"] = RopeScaling(**kw["rope_scaling"])
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, **jkw)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    # Non-trivial norm scales and biases, so every leaf matters.
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu", **tkw)
    tmodel.load_state_dict(llama_params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _left_padded(rng, batch=3, seq=12, pads=(0, 3, 7)):
    tokens = rng.integers(0, 64, size=(batch, seq))
    mask = np.ones((batch, seq), bool)
    for row, pad in enumerate(pads):
        mask[row, :pad] = False
        tokens[row, :pad] = 0
    return tokens, mask


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_decode_logits_match_jax(name):
    """A left-padded prefill, then three single-token steps: the logits
    of every real position against JAX's decode on the same cache
    schedule."""
    jmodel, params, tmodel = _models(name)
    rng = np.random.default_rng(11)
    tokens, mask = _left_padded(rng)
    steps = rng.integers(0, 64, size=(3, tokens.shape[0], 1))

    decoder = jmodel.clone(decode=True)
    jcache = jdecoding.empty_cache(decoder, tokens.shape[0])
    tcache = tmodel.init_cache(tokens.shape[0])
    calls = [(tokens, mask)] + [(s, None) for s in steps]
    for toks, m in calls:
        want, variables = decoder.apply(
            {"params": params, "cache": jcache}, jnp.asarray(toks),
            None if m is None else jnp.asarray(m), mutable=["cache"])
        jcache = variables["cache"]
        got = tmodel(torch.from_numpy(toks),
                     None if m is None else torch.from_numpy(m), tcache)
        real = np.ones(toks.shape, bool) if m is None else m
        np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                                   rtol=TOL, atol=TOL)
    # The caches agree slot for slot (K at H_kv width, positions, flags).
    jlayer = jcache["block_0"]["attention"]
    tlayer = tcache["layers"][0]
    assert tlayer["cache_index"] == int(jlayer["cache_index"])
    for key in ("slot_valid", "slot_pos", "token_count"):
        np.testing.assert_array_equal(tlayer[key].numpy(),
                                      np.asarray(jlayer[key]))
    np.testing.assert_allclose(tlayer["cached_key"].numpy(),
                               np.asarray(jlayer["cached_key"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["base", "group4", "gemma2_softcaps",
                                  "gemma3_qk_norm"])
def test_greedy_generate_matches_jax(name):
    """generate() at temperature 0 on a left-padded batch (bucketed to
    16): the tokens equal JAX's."""
    jmodel, params, tmodel = _models(name)
    rng = np.random.default_rng(5)
    prompt, mask = _left_padded(rng, seq=10, pads=(0, 2, 5))
    want = jgenerate(jmodel, params, jnp.asarray(prompt), 8,
                     temperature=0.0, prompt_mask=jnp.asarray(mask))
    got = generate(tmodel, prompt, 8, temperature=0.0, prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eos_fill_matches_jax():
    """Positions after a greedy eos are eos, as in JAX."""
    jmodel, params, tmodel = _models("base")
    prompt = np.random.default_rng(6).integers(0, 64, size=(2, 6))
    free = generate(tmodel, prompt, 8, temperature=0.0).numpy()
    eos = int(free[0, 8])  # the first row's third new token
    want = jgenerate(jmodel, params, jnp.asarray(prompt), 8,
                     temperature=0.0, eos_token=eos)
    got = generate(tmodel, prompt, 8, temperature=0.0, eos_token=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = got.numpy()[0, 6:]
    first = int(np.flatnonzero(row == eos)[0])
    assert (row[first:] == eos).all()


def test_left_padded_batch_equals_its_rows_alone():
    """Each row of a left-padded batch generates what it generates
    unpadded and alone, and its prefill logits agree."""
    _, _, tmodel = _models("window")
    rng = np.random.default_rng(8)
    prompt, mask = _left_padded(rng, seq=9, pads=(0, 4, 2))
    batch = generate(tmodel, prompt, 6, temperature=0.0,
                     prompt_mask=mask).numpy()
    cache = tmodel.init_cache(3)
    logits = tmodel(torch.from_numpy(prompt), torch.from_numpy(mask), cache)
    for row in range(3):
        alone = prompt[row][mask[row]][None]
        solo = generate(tmodel, alone, 6, temperature=0.0).numpy()
        np.testing.assert_array_equal(batch[row, 9:], solo[0, alone.shape[1]:])
        solo_logits = tmodel(torch.from_numpy(alone), None,
                             tmodel.init_cache(1))
        np.testing.assert_allclose(logits[row][torch.from_numpy(mask[row])],
                                   solo_logits[0], rtol=1e-5, atol=1e-5)
    # Bucketing off changes nothing.
    flat = generate(tmodel, prompt, 6, temperature=0.0, prompt_mask=mask,
                    bucket_prompts=False).numpy()
    np.testing.assert_array_equal(flat, batch)


def test_cache_is_kv_wide_and_decode_matches_forward():
    """The cache holds K/V at H_kv width in the compute dtype; decoding
    a sequence piecewise gives the training forward's logits."""
    _, _, tmodel = _models("group4")
    cache = tmodel.init_cache(2)
    assert len(cache["layers"]) == 2
    layer = cache["layers"][0]
    assert layer["cached_key"].shape == (2, 64, 1, 16)
    assert layer["cached_value"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, 64, size=(2, 11)))
    full = tmodel(tokens)
    parts = [tmodel(tokens[:, :6], None, cache)]
    parts += [tmodel(tokens[:, i:i + 1], None, cache) for i in range(6, 11)]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(),
                               full.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert layer["cache_index"] == 11
    bf16 = LlamaLM(compute_dtype=torch.bfloat16, device="cpu", **CFG)
    assert bf16.init_cache(1)["layers"][0]["cached_key"].dtype == \
        torch.bfloat16
    # decode=True is kept for the JAX signature and no longer raises.
    assert LlamaLM(decode=True, device="cpu", **CFG).decode


def test_length_guards_and_sampling_validation():
    _, _, tmodel = _models("base")
    prompt = np.zeros((2, 8), np.int64)
    assert torch.equal(generate(tmodel, prompt, 0),
                       torch.zeros((2, 8), dtype=torch.long))
    with pytest.raises(ValueError, match=">= 0"):
        generate(tmodel, prompt, -1)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        generate(tmodel, prompt, 57, temperature=0.0)
    with pytest.raises(ValueError, match="needs `seed`"):
        generate(tmodel, prompt, 4, temperature=1.0)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="top_k"):
            generate(tmodel, prompt, 4, seed=0, top_k=bad)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            generate(tmodel, prompt, 4, seed=0, top_p=bad)
    right_padded = np.ones((2, 8), bool)
    right_padded[0, -1] = False
    with pytest.raises(ValueError, match="LEFT-padded"):
        generate(tmodel, prompt, 4, temperature=0.0,
                 prompt_mask=right_padded)
    with pytest.raises(ValueError, match="past the cache length"):
        cache = tmodel.init_cache(1)
        tmodel(torch.zeros((1, 40), dtype=torch.long), None, cache)
        tmodel(torch.zeros((1, 30), dtype=torch.long), None, cache)


def test_sampled_generate_is_seeded():
    """The same seed gives the same tokens, another seed other tokens;
    top_k=1 is the greedy route."""
    _, _, tmodel = _models("base")
    prompt = np.random.default_rng(2).integers(0, 64, size=(3, 5))
    a = generate(tmodel, prompt, 10, seed=4, temperature=1.0, top_p=0.9)
    b = generate(tmodel, prompt, 10, seed=4, temperature=1.0, top_p=0.9)
    c = generate(tmodel, prompt, 10, seed=5, temperature=1.0, top_p=0.9)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = generate(tmodel, prompt, 10, temperature=0.0)
    assert torch.equal(generate(tmodel, prompt, 10, seed=1, top_k=1),
                       greedy)


def test_cache_pool_recycles_zeroed_caches():
    _, _, tmodel = _models("base")
    decoding.clear_cache_pool()
    try:
        cache = decoding.acquire_cache(tmodel, 2)
        tmodel(torch.ones((2, 5), dtype=torch.long), None, cache)
        assert cache["layers"][0]["cache_index"] == 5
        decoding.release_cache(tmodel, 2, cache)
        again = decoding.acquire_cache(tmodel, 2)
        assert again is cache
        layer = again["layers"][0]
        assert layer["cache_index"] == 0
        assert not layer["cached_key"].any() and not layer["slot_valid"].any()
        assert decoding.acquire_cache(tmodel, 2) is not cache  # pool empty
        for _ in range(3):
            decoding.release_cache(tmodel, 2, tmodel.init_cache(2))
        assert len(decoding._CACHE_POOL[(tmodel, 2)]) == \
            decoding._CACHE_POOL_DEPTH
    finally:
        decoding.clear_cache_pool()
    assert not decoding._CACHE_POOL


def test_decode_latency_feeds_telemetry_when_enabled():
    _, _, tmodel = _models("base")
    prompt = np.zeros((1, 4), np.int64)
    assert decoding.decode_latency_start() is None
    tele = telemetry.enable()
    try:
        generate(tmodel, prompt, 5, temperature=0.0)
        assert tele.decode_token_latency.count == 5
        assert tele.decode_token_latency.sum > 0
    finally:
        telemetry.disable()
        decoding.clear_cache_pool()
    assert decoding.decode_latency_start() is None
