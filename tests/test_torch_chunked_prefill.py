"""The port's chunked prefill against the JAX package on the CPU:
`chunk_plan` against JAX's over the JAX test's layouts, the argument
checks, `ChunkedPrefill` against the whole prefill (first token, draws,
dense cache; misses, prefix hits, and two continuations interleaved so
that each moves out of the engine's static cache and back), and the
scheduler chunked and not, for fp and int8 pages, against JAX's
`generate()` (greedy) and the port's solo `generate()` (sampled), at
`test_torch_serving.py`'s size (2 layers, d 64, max_seq_len 64, f32).

Tolerances: the chunk plan exact (integers); a chunked prefill's first
token and draws exact, its dense cache within 1e-5 of the whole
prefill's (chunk windows are other matrix shapes: other f32 summation
orders); served tokens exact (f32 logits agree within ~1e-6 and no
argmax near-tie of this model and these prompts falls inside that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu.serving import engine as jengine
from cloud_tpu_torch.models import TransformerLM, generate, params_from_flax
from cloud_tpu_torch.serving import Scheduler, ServeRequest
from cloud_tpu_torch.serving.engine import DecodeEngine, chunk_plan

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=64)
CTX = CFG["max_seq_len"]
PAGE = 8
GREEDY = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)


@pytest.mark.parametrize("n_suffix,chunk", [
    (12, 4), (13, 4), (10, 4), (4, 4), (1, 4), (32, 16), (17, 16),
    (63, 8), (64, 64), (33, 1)])
def test_chunk_plan_equals_jax(n_suffix, chunk):
    assert chunk_plan(n_suffix, chunk, CTX) == jengine.chunk_plan(
        n_suffix, chunk, CTX)


def test_chunked_writes_stay_inside_the_whole_bucket():
    from cloud_tpu_torch.models.decoding import bucket_length

    for chunk in (1, 2, 4, 8, 16):
        for n in range(1, CTX + 1):
            n_full, tail, tail_bucket = chunk_plan(n, chunk, CTX)
            assert n_full * chunk + tail == n and 1 <= tail <= chunk
            assert tail_bucket & (tail_bucket - 1) == 0
            assert n_full * chunk + tail_bucket <= bucket_length(n, CTX)


@pytest.fixture(scope="module")
def models():
    jmodel = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                               **CFG)
    params = jmodel.init(jax.random.PRNGKey(11),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                           device="cpu", **CFG)
    tmodel.load_state_dict(params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def test_argument_checks(models, monkeypatch):
    """As tests/unit/test_chunked_prefill.py has them."""
    _, _, tmodel = models
    engine = DecodeEngine(tmodel, 1, PAGE, CTX // PAGE + 1)
    prompt = [1, 2, 3, 4, 5]
    for bad in (3, 0):
        with pytest.raises(ValueError, match="power of two"):
            engine.prefill_chunks(prompt, 4, 0, GREEDY, bad)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        engine.prefill_chunks(prompt, 4, 0, GREEDY, 2 * CTX)
    with pytest.raises(ValueError, match="prefix_len must be in"):
        engine.prefill_chunks(prompt, 4, 0, GREEDY, 4,
                              prefix_len=len(prompt))
    with pytest.raises(NotImplementedError, match="key_override"):
        engine.prefill_chunks(prompt, 4, 0, GREEDY, 4, key_override=(0, ()))
    chunked = engine.prefill_chunks(prompt, 4, 0, GREEDY, 4)
    assert chunked.n_chunks == 2
    chunked.abandon()
    with pytest.raises(RuntimeError, match="already consumed"):
        chunked.step()
    for bad in (-1, 3, 2 * CTX):
        with pytest.raises(ValueError):
            Scheduler(tmodel, slots=1, page_size=PAGE, prefill_chunk=bad)
    monkeypatch.setenv("CLOUD_TPU_SERVE_PREFILL_CHUNK", "8")
    assert Scheduler(tmodel, slots=1, page_size=PAGE).stats()[
        "prefill_chunk_size"] == 8
    assert Scheduler(tmodel, slots=1, page_size=PAGE,
                     prefill_chunk=0).stats()["prefill_chunk_size"] == 0


def _run(chunked):
    outs = [chunked.step() for _ in range(chunked.n_chunks)]
    assert all(r is None for r in outs[:-1]) and outs[-1] is not None
    return outs[-1]


def _same_prefill(got, want):
    assert got.first_token == want.first_token
    np.testing.assert_array_equal(got.step_seeds, want.step_seeds)
    assert (got.prompt_len, got.n_steps) == (want.prompt_len, want.n_steps)
    gs, ws = got.pcache["store"], want.pcache["store"]
    for name in ("slot_valid", "token_count"):
        assert torch.equal(gs[name], ws[name]), name
    valid = ws["slot_valid"][0]
    torch.testing.assert_close(gs["kv"][:, :, 0, valid],
                               ws["kv"][:, :, 0, valid], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("page_dtype", ["", "int8"])
def test_chunked_prefill_equals_whole_prefill(models, page_dtype):
    """Misses and a prefix hit, greedy and sampled; two continuations
    stepped in turns (each leaves the engine's static cache for the
    other and comes back), with a whole prefill between their chunks."""
    _, _, tmodel = models
    engine = DecodeEngine(tmodel, 2, PAGE, 2 * CTX // PAGE + 1,
                          page_dtype=page_dtype)
    rng = np.random.default_rng(8)
    a = rng.integers(1, 64, size=29).tolist()
    b = rng.integers(1, 64, size=13).tolist()
    sampled = dict(GREEDY, temperature=0.9, top_p=0.9)
    want_a = engine.prefill(a, 5, 9, GREEDY)
    want_b = engine.prefill(b, 5, 3, sampled)
    ca = engine.prefill_chunks(a, 5, 9, GREEDY, 4)
    cb = engine.prefill_chunks(b, 5, 3, sampled, 4)
    assert (ca.n_chunks, cb.n_chunks) == (8, 4)
    outs = {}
    for i in range(8):
        for name, c in (("a", ca), ("b", cb)):
            if i < c.n_chunks:
                outs[name] = c.step()
        if i == 2:
            engine.release_prefill(engine.prefill(b, 2, 1, GREEDY))
    _same_prefill(outs["a"], want_a)
    _same_prefill(outs["b"], want_b)
    # A prefix hit, chunked: the gather runs at the first step.
    vec = 1 + np.arange(engine.pages_per_slot)
    engine.insert(0, want_a, vec, vec, GREEDY)
    hit = a[:19] + rng.integers(1, 64, size=10).tolist()
    whole = engine.prefill(hit, 5, 4, sampled)
    chunked = _run(engine.prefill_chunks(hit, 5, 4, sampled, 4,
                                         prefix_len=19, gather_vec=vec[:3]))
    assert chunked.first_token == whole.first_token
    assert chunked.bucket == 2 and whole.bucket == 32


_MAX_NEW = 6


def _mixed_prompts(seed=0):
    """Long prompts near the context among short ones, two sharing a
    prefix."""
    rng = np.random.default_rng(seed)
    root = rng.integers(1, 64, size=40).tolist()
    return [rng.integers(1, 64, size=5).tolist(), root + [3, 4],
            rng.integers(1, 64, size=33).tolist(),
            rng.integers(1, 64, size=9).tolist(), root + [9, 8, 7, 6],
            rng.integers(1, 64, size=57).tolist()]


@pytest.fixture(scope="module")
def jax_greedy(models):
    jmodel, params, _ = models
    prompts = _mixed_prompts()
    outs = []
    for p in prompts:
        outs.append(np.asarray(jtf.generate(
            jmodel, params, jnp.asarray([p], jnp.int32), _MAX_NEW,
            temperature=0.0))[0])
    return outs


@pytest.mark.parametrize("kv_dtype,prefix_cache", [
    ("", False), ("", True), ("int8", False)])
@pytest.mark.parametrize("chunk", [8, 0])
def test_greedy_served_chunked_equals_jax_generate(models, jax_greedy,
                                                   kv_dtype, prefix_cache,
                                                   chunk):
    """Misses, and (fp pages, the cache on) chunked prefix hits: chunk
    dispatches on the chunked leg only. (Int8 hits have their own
    oracle, test_torch_prefix_cache.py.)"""
    _, _, tmodel = models
    prompts = _mixed_prompts()
    with Scheduler(tmodel, slots=3, page_size=PAGE, kv_dtype=kv_dtype,
                   prefill_chunk=chunk, prefix_cache=prefix_cache) as sched:
        results = [sched.submit(ServeRequest(
            p, _MAX_NEW, temperature=0.0)).result(timeout=120)
            for p in prompts]
        stats = sched.stats()
        sched.assert_drained(clear_prefix=True)
        assert sched.pool.available() == sched.pool.capacity
    for result, want in zip(results, jax_greedy):
        np.testing.assert_array_equal(result.tokens, want)
    assert (stats["prefill_chunks_dispatched"] > len(prompts)) == bool(chunk)
    assert stats["prefill_chunk_size"] == chunk
    assert stats["decode_gap"]["count"] > 0
    assert (stats["prefix_hits"] == 1) == prefix_cache


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_sampled_served_chunked_with_hits_equals_solo_generate(models,
                                                               kv_dtype):
    """Chunked, prefix cache on: sampled requests (misses and chunked
    hits) equal the port's solo `generate()`."""
    _, _, tmodel = models
    prompts = _mixed_prompts(seed=1)
    configs = [dict(temperature=0.8, top_k=20), dict(temperature=1.0),
               dict(temperature=0.7, top_p=0.9)]
    requests = [ServeRequest(p, _MAX_NEW, rng_seed=70 + i,
                             **configs[i % 3]) for i, p in enumerate(prompts)]
    with Scheduler(tmodel, slots=3, page_size=PAGE, kv_dtype=kv_dtype,
                   prefill_chunk=8) as sched:
        results = [sched.submit(r).result(timeout=120) for r in requests]
        stats = sched.stats()
        sched.assert_drained()
        sched.assert_drained(clear_prefix=True)
        assert sched.pool.leak_report() == {}
    assert stats["prefix_hits"] >= 1
    assert stats["pool"]["pages_prefilling"] == 0
    for req, result in zip(requests, results):
        solo = generate(tmodel, [req.prompt], req.max_new_tokens,
                        seed=req.rng_seed, temperature=req.temperature,
                        top_k=req.top_k, top_p=req.top_p, page_size=PAGE,
                        kv_dtype=kv_dtype)[0].numpy()
        np.testing.assert_array_equal(result.tokens, solo)


def test_warmup_drives_the_chunk_surface(models):
    _, _, tmodel = models
    with Scheduler(tmodel, slots=2, page_size=PAGE, prefill_chunk=8,
                   strict_no_retrace=True) as sched:
        sched.warmup([16, 64])
        assert sched.stats()["prefill_chunks_dispatched"] == 0
        prompt = _mixed_prompts()[2]
        result = sched.submit(ServeRequest(prompt, 3, temperature=0.0))
        assert result.result(timeout=120).tokens.shape == (36,)
        assert sched.stats()["prefill_chunks_dispatched"] == 5
        sched.assert_drained(clear_prefix=True)
