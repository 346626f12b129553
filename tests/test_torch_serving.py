"""The PyTorch port's serving path (`Scheduler` -> `DecodeEngine` ->
paged decode) against the JAX package's `generate()`, and against the
port's own solo `generate()`, at a small f32 size on the CPU.

Greedy requests must equal JAX `generate()` token for token: both
sides decode in f32, where the logits agree within ~1e-6 and no argmax
near-tie of this model and these prompts falls inside that. Sampled
requests must equal the port's solo `generate()` with the same seed
exactly: both run the same prefill, page scatter, decode and seeded
draws.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu_torch.models import TransformerLM, generate, params_from_flax
from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.serving import PagePool, Scheduler, ServeRequest

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=64)


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


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [3, 17, 9, 30, 1, 12, 24, 6][:n]
    return [rng.integers(1, 64, size=k).tolist() for k in lengths]


_MAX_NEW = 9


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX `generate()` of each greedy request: one left-padded batch
    (the prompt_mask contract makes each row its solo decode)."""
    jmodel, params, _ = models
    prompts = _prompts(8)
    width = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for row, p in enumerate(prompts):
        batch[row, width - len(p):] = p
        mask[row, width - len(p):] = True
    out = np.asarray(jtf.generate(jmodel, params, jnp.asarray(batch),
                                  _MAX_NEW, temperature=0.0,
                                  prompt_mask=jnp.asarray(mask)))
    return [out[row, width - len(p):] for row, p in enumerate(prompts)]


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_greedy_requests_equal_jax_generate(models, jax_greedy, kv_dtype):
    _, _, tmodel = models
    prompts = _prompts(8)
    max_new = [_MAX_NEW, 5, _MAX_NEW, 3, 7, _MAX_NEW, 2, _MAX_NEW]
    with Scheduler(tmodel, slots=3, page_size=8, kv_dtype=kv_dtype) as s:
        futures = [s.submit(ServeRequest(p, n, temperature=0.0))
                   for p, n in zip(prompts, max_new)]
        results = [f.result(timeout=60) for f in futures]
        stats = s.stats()
    assert stats["requests_completed"] == 8
    assert stats["tokens_emitted"] == sum(max_new)
    for prompt, n, result, want in zip(prompts, max_new, results,
                                       jax_greedy):
        # A shorter budget is a prefix of the longer greedy decode.
        np.testing.assert_array_equal(result.tokens,
                                      want[:len(prompt) + n])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_sampled_requests_equal_solo_generate(models, kv_dtype):
    _, _, tmodel = models
    prompts = _prompts(6, seed=1)
    configs = [dict(temperature=0.8, top_k=20), dict(temperature=1.0),
               dict(temperature=0.7, top_p=0.9), dict(temperature=0.0),
               dict(temperature=1.2, top_k=5, top_p=0.8, eos_token=7),
               dict(temperature=0.9)]
    with Scheduler(tmodel, slots=4, page_size=8, kv_dtype=kv_dtype) as s:
        futures = [s.submit(ServeRequest(p, 11, rng_seed=100 + i, **cfg))
                   for i, (p, cfg) in enumerate(zip(prompts, configs))]
        results = [f.result(timeout=60) for f in futures]
    for i, (prompt, cfg, result) in enumerate(zip(prompts, configs,
                                                  results)):
        solo = generate(tmodel, [prompt], 11, seed=100 + i,
                        kv_dtype=kv_dtype, **cfg)[0].numpy()
        np.testing.assert_array_equal(result.tokens, solo)


def test_assert_drained_leaves_every_page_free(models):
    _, _, tmodel = models
    sched = Scheduler(tmodel, slots=2, page_size=8)
    fetches = runtime.transfer_stats()["d2h_fetches"]
    with sched:
        futures = [sched.submit(ServeRequest(p, 5, temperature=0.0))
                   for p in _prompts(5, seed=2)]
        for f in futures:
            f.result(timeout=60)
        sched.assert_drained()
        # One counted fetch per prefill (first token) and per tick.
        assert (runtime.transfer_stats()["d2h_fetches"] - fetches
                >= 5 + sched.stats()["ticks"])
        assert sched.pool.leak_report() == {}
        assert sched.pool.available() == sched.pool.capacity
        leaked = sched.pool.reserve(1)
        with pytest.raises(RuntimeError, match="leak"):
            sched.assert_drained()
        sched.pool.free(leaked)


def test_unsupported_options_raise(models):
    _, _, tmodel = models
    for kwargs in (dict(prefix_cache=True), dict(spec_k=2),
                   dict(draft_model=tmodel), dict(prefill_chunk=16),
                   dict(host_tier=True), dict(ladder=(2, 4)),
                   dict(slo_ttft=0.5), dict(slots_max=8),
                   dict(admission_model="m.json"),
                   dict(strict_no_retrace=True)):
        name = next(iter(kwargs))
        with pytest.raises(NotImplementedError, match=name):
            Scheduler(tmodel, slots=2, page_size=8, **kwargs)
    with pytest.raises(TypeError):
        Scheduler(tmodel, slots=2, page_size=8, no_such_option=1)
    with pytest.raises(ValueError, match="kv_dtype"):
        Scheduler(tmodel, slots=2, page_size=8, kv_dtype="fp8")
    engine = Scheduler(tmodel, slots=2, page_size=8).engine
    with pytest.raises(NotImplementedError, match="prefix"):
        engine.prefill([1, 2, 3], 4, 0, dict(temperature=0.0, top_k=None,
                                             top_p=None, eos_token=None),
                       prefix_len=1)
    with pytest.raises(NotImplementedError):
        engine.resize(4, [0, 1, -1, -1])


def test_submit_validates_and_degenerate_budgets(models):
    _, _, tmodel = models
    sched = Scheduler(tmodel, slots=2, page_size=8)
    with pytest.raises(ValueError, match="max_seq_len"):
        sched.submit(ServeRequest([1] * 60, 8))
    with pytest.raises(ValueError, match="non-empty"):
        sched.submit(ServeRequest([], 2))
    with pytest.raises(ValueError, match="top_k"):
        sched.submit(ServeRequest([1], 2, top_k=65))
    zero = sched.submit(ServeRequest([4, 5], 0)).result(timeout=5)
    np.testing.assert_array_equal(zero.tokens, [4, 5])
    with sched:
        one = sched.submit(ServeRequest([4, 5], 1, temperature=0.0))
        assert one.result(timeout=60).tokens.shape == (3,)
        sched.assert_drained()


def test_page_pool_copy_accounts_like_the_original():
    pool = PagePool(5, 16, 4)
    pages = pool.reserve(4)
    assert sorted(pages) == [1, 2, 3, 4]
    assert pool.reserve(1, timeout=0.01) is None
    pool.share(pages[:1])
    pool.free(pages)
    assert pool.leak_report() == {pages[0]: 1}
    assert pool.pages_needed(8, 9) == 1


def test_concurrent_submitters_stress(models):
    """Eight submitter threads against both scheduler threads with a
    short switch interval: every request completes with its solo
    greedy tokens and every page comes back (a lost update in the
    pending count, the counters or the pool would break one of these).
    """
    _, _, tmodel = models
    prompts = _prompts(8, seed=3) * 3
    results = [None] * len(prompts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Scheduler(tmodel, slots=3, page_size=8) as sched:
            def submit(i):
                results[i] = sched.submit(ServeRequest(
                    prompts[i], 4, temperature=0.0)).result(timeout=60)

            threads = [threading.Thread(target=lambda k=k: [
                submit(i) for i in range(k, len(prompts), 8)])
                for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            sched.assert_drained()
            assert sched.stats()["requests_completed"] == len(prompts)
    finally:
        sys.setswitchinterval(interval)
    for prompt, result in zip(prompts, results):
        solo = generate(tmodel, [prompt], 4, temperature=0.0)[0].numpy()
        np.testing.assert_array_equal(result.tokens, solo)
