"""The port's prefix cache against the JAX package on the CPU: the radix
trie (`serving/prefixcache.py`, host-only) against JAX's on the same
sequences of operations, the engine's prefix gather and hit prefill
against its whole prefill, and the scheduler with the cache on and off,
for fp and int8 pages, against JAX's `generate()` (greedy) and the
port's solo `generate()` (sampled), at `test_torch_serving.py`'s size (2
layers, d 64, max_seq_len 64, f32).

Tolerances, with their reasons:
- the trie: exact (host integers on both sides);
- a hit prefill's dense cache against the whole prefill's: exact for
  the gathered prefix of fp pages (the pages hold the whole prefill's
  values), 1e-5 for the suffix positions (the suffix window is another
  matrix shape: other f32 summation orders), int8 prefixes within their
  quantisation step;
- served tokens: exact (greedy: f32 logits agree with JAX's within
  ~1e-6 and no argmax near-tie of this model and these prompts falls
  inside that; sampled: the same draws on logits that agree as above).
  A hit over int8 pages prefills its suffix against the dequantized
  prefix, which `generate()` never sees (JAX's engine does the same):
  its greedy oracle is JAX's own scheduler with int8 pages and the
  prefix cache, fed the same requests in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu.serving import kvpool as jkvpool
from cloud_tpu.serving import prefixcache as jprefix
from cloud_tpu_torch.models import TransformerLM, generate, params_from_flax
from cloud_tpu_torch.serving import (PagePool, PrefixCache, Scheduler,
                                     ServeRequest)
from cloud_tpu_torch.serving.engine import DecodeEngine

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=64)
PAGE = 8
GREEDY = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)


# -- the trie against JAX's -------------------------------------------------

def _script(name, pool_cls, trie_cls):
    """Runs one scenario of trie operations on a package's PagePool and
    PrefixCache; returns everything observable, in order."""
    out = []
    pool = pool_cls(12, 4, 8)
    trie = trie_cls(pool, max_pages=(2 if name == "budget" else 8
                                     if name == "lru" else None))

    def match(tokens):
        m = trie.match(tokens)
        out.append(("match", list(m.pages), m.prefix_len, m.partial_page,
                    m.partial_len))
        return m

    pages = pool.reserve(3)
    prompt = list(range(1, 14))
    if name == "full_pages":
        out.append(("registered", trie.register(prompt, pages)))
        m = match(prompt + [99])
        out.append(("refs", [pool.refcount(p) for p in pages]))
        pool.free(m.pages)
    elif name == "cap":
        trie.register(prompt[:8], pages[:2])
        match(prompt[:8])
        match(prompt[:9])
    elif name == "partial":
        trie.register(prompt[:9], pages[:2])
        m = match(prompt[:6] + [50, 51, 52])
        pool.free(m.pages + [m.partial_page])
        match(prompt[:2] + [60, 61, 62, 63, 64])
    elif name == "probe":
        trie.register(prompt[:9], pages[:2])
        out.append(("probe", trie.probe(prompt[:9] + [99]),
                    trie.probe([40, 41, 42]), trie.probe(prompt[:7])))
        out.append(("refs", [pool.refcount(p) for p in pages]))
    elif name == "first_writer":
        other = pool.reserve(1)
        trie.register(prompt[:5], pages[:1])
        out.append(("registered", trie.register(prompt[:5], other)))
        match(prompt[:5] + [9])
    elif name == "lru":
        trie.register([1, 2, 3, 4, 5], pages[:1])
        trie.register([6, 7, 8, 9, 10], pages[1:2])
        pool.free(pages[:1])
        out.append(("evicted", trie.evict(1), trie.evict(1)))
        out.append(("probe", trie.probe([1, 2, 3, 4, 5]),
                    trie.probe([6, 7, 8, 9, 10])))
    elif name == "budget":
        trie.register(list(range(1, 10)), pages[:2])
        pool.free(pages[:2])
        more = pool.reserve(2)
        trie.register(list(range(20, 29)), more)
    elif name == "clear":
        trie.register(prompt, pages)
        pool.free(pages)
        out.append(("available", pool.available()))
        trie.clear()
        out.append(("cleared", pool.available(), pool.leak_report(),
                    trie.held_pages()))
    out.append(("stats", trie.stats()))
    out.append(("held", trie.held_pages()))
    out.append(("pool", pool.pool_stats()))
    return out


@pytest.mark.parametrize("name", ["full_pages", "cap", "partial", "probe",
                                  "first_writer", "lru", "budget", "clear"])
def test_trie_equals_jax(name):
    assert (_script(name, PagePool, PrefixCache)
            == _script(name, jkvpool.PagePool, jprefix.PrefixCache))


# -- the engine's hit prefill ---------------------------------------------

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


@pytest.mark.parametrize("page_dtype", ["", "int8"])
@pytest.mark.parametrize("prefix_len", [8, 13])
def test_hit_prefill_equals_whole_prefill(models, page_dtype, prefix_len):
    """A miss of the shared prompt is inserted; a hit over its first
    `prefix_len` positions (one full page, or a page and a partial one)
    gives the whole prefill's first token and dense cache."""
    _, _, tmodel = models
    engine = DecodeEngine(tmodel, 2, PAGE, 2 * CFG["max_seq_len"] // PAGE
                          + 1, page_dtype=page_dtype)
    rng = np.random.default_rng(3)
    base = rng.integers(1, 64, size=20).tolist()
    vec = 1 + np.arange(engine.pages_per_slot)
    engine.insert(0, engine.prefill(base, 4, 0, GREEDY), vec, vec, GREEDY)
    prompt = base[:prefix_len] + rng.integers(1, 64, size=9).tolist()
    sampled = dict(GREEDY, temperature=0.8, top_k=20)
    for sampling in (GREEDY, sampled):
        whole = engine.prefill(prompt, 4, 7, sampling)
        hit = engine.prefill(prompt, 4, 7, sampling, prefix_len=prefix_len,
                             gather_vec=vec[:-(-prefix_len // PAGE)])
        assert hit.first_token == whole.first_token
        assert hit.bucket == 16 and whole.bucket == 32
        np.testing.assert_array_equal(hit.step_seeds, whole.step_seeds)
        # The right pads differ (the hit's window is another bucket) and
        # are never read: the real positions are compared.
        hs, ws = hit.pcache["store"], whole.pcache["store"]
        for name in ("slot_valid", "token_count"):
            assert torch.equal(hs[name], ws[name]), name
        valid = ws["slot_valid"][0]
        assert torch.equal(hs["slot_pos"][0, valid], ws["slot_pos"][0, valid])
        kv_hit = hs["kv"][:, :, 0, valid]
        kv_whole = ws["kv"][:, :, 0, valid]
        if page_dtype:
            step = kv_whole[:, :, :prefix_len].abs().amax() / 127
            assert (kv_hit[:, :, :prefix_len]
                    - kv_whole[:, :, :prefix_len]).abs().max() <= step
        else:
            assert torch.equal(kv_hit[:, :, :prefix_len],
                               kv_whole[:, :, :prefix_len])
            torch.testing.assert_close(kv_hit, kv_whole, rtol=1e-5,
                                       atol=1e-5)
        engine.release_prefill(hit)
        engine.release_prefill(whole)


# -- the scheduler -----------------------------------------------------------

def _prefix_prompts(seed=0):
    """Prompts over two shared roots (full-page and mid-page
    divergences), and distinct ones."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(1, 64, size=n).tolist() for n in (27, 19)]
    prompts = []
    for i, cut in enumerate((27, 20, 16, 11, 27, 9)):
        prompts.append(roots[0][:cut] + rng.integers(
            1, 64, size=2 + i % 3).tolist())
    for cut in (19, 12, 17):
        prompts.append(roots[1][:cut] + rng.integers(1, 64, size=3).tolist())
    prompts += [rng.integers(1, 64, size=n).tolist() for n in (14, 5)]
    return prompts


_MAX_NEW = 7


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX `generate()` of each greedy request (one left-padded batch)."""
    jmodel, params, _ = models
    prompts = _prefix_prompts()
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


@pytest.fixture(scope="module")
def jax_served_int8(models):
    """JAX's scheduler (int8 pages, prefix cache on) over the greedy
    requests, one at a time."""
    from cloud_tpu.serving import Scheduler as JScheduler
    from cloud_tpu.serving import ServeRequest as JRequest

    jmodel, params, _ = models
    with JScheduler(jmodel, params, slots=3, page_size=PAGE,
                    kv_dtype="int8", prefix_cache=True) as sched:
        return [np.asarray(sched.submit(JRequest(
            p, _MAX_NEW, temperature=0.0)).result(timeout=300).tokens)
            for p in _prefix_prompts()]


def _serve_sequential(sched, requests):
    """One at a time, so that each request finds the earlier ones'
    pages registered."""
    return [sched.submit(r).result(timeout=120) for r in requests]


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_greedy_hits_equal_jax_generate(models, jax_greedy, kv_dtype,
                                        prefix_cache, request):
    _, _, tmodel = models
    if kv_dtype and prefix_cache:
        jax_greedy = request.getfixturevalue("jax_served_int8")
    prompts = _prefix_prompts()
    requests = [ServeRequest(p, _MAX_NEW, temperature=0.0) for p in prompts]
    with Scheduler(tmodel, slots=3, page_size=PAGE, kv_dtype=kv_dtype,
                   prefix_cache=prefix_cache) as sched:
        results = _serve_sequential(sched, requests)
        stats = sched.stats()
        sched.assert_drained()
        sched.assert_drained(clear_prefix=True)
        assert sched.pool.available() == sched.pool.capacity
    for result, want in zip(results, jax_greedy):
        np.testing.assert_array_equal(result.tokens, want)
    hits = [r.prefix_len for r in results]
    if prefix_cache:
        assert stats["prefix_hits"] == sum(1 for h in hits if h) >= 7
        assert stats["prefix_tokens_served"] == sum(hits)
        assert stats["pool"]["cow_copies"] >= 1
        assert stats["ttft_hit"]["count"] == stats["prefix_hits"]
    else:
        assert not any(hits) and stats["prefix_hits"] == 0
        assert "prefix_cache" not in stats


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_sampled_hits_equal_solo_generate(models, kv_dtype):
    """Sampled hits (served concurrently after a seeding request) equal
    the port's solo `generate()` with the same seed."""
    _, _, tmodel = models
    prompts = _prefix_prompts(seed=1)
    configs = [dict(temperature=0.8, top_k=20), dict(temperature=1.0),
               dict(temperature=0.7, top_p=0.9),
               dict(temperature=1.2, top_k=5, top_p=0.8, eos_token=7)]
    requests = [ServeRequest(p, _MAX_NEW, rng_seed=300 + i,
                             **configs[i % len(configs)])
                for i, p in enumerate(prompts)]
    with Scheduler(tmodel, slots=4, page_size=PAGE,
                   kv_dtype=kv_dtype) as sched:
        first = _serve_sequential(sched, requests[:1])
        futures = [sched.submit(r) for r in requests[1:]]
        results = first + [f.result(timeout=120) for f in futures]
        assert sched.stats()["prefix_hits"] >= 1
        sched.assert_drained(clear_prefix=True)
    for req, result in zip(requests, results):
        solo = generate(tmodel, [req.prompt], req.max_new_tokens,
                        seed=req.rng_seed, temperature=req.temperature,
                        top_k=req.top_k, top_p=req.top_p,
                        eos_token=req.eos_token, page_size=PAGE,
                        kv_dtype=kv_dtype)[0].numpy()
        np.testing.assert_array_equal(result.tokens, solo)


def test_cow_never_writes_a_shared_page(models):
    """Divergent hits (mid-page) rebuild the divergent page in a fresh
    page: the registered pages' content does not change while they are
    shared."""
    _, _, tmodel = models
    rng = np.random.default_rng(5)
    root = rng.integers(1, 64, size=30).tolist()
    with Scheduler(tmodel, slots=2, page_size=PAGE) as sched:
        _serve_sequential(sched, [ServeRequest(root, 3, temperature=0.0)])
        held = sched.trie.held_pages()
        assert len(held) == 3
        layer = sched.engine.cache["layers"][0]
        before = layer["key_pages"][held].clone()
        requests = [ServeRequest(root[:cut] + [63, 62, 61], 5,
                                 temperature=0.0)
                    for cut in (21, 13, 5, 23)]
        results = _serve_sequential(sched, requests)
        assert [r.prefix_len for r in results] == [21, 13, 5, 23]
        assert torch.equal(layer["key_pages"][held], before)
        assert sched.stats()["pool"]["cow_copies"] == 4
        sched.assert_drained(clear_prefix=True)


def test_tight_budget_evicts_and_completes_every_request(models):
    _, _, tmodel = models
    prompts = _prefix_prompts(seed=2)
    pages_per_slot = CFG["max_seq_len"] // PAGE
    with Scheduler(tmodel, slots=2, page_size=PAGE,
                   num_pages=2 * pages_per_slot + 5,
                   prefix_cache_pages=3) as sched:
        futures = [sched.submit(ServeRequest(p, _MAX_NEW, temperature=0.0))
                   for p in prompts]
        results = [f.result(timeout=120) for f in futures]
        stats = sched.stats()
        assert stats["prefix_cache"]["pages_held"] <= 3
        assert stats["prefix_cache"]["evictions"] >= 1
        sched.assert_drained()
        sched.assert_drained(clear_prefix=True)
        assert sched.pool.leak_report() == {}
    for prompt, result in zip(prompts, results):
        assert result.tokens.shape == (len(prompt) + _MAX_NEW,)


def test_warmup_drives_the_prefix_path_and_leaves_no_state(models):
    """`warmup()` with the cache on drives every width up to the largest
    bucket and the shared-prefix trio, then clears the trie and the
    stats; the sentinel never fires on the CPU (nothing is captured)."""
    _, _, tmodel = models
    with Scheduler(tmodel, slots=2, page_size=PAGE,
                   strict_no_retrace=True) as sched:
        sched.warmup([8, 32])
        stats = sched.stats()
        assert stats["requests_completed"] == 0
        assert stats["prefix_cache"]["pages_held"] == 0
        assert stats["graphs"]["captures"] == 0
        sched.engine.check_no_retrace()
        prompt = _prefix_prompts()[0]
        _serve_sequential(sched, [ServeRequest(prompt, 3, temperature=0.0)
                                  for _ in range(2)])
        assert sched.stats()["prefix_hits"] == 1
        sched.assert_drained(clear_prefix=True)
