"""Shared KV-cache slot bookkeeping and sampling for decode-mode
attention; the port of `cloud_tpu/models/decoding.py`.

Caches are plain dicts (built by `TransformerLM.init_cache` and
`LlamaLM.init_cache`), updated in place: a decode call writes its K/V
and bookkeeping into the tensors it is given, where the JAX package
returns a new cache tree. One attention layer's dense cache holds K/V
[B, L, H_kv, D] in the compute dtype and

  cache_index  slot write pointer (shared across examples)
  slot_valid   [B, L]   True where a real token was written
  slot_pos     [B, L]   the slot's LOGICAL position (real tokens only)
  token_count  [B]      number of real tokens seen per example

and a paged cache (one row per serving slot) holds

  slot_steps   [S]      per-slot write pointer (tokens written)
  slot_valid   [S, L]   True where a real token was written

beside its page arrays (see `TransformerLM.init_cache`).

`LlamaLM`'s dense cache (`dense_cache_layer`) keeps `cache_index` as a
host int (`decode_slot_update`). `TransformerLM`'s caches
(`transformer_dense_cache`, and the paged pool) are the ones the
serving engine replays as CUDA graphs, so every piece of their state
lives on the device and moves in place: `cache_index` is a 0-d int64
tensor (`dense_slot_update`), and the bookkeeping tensors are one set
shared by every layer, updated once per decode call. A graph then
replays at whatever depth its cache holds, as JAX's one executable
serves a prefill at any start.

Sampling draws from `torch.Generator`s seeded per step: a request's
seed gives one int64 seed per generated token (`sample_seeds`; column
0 for the prefill draw, column i for step i), the analogue of
`generate()`'s split key schedule, so the serving engine and a solo
`generate()` consume the same noise.

`acquire_cache` / `release_cache` recycle dense decode caches between
`generate()` calls (a pool keyed on the decoder and the batch, re-zeroed
in place), and `decode_latency_start` / `decode_latency_finish` feed the
per-token decode latency to `monitoring.telemetry` when it is enabled.
"""

import sys
import threading
import time

import numpy as np
import torch

_NEG_INF = -1e30


def decode_slot_update(cache, mask, batch, seq, cache_len):
    """Advance a dense decode cache's slot bookkeeping for one call.

    mask: optional [B, S] marking REAL incoming tokens (None = all).

    Returns (idx, positions, allowed):
      idx        the write pointer BEFORE this call (callers write
                 their k/v tensors at slots [idx, idx+S));
      positions  [B, S] logical position of each incoming token (#real
                 tokens before it, per example);
      allowed    [B, S, L] bool: slot-order causality AND slot validity.
    """
    device = cache["slot_valid"].device
    m = (torch.ones((batch, seq), dtype=torch.int32, device=device)
         if mask is None else mask.to(torch.int32))
    idx = int(cache["cache_index"])
    if idx + seq > cache_len:
        raise ValueError(
            "decode writes [{}, {}) past the cache length {}.".format(
                idx, idx + seq, cache_len))
    positions = (cache["token_count"][:, None] + torch.cumsum(m, 1)
                 - m).to(torch.int32)
    cache["slot_valid"][:, idx:idx + seq] = m.bool()
    cache["slot_pos"][:, idx:idx + seq] = positions
    cache["cache_index"] = idx + seq
    cache["token_count"] += m.sum(dim=1).to(torch.int32)
    key_slots = torch.arange(cache_len, device=device)
    query_slots = idx + torch.arange(seq, device=device)
    allowed = (cache["slot_valid"][:, None, :]
               & (key_slots[None, None, :] <= query_slots[None, :, None]))
    return idx, positions, allowed


def dense_slot_update(cache, mask, batch, seq):
    """`decode_slot_update` for a cache whose write pointer
    `cache_index` is a 0-d int64 device tensor: the pointer is read and
    advanced on the device only (no host read, so a CUDA graph of the
    call replays at any depth). The caller keeps the writes inside the
    cache (the engine's prefill checks prefix + bucket on the host), as
    JAX's dynamic_update_slice leaves it to its caller.

    Returns (slots, allowed):
      slots    [seq] int64: the cache slots this call writes;
      allowed  [B, seq, L] bool: slot-order causality AND validity.
    """
    device = cache["slot_valid"].device
    cache_len = cache["slot_valid"].shape[1]
    m = (torch.ones((batch, seq), dtype=torch.int32, device=device)
         if mask is None else mask.to(torch.int32))
    idx = cache["cache_index"]
    slots = idx + torch.arange(seq, device=device)
    positions = (cache["token_count"][:, None] + torch.cumsum(m, 1)
                 - m).to(torch.int32)
    cache["slot_valid"].index_copy_(1, slots, m.bool())
    cache["slot_pos"].index_copy_(1, slots, positions)
    idx.add_(seq)
    cache["token_count"] += m.sum(dim=1).to(torch.int32)
    key_slots = torch.arange(cache_len, device=device)
    allowed = (cache["slot_valid"][:, None, :]
               & (key_slots[None, None, :] <= slots[None, :, None]))
    return slots, allowed


def paged_slot_update(cache, mask, slots, seq, cache_len):
    """The per-slot counterpart of `decode_slot_update` for decode over
    a paged pool: slot s sits at its own depth `slot_steps[s]`, and an
    inactive slot (mask 0) does not move.

    Returns (pos, allowed):
      pos      [S, seq] int64 write position of each token (the slot's
               pointer plus the real tokens before it);
      allowed  [S, seq, L] bool mask over each slot's LOGICAL view
               (validity AND causality up to each query's position).
    """
    device = cache["slot_valid"].device
    m = (torch.ones((slots, seq), dtype=torch.int32, device=device)
         if mask is None else mask.reshape(slots, seq).to(torch.int32))
    idx = cache["slot_steps"]
    pos = idx[:, None].long() + torch.cumsum(m, 1) - m
    # Masked write: active slots validate their positions; an inactive
    # slot ORs False at its (clamped) current position, which changes
    # nothing.
    clamped = pos.clamp(0, cache_len - 1)
    valid = cache["slot_valid"]
    valid.scatter_(1, clamped, valid.gather(1, clamped) | m.bool())
    idx += m.sum(dim=1).to(torch.int32)
    key_slots = torch.arange(cache_len, device=device)
    allowed = valid[:, None, :] & (key_slots[None, None, :]
                                   <= pos[:, :, None])
    return pos, allowed


def bucket_length(n, cap=None):
    """The decode prefill bucket for a prompt of length `n`: the next
    power of two >= n, clipped to `cap`. When `n` already exceeds
    `cap` the length is returned unchanged (bucketing pads, never
    truncates)."""
    if n < 1:
        raise ValueError(
            "bucket_length needs a positive length; got {}.".format(n))
    bucket = 1
    while bucket < n:
        bucket *= 2
    if cap is not None:
        if cap < n:
            return n
        bucket = min(bucket, cap)
    return bucket


def validate_prompt_mask(prompt_mask, batch, prompt_len, reader):
    """The left-padded variable-length prompt contract: prompt_mask is
    [batch, prompt_len] with every row's LAST column real."""
    pm = np.asarray(prompt_mask)
    if pm.shape != (batch, prompt_len):
        raise ValueError(
            "prompt_mask must be [batch, prompt_len] = {}; got "
            "{}.".format((batch, prompt_len), pm.shape))
    if not pm[:, -1].all():
        raise ValueError(
            "prompt_mask must be LEFT-padded (last column all real): "
            "{} reads the final prompt position.".format(reader))


def warp_logits(logits, temperature, top_k=None, top_p=None):
    """HF-warper-order logits processing: top-k (on raw logits) ->
    temperature -> top-p nucleus, over the last axis. temperature must
    be > 0. Nucleus membership is decided in descending sorted order
    (a stable ascending sort, flipped: among exact ties the higher
    vocab index ranks first) and scattered back to vocab order."""
    logits = logits.float()
    neg = torch.full((), _NEG_INF, device=logits.device)
    if top_k is not None:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    scaled = logits / float(temperature)
    if top_p is not None and top_p < 1.0:
        sort_idx = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
        probs = torch.softmax(scaled.gather(-1, sort_idx), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < float(top_p)
        keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx,
                                                      keep_sorted)
        scaled = torch.where(keep, scaled, neg)
    return scaled


def sample_seeds(seed, rows, n):
    """[rows, n] int64 per-draw seeds from a request seed: row r, column
    i seeds draw i of row r (0 = the prefill draw)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2 ** 62, (rows, max(int(n), 1)),
                         generator=gen, dtype=torch.int64).numpy()


def sample_one(logits, seed, temperature, top_k=None, top_p=None):
    """One draw from a [V] logits row: argmax when temperature is 0,
    else Gumbel-max over the warped logits with uniform noise from a
    generator seeded with `seed` on the logits' device. Returns a 0-d
    int64 tensor on that device."""
    logits = logits.float()
    if not temperature:
        return torch.argmax(logits, dim=-1)
    warped = warp_logits(logits[None], temperature, top_k, top_p)[0]
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(int(seed))
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(warped + gumbel, dim=-1)


def sample_slots(logits, seeds, temperature, top_k, top_p, greedy=None):
    """All-slot sampler over [S, V] logits: argmax for every row, then
    `sample_one` for each row whose (host) temperature is > 0. seeds,
    temperature, top_k, top_p: per-row host values (top_k/top_p None
    or a value per row). greedy: the rows' argmax when the caller has
    it (the engine's captured tick computes it in the graph); it is not
    written to. Returns [S] int64 on the logits' device."""
    if greedy is None:
        out = torch.argmax(logits.float(), dim=-1)
    else:
        out = greedy.clone()
    for row in np.flatnonzero(np.asarray(temperature) > 0):
        out[row] = sample_one(logits[row], seeds[row], temperature[row],
                              None if top_k is None else top_k[row],
                              None if top_p is None else top_p[row])
    return out


def _cache_shapes(decoder, batch):
    """{name: (shape, dtype)} of one attention layer's dense decode
    cache for `batch` rows of `decoder` (a `TransformerLM` or
    `LlamaLM`): K/V [B, L, H_kv, D] in the compute dtype (H_kv =
    num_kv_heads, or num_heads where the model has no GQA; L =
    max_seq_len) and the slot bookkeeping of `decode_slot_update`."""
    heads = getattr(decoder, "num_kv_heads", decoder.num_heads)
    length = decoder.max_seq_len
    kv = ((batch, length, heads, decoder.head_dim), decoder.compute_dtype)
    return {"cached_key": kv, "cached_value": kv,
            "slot_valid": ((batch, length), torch.bool),
            "slot_pos": ((batch, length), torch.int32),
            "token_count": ((batch,), torch.int32)}


def dense_cache_layer(decoder, batch):
    """One attention layer's zeroed dense decode cache (`_cache_shapes`)
    on the decoder's device, write pointer `cache_index` at 0."""
    layer = {name: torch.zeros(shape, dtype=dtype, device=decoder.device)
             for name, (shape, dtype) in _cache_shapes(decoder,
                                                       batch).items()}
    layer["cache_index"] = 0
    return layer


def transformer_dense_cache(decoder, batch):
    """A zeroed dense decode cache for `batch` rows of a `TransformerLM`:
    the K/V of every layer in one tensor `store["kv"]` [layers, 2, B, L,
    H, D] (each layer's `cached_key` / `cached_value` are views of it),
    and one set of bookkeeping tensors that every layer's dict shares,
    the write pointer a 0-d int64 tensor. `store` lists the backing
    tensors, so a cache is zeroed or copied in a few launches."""
    (kv_shape, dtype) = _cache_shapes(decoder, batch)["cached_key"]
    dev = decoder.device
    kv = torch.zeros((decoder.num_layers, 2) + kv_shape, dtype=dtype,
                     device=dev)
    store = {"kv": kv}
    for name, (shape, dt) in _cache_shapes(decoder, batch).items():
        if name not in ("cached_key", "cached_value"):
            store[name] = torch.zeros(shape, dtype=dt, device=dev)
    store["cache_index"] = torch.zeros((), dtype=torch.int64, device=dev)
    shared = {k: v for k, v in store.items() if k != "kv"}
    layers = [dict(shared, kv=kv[i], cached_key=kv[i, 0],
                   cached_value=kv[i, 1])
              for i in range(decoder.num_layers)]
    return {"pos_count": torch.zeros((batch,), dtype=torch.int32,
                                     device=dev),
            "layers": layers, "store": store}


def copy_cache(dst, src):
    """Copies dense decode cache `src` into `dst` (both from
    `transformer_dense_cache` of one decoder and batch), in place."""
    for name, value in dst["store"].items():
        value.copy_(src["store"][name])
    dst["pos_count"].copy_(src["pos_count"])
    return dst


def empty_cache(decoder, batch, **paged):
    """Zero-initialized decode cache for `batch` rows of a decoder
    (`paged` = page_size/num_pages/page_dtype for a `TransformerLM`
    page-pool cache). Every call allocates anew; `acquire_cache`
    recycles."""
    return decoder.init_cache(batch, **paged)


# -- decode-cache reuse pool -------------------------------------------------
#
# `empty_cache` allocates a whole KV cache per call, so a loop of
# generate() calls churns allocations of that size at request rate. The
# pool recycles them: `release_cache` parks a finished call's cache,
# `acquire_cache` zeroes a parked one in place and hands it back. Keyed on
# (decoder, batch), which fixes every tensor's shape; at most
# _CACHE_POOL_DEPTH caches a key; thread-safe.

_CACHE_POOL = {}
_CACHE_POOL_LOCK = threading.Lock()
_CACHE_POOL_DEPTH = 2


def _zero_in_place(cache):
    if "store" in cache:
        for value in cache["store"].values():
            value.zero_()
        cache["pos_count"].zero_()
        return cache
    for layer in cache["layers"]:
        for name, value in layer.items():
            if isinstance(value, torch.Tensor):
                value.zero_()
            else:
                layer[name] = 0
    for value in cache.values():
        if isinstance(value, torch.Tensor):
            value.zero_()
    return cache


def acquire_cache(decoder, batch, zero=True):
    """A zeroed dense decode cache for (decoder, batch): a parked one,
    zeroed in place, when the pool holds one; else `empty_cache`.
    zero=False skips the zeroing of a parked cache (the caller
    overwrites all of it, `copy_cache`)."""
    with _CACHE_POOL_LOCK:
        parked = _CACHE_POOL.get((decoder, batch))
        cache = parked.pop() if parked else None
    if cache is None:
        return empty_cache(decoder, batch)
    return _zero_in_place(cache) if zero else cache


def release_cache(decoder, batch, cache):
    """Parks a finished decode's cache for reuse; the caller must not
    touch it afterwards (the next acquire zeroes it). Drops it when the
    pool is full for the key."""
    if cache is None:
        return
    with _CACHE_POOL_LOCK:
        parked = _CACHE_POOL.setdefault((decoder, batch), [])
        if len(parked) < _CACHE_POOL_DEPTH:
            parked.append(cache)


def clear_cache_pool():
    """Empties the reuse pool (test isolation; frees the parked
    memory)."""
    with _CACHE_POOL_LOCK:
        _CACHE_POOL.clear()


def decode_latency_start():
    """Start handle (monotonic ns) of one generate() call for
    `decode_latency_finish`, or None when telemetry is off. The disabled
    path is one dict lookup: a telemetry module never imported is not
    enabled, and nothing is imported here."""
    telemetry = sys.modules.get("cloud_tpu_torch.monitoring.telemetry")
    if telemetry is None or not telemetry.enabled():
        return None
    return time.monotonic_ns()


def decode_latency_finish(start, n_tokens):
    """Completes a `decode_latency_start` handle: records one "decode"
    span and feeds the per-token decode latency histogram. Call it once
    the tokens are on the host (`generate()` fetches them first, so the
    queued work has run). No-op for a None handle."""
    if start is None:
        return
    telemetry = sys.modules.get("cloud_tpu_torch.monitoring.telemetry")
    tele = None if telemetry is None else telemetry.get()
    if tele is None or not tele.active:
        return
    elapsed_ns = time.monotonic_ns() - start
    from cloud_tpu_torch.monitoring import spans

    spans.complete("decode", start, elapsed_ns)
    tele.observe_decode(n_tokens, elapsed_ns / 1e9)


def prefill_request(model, prompt, seed, sampling):
    """Canonical right-pad prefill of ONE request (`generate()`'s; the
    serving engine runs the same steps, `prefill_window`): the prompt's
    tokens at cache slots [0, n), padded on the right to
    `bucket_length(n, max_seq_len)` with invalid slots, through a dense
    decode cache from `acquire_cache` (give it back with
    `release_cache`); the first token is drawn from the last real
    position's logits with draw seed `seed`.

    Returns (first_token 0-d device tensor, dense cache, bucket).
    """
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    n = int(prompt.shape[0])
    bucket = bucket_length(n, model.max_seq_len)
    tokens = np.zeros((1, bucket), np.int64)
    tokens[0, :n] = prompt
    mask = np.zeros((1, bucket), bool)
    mask[0, :n] = True
    cache = acquire_cache(model, 1)
    dev = model.device
    row = prefill_window(model, cache, torch.from_numpy(tokens).to(dev),
                         torch.from_numpy(mask).to(dev),
                         torch.full((1,), n - 1, dtype=torch.int64,
                                    device=dev))
    first = sample_one(row[0], seed, sampling["temperature"],
                       sampling["top_k"], sampling["top_p"])
    return first, cache, bucket


def prefill_window(model, cache, tokens, mask, last):
    """One prefill window of a `TransformerLM` through dense `cache`:
    tokens / mask [1, W] (mask marks the real tokens), appended at the
    cache's write pointer; returns the f32 logits [1, V] of window
    position `last` ([1] int64 device tensor) alone: the head runs on
    that row only, by the same steps for every window width."""
    with torch.no_grad():
        hidden = model.decode_hidden(tokens, mask, cache)
        return model.head(hidden.index_select(1, last))[:, 0]


def scatter_prefill(cache, pcache, slot, page_vec, scatter_vec):
    """Writes one request's dense [1, L] prefill cache into slot `slot`
    of a paged cache, in place: chunk i of the dense view goes to page
    scatter_vec[i] (scratch page 0 where nothing is owned), the page
    table row becomes page_vec, and the slot's pointer is the request's
    REAL token count (the right-pad is overwritten by decode writes).

    Int8 pools quantize per chunk per head here: invalid (pad)
    positions are zeroed before the amax, and each written page's scale
    resets to its chunk amax / 127.
    """
    pages = cache["pages"]                     # [layers, 2, N, P, H, D]
    layers, _, _, page, heads, head_dim = pages.shape
    book = cache["layers"][0]
    ppn = book["page_table"].shape[1]
    device = pages.device
    idx = torch.as_tensor(scatter_vec, dtype=torch.long).to(device)
    chunks = pcache["store"]["kv"].reshape(layers, 2, ppn, page, heads,
                                           head_dim)
    patt = pcache["layers"][0]
    if "scales" in cache:
        vm = patt["slot_valid"][0].float().reshape(ppn, page)[
            :, :, None, None]
        chunks, scale = _quantize_chunks(chunks, vm)
        cache["scales"][:, :, idx] = scale
    pages[:, :, idx] = chunks.to(pages.dtype)
    # The slot's bookkeeping is shared by every layer (one write).
    book["page_table"][slot] = torch.as_tensor(
        page_vec, dtype=torch.int32).to(device)
    book["slot_steps"][slot] = patt["token_count"][0]
    book["slot_valid"][slot] = patt["slot_valid"][0]
    cache["pos_count"][slot] = pcache["pos_count"][0]


def _quantize_chunks(chunks, valid):
    """[..., ppn, P, H, D] chunks (every layer's K and V at once) to int8
    with one scale per page and head: the amax over each page's valid
    positions and D, / 127."""
    cf = chunks.float() * valid
    scale = cf.abs().amax(dim=(-3, -1)) / 127.0  # [..., ppn, H]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(cf / safe[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


__all__ = ["acquire_cache", "bucket_length", "clear_cache_pool",
           "copy_cache", "decode_latency_finish", "decode_latency_start",
           "decode_slot_update", "dense_cache_layer", "dense_slot_update",
           "empty_cache", "paged_slot_update", "prefill_request",
           "prefill_window", "release_cache", "sample_one", "sample_seeds",
           "sample_slots", "scatter_prefill", "transformer_dense_cache",
           "validate_prompt_mask", "warp_logits"]
