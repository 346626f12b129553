"""Shared KV-cache slot bookkeeping and sampling for decode-mode
attention; the port of `cloud_tpu/models/decoding.py`.

Caches are plain dicts (built by `TransformerLM.init_cache` and
`LlamaLM.init_cache`), updated in place: a decode call writes its K/V
and bookkeeping into the tensors it is given, where the JAX package
returns a new cache tree. One attention layer's dense cache
(`dense_cache_layer`) holds K/V [B, L, H_kv, D] in the compute dtype and

  cache_index  int      slot write pointer (shared across examples)
  slot_valid   [B, L]   True where a real token was written
  slot_pos     [B, L]   the slot's LOGICAL position (real tokens only)
  token_count  [B]      number of real tokens seen per example

and a paged cache (one row per serving slot) holds

  slot_steps   [S]      per-slot write pointer (tokens written)
  slot_valid   [S, L]   True where a real token was written

beside its page arrays (see `TransformerLM.init_cache`).

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
    cache["slot_steps"] = (idx + m.sum(dim=1)).to(torch.int32)
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


def sample_slots(logits, seeds, temperature, top_k, top_p):
    """All-slot sampler over [S, V] logits: argmax for every row, then
    `sample_one` for each row whose (host) temperature is > 0. seeds,
    temperature, top_k, top_p: per-row host values (top_k/top_p None
    or a value per row). Returns [S] int64 on the logits' device."""
    out = torch.argmax(logits.float(), dim=-1)
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


def acquire_cache(decoder, batch):
    """A zeroed dense decode cache for (decoder, batch): a parked one,
    zeroed in place, when the pool holds one; else `empty_cache`."""
    with _CACHE_POOL_LOCK:
        parked = _CACHE_POOL.get((decoder, batch))
        cache = parked.pop() if parked else None
    if cache is None:
        return empty_cache(decoder, batch)
    return _zero_in_place(cache)


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
    """Canonical right-pad prefill of ONE request, shared by the serving
    engine and `generate()`: the prompt's tokens at cache slots
    [0, n), padded on the right to `bucket_length(n, max_seq_len)`
    with invalid slots, through the dense decode cache; the first token
    is drawn from the last real position with draw seed `seed`.

    Returns (first_token 0-d device tensor, dense cache, bucket).
    """
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    n = int(prompt.shape[0])
    bucket = bucket_length(n, model.max_seq_len)
    tokens = np.zeros((1, bucket), np.int64)
    tokens[0, :n] = prompt
    mask = np.zeros((1, bucket), bool)
    mask[0, :n] = True
    cache = model.init_cache(1)
    logits = model(torch.from_numpy(tokens).to(model.device),
                   torch.from_numpy(mask).to(model.device), cache)
    first = sample_one(logits[0, n - 1], seed, sampling["temperature"],
                       sampling["top_k"], sampling["top_p"])
    return first, cache, bucket


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
    page_vec = torch.as_tensor(page_vec, dtype=torch.int32)
    scatter_idx = torch.as_tensor(scatter_vec, dtype=torch.long)
    for att, patt in zip(cache["layers"], pcache["layers"]):
        _, page, heads, head_dim = att["key_pages"].shape
        ppn = att["page_table"].shape[1]
        device = att["key_pages"].device
        idx = scatter_idx.to(device)
        chunks_k = patt["cached_key"][0].reshape(ppn, page, heads, head_dim)
        chunks_v = patt["cached_value"][0].reshape(ppn, page, heads,
                                                   head_dim)
        if "key_scales" in att:
            vm = patt["slot_valid"][0].float().reshape(ppn, page)[
                :, :, None, None]
            chunks_k, scale_k = _quantize_chunks(chunks_k, vm)
            chunks_v, scale_v = _quantize_chunks(chunks_v, vm)
            att["key_scales"][idx] = scale_k
            att["value_scales"][idx] = scale_v
        att["key_pages"][idx] = chunks_k.to(att["key_pages"].dtype)
        att["value_pages"][idx] = chunks_v.to(att["value_pages"].dtype)
        att["page_table"][slot] = page_vec.to(device)
        att["slot_steps"][slot] = patt["token_count"][0]
        att["slot_valid"][slot] = patt["slot_valid"][0]
    cache["pos_count"][slot] = pcache["pos_count"][0]


def _quantize_chunks(chunks, valid):
    cf = chunks.float() * valid
    scale = cf.abs().amax(dim=(1, 3)) / 127.0  # [ppn, H]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(cf / safe[:, None, :, None]), -127, 127)
    return q.to(torch.int8), scale


__all__ = ["acquire_cache", "bucket_length", "clear_cache_pool",
           "decode_latency_finish", "decode_latency_start",
           "decode_slot_update", "dense_cache_layer", "empty_cache",
           "paged_slot_update", "prefill_request", "release_cache",
           "sample_one", "sample_seeds", "sample_slots", "scatter_prefill",
           "validate_prompt_mask", "warp_logits"]
