"""Decoder-only Transformer LM (GPT-2 shaped); the port of
`cloud_tpu/models/transformer.py`.

Parameters are float32; matrix work runs in `compute_dtype` (bf16 by
default) with f32 attention logits and softmax, as the JAX model does,
except that the residual stream, the final norm and the output head
stay in f32 (the JAX model rounds them to the compute dtype). Training
and decode share the block code, so this holds for both.

Without a cache, a forward call is the training/scoring forward: causal
attention over the whole sequence through `ops.attention` (the flash
kernels on the card, forward and backward), positions 0..S-1, and
dropout when `deterministic=False` (drawn from the caller's
`torch.Generator`). Gradients reach the f32 parameters through their
compute-dtype copies.

With a cache dict (`init_cache`), a forward call decodes and updates the
cache in place (no gradients):

- a dense cache (`init_cache(batch)`) is the per-example KV cache of
  `generate()`'s prefill and of the serving engine's prefill;
- a paged cache (`init_cache(slots, page_size=, num_pages=)`) is the
  serving pool: K/V in a shared page pool addressed through per-slot
  page tables, attended by `ops.paged_attention` (the CUDA kernel on
  the card), with optional int8 pages (`page_dtype="int8"`).

With `moe_experts > 0` each block's MLP is the Switch top-1 MoE
(`models.moe.MoEMLP`, capacity factor 1.25, as the JAX block builds
it); a training forward in training mode leaves each block's aux loss in
`aux_losses` for the Trainer (JAX's sown "losses"). `generate()` and the
serving engine refuse such a model: their decode route (right-padded
prefill, paged decode, rows padded to 8) routes other rows than JAX's,
so under a binding capacity it would give other tokens (ROADMAP: Modules
to port, item 5).

Not ported (ROADMAP "Modules to port"): bidirectional blocks
(`causal=False`, the `TransformerEncoder`), which raise
NotImplementedError.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.moe import MoEMLP
from cloud_tpu_torch.ops import attention as attention_ops
from cloud_tpu_torch.parallel import runtime


class _ComputeWeights:
    """Parameters cast to the compute dtype. With grad enabled the cast
    is an autograd op, so the copy's gradient reaches the f32 parameter.
    Without grad (decode, evaluation) each copy is cast once and reused
    until the parameter changes (in-place update or new storage)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self._memo = {}

    def __call__(self, p):
        if p is None or p.dtype == self.dtype:
            return p
        if torch.is_grad_enabled():
            return p.to(self.dtype)
        key = id(p)
        stamp = (p._version, p.data_ptr())
        hit = self._memo.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        w = p.detach().to(self.dtype)
        self._memo[key] = (stamp, w)
        return w


def _linear(cast, layer, x):
    return F.linear(x.to(cast.dtype), cast(layer.weight), cast(layer.bias))


def _layer_norm(cast, norm, x):
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                     norm.bias, norm.eps)
    return y.to(cast.dtype)


def _dropout(x, rate, generator):
    """Inverted dropout (keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate)), drawn from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention with q/k/v/out projections
    (the JAX `DenseGeneral` [d, H, hd] kernels as `Linear`s)."""

    def __init__(self, d_model, num_heads, cast, device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model ({}) must be a multiple of num_heads "
                             "({}).".format(d_model, num_heads))
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self._cast = cast
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(d_model, d_model, device=device))

    def forward(self, x, mask, cache):
        batch, seq, _ = x.shape
        shape = (batch, seq, self.num_heads, self.head_dim)
        q = _linear(self._cast, self.query, x).view(shape)
        k = _linear(self._cast, self.key, x).view(shape)
        v = _linear(self._cast, self.value, x).view(shape)
        if cache is None:
            # Training / scoring: causal attention over the sequence, the
            # key mask (optional [B, S]) excluding padded keys.
            out = attention_ops.attention(q, k, v, causal=True, mask=mask)
        elif "key_pages" in cache:
            out = self._paged_decode_attention(q, k, v, mask, cache)
        else:
            out = self._decode_attention(q, k, v, mask, cache)
        out = out.to(self._cast.dtype).reshape(batch, seq, -1)
        return _linear(self._cast, self.out, out)

    def _decode_attention(self, q, k, v, mask, cache):
        """Dense KV-cache attention: append this call's K/V at the write
        pointer, then attend q against everything cached so far (f32
        logits and softmax, weights cast to the compute dtype)."""
        batch, seq = q.shape[:2]
        cache_len = cache["cached_key"].shape[1]
        idx, _, allowed = decoding.decode_slot_update(cache, mask, batch,
                                                      seq, cache_len)
        dtype = self._cast.dtype
        cache["cached_key"][:, idx:idx + seq] = k.to(dtype)
        cache["cached_value"][:, idx:idx + seq] = v.to(dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              cache["cached_key"].float())
        logits = logits * (1.0 / math.sqrt(self.head_dim))
        logits = torch.where(allowed[:, None], logits,
                             torch.full((), -1e30, device=logits.device))
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                           cache["cached_value"].float())
        return out.to(dtype)

    def _paged_decode_attention(self, q, k, v, mask, cache):
        """Decode over the paged pool: the batch dimension is SLOTS, each
        at its own depth. Token j of slot s is written at physical page
        page_table[s, pos // P], offset pos % P (inactive slots resolve
        to scratch page 0 through their zeroed table row), then
        `ops.paged_attention` attends each slot's logical view."""
        from cloud_tpu_torch.ops.paged_attention import paged_attention

        slots, seq = q.shape[:2]
        key_pages = cache["key_pages"]
        value_pages = cache["value_pages"]
        page_size = key_pages.shape[1]
        cache_len = cache["slot_valid"].shape[1]
        pos, allowed = decoding.paged_slot_update(cache, mask, slots, seq,
                                                  cache_len)
        table = cache["page_table"]
        page_idx = (pos // page_size).clamp(max=table.shape[1] - 1)
        phys = table.gather(1, page_idx).long()
        off = pos % page_size
        scales = {}
        if "key_scales" in cache:
            if mask is not None:
                # Invalid tokens are zeroed before quantizing so they
                # never inflate a real page's scale.
                m = mask.reshape(slots, seq).to(k.dtype)[:, :, None, None]
                k = k * m
                v = v * m
            _quantized_page_write(key_pages, cache["key_scales"], k, phys,
                                  off)
            _quantized_page_write(value_pages, cache["value_scales"], v,
                                  phys, off)
            scales = dict(key_scales=cache["key_scales"],
                          value_scales=cache["value_scales"])
        else:
            key_pages[phys, off] = k.to(key_pages.dtype)
            value_pages[phys, off] = v.to(value_pages.dtype)
        return paged_attention(q.contiguous(), key_pages, value_pages,
                               table, allowed,
                               sm_scale=1.0 / math.sqrt(self.head_dim),
                               **scales)


def _quantized_page_write(pages, scales, x, phys, off):
    """Writes [slots, seq, H, D] decode K/V into int8 pages with a
    per-page per-head amax rescale, in place.

    pages: [N, P, H, D] int8; scales: [N, H] f32; phys/off: [slots,
    seq] physical page / in-page offset of each token. Per position j
    the page's scale grows to cover the token (`new = max(old, amax /
    127)`), the page's existing block is rescaled by `old / new` (an
    exact no-op when the scale does not grow) and the token quantized
    at `new`. Returns (pages, scales).
    """
    slots, seq = x.shape[:2]
    xf = x.float()
    rows = torch.arange(slots, device=x.device)
    for j in range(seq):
        p = phys[:, j]
        o = off[:, j]
        xj = xf[:, j]                           # [slots, H, D]
        amax = xj.abs().amax(dim=-1)            # [slots, H]
        old = scales[p]
        new = torch.maximum(old, amax / 127.0)
        safe = torch.where(new > 0, new, torch.ones_like(new))
        factor = (old / safe)[:, None, :, None]
        block = torch.clamp(torch.round(pages[p].float() * factor),
                            -127, 127)
        block[rows, o] = torch.clamp(torch.round(xj / safe[:, :, None]),
                                     -127, 127)
        pages[p] = block.to(torch.int8)
        scales[p] = new
    return pages, scales


#: Why an MoE TransformerLM is not served (generate(), DecodeEngine).
MOE_DECODE_NOT_PORTED = (
    "generate() and serving of a TransformerLM with moe_experts > 0 are "
    "not ported (ROADMAP: Modules to port, item 5, serving): the port's "
    "TransformerLM decode route (right-padded prefill, paged decode, rows "
    "padded to 8) would route other rows than JAX's under a binding "
    "capacity, and so give other tokens.")


class TransformerBlock(nn.Module):
    """Pre-LN block: x + drop(attn(ln(x))), then x + drop(mlp(ln(x)))
    with tanh-approximate GELU (or the Switch MoE, `moe_experts > 0`);
    dropout only when `dropout_rate` > 0 and the forward is not
    deterministic."""

    def __init__(self, d_model, num_heads, d_ff, norm_eps, cast,
                 dropout_rate=0.0, causal=True, moe_experts=0, device=None):
        super().__init__()
        if not causal:
            raise NotImplementedError(
                "bidirectional blocks (TransformerEncoder) are not ported "
                "yet (ROADMAP: Modules to port, item 7).")
        self._cast = cast
        self.dropout_rate = float(dropout_rate)
        self.ln_attn = nn.LayerNorm(d_model, eps=norm_eps, device=device)
        self.attention = CausalSelfAttention(d_model, num_heads, cast,
                                             device=device)
        self.ln_mlp = nn.LayerNorm(d_model, eps=norm_eps, device=device)
        if moe_experts:
            self.moe = MoEMLP(d_model, num_experts=moe_experts, d_ff=d_ff,
                              compute_dtype=cast.dtype, cast=cast,
                              device=device)
        else:
            self.mlp_in = nn.Linear(d_model, d_ff, device=device)
            self.mlp_out = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, mask, cache, generator=None, losses=None):
        """generator: a `torch.Generator` on x's device when dropout is
        on for this call (None = deterministic). losses: a list the
        MoE's aux loss is appended to (None: not collected)."""
        cast = self._cast
        drop = self.dropout_rate > 0 and generator is not None
        y = self.attention(_layer_norm(cast, self.ln_attn, x), mask, cache)
        if drop:
            y = _dropout(y, self.dropout_rate, generator)
        x = x + y
        y = _layer_norm(cast, self.ln_mlp, x)
        if hasattr(self, "moe"):
            y, aux_loss = self.moe(y)
            if losses is not None:
                losses.append(aux_loss)
        else:
            y = _linear(cast, self.mlp_in, y)
            y = _linear(cast, self.mlp_out, F.gelu(y, approximate="tanh"))
        if drop:
            y = _dropout(y, self.dropout_rate, generator)
        return x + y


class TransformerLM(nn.Module):
    """GPT-style decoder-only language model.

    Weights are drawn from `seed` (normal, std 0.02; biases 0, norm
    scales 1) on `device` (default: the CUDA card; raises without one);
    load real ones with `load_state_dict` (see `params_from_flax`).
    `dropout_rate` applies after attention and after the MLP when the
    forward is called with `deterministic=False`. `moe_experts > 0`
    makes each MLP a Switch MoE (module doc).
    """

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 d_model=512, d_ff=2048, max_seq_len=2048, dropout_rate=0.0,
                 compute_dtype=torch.bfloat16, moe_experts=0, norm_eps=1e-6,
                 device=None, seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.d_model = d_model
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        self.norm_eps = norm_eps
        self.moe_experts = moe_experts
        #: Each MoE block's aux loss from the last training forward.
        self.aux_losses = []
        self._cast = _ComputeWeights(compute_dtype)
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Embedding(max_seq_len, d_model, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, num_heads, d_ff, norm_eps,
                             self._cast, dropout_rate=dropout_rate,
                             moe_experts=moe_experts, device=device)
            for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(d_model, eps=norm_eps, device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False,
                                 device=device)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def device(self):
        return self.embed.weight.device

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Seeded init, drawn on the CPU so it is the same on any
        device."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                value = torch.zeros(p.shape)
            elif ".ln_" in name or name.startswith("ln_"):
                value = torch.ones(p.shape)
            else:
                value = torch.randn(p.shape, generator=gen) * 0.02
            p.copy_(value)

    def init_cache(self, batch, page_size=0, num_pages=0, page_dtype=""):
        """A zeroed decode cache for `batch` rows: dense per example, or
        (page_size > 0) a page pool of `num_pages` pages (page 0 is the
        scratch page) with `batch` slots, pages in the compute dtype or
        int8 with [num_pages, H] f32 scales."""
        dev = self.device
        heads, head_dim, L = self.num_heads, self.head_dim, self.max_seq_len
        layers = []
        for _ in range(self.num_layers):
            if not page_size:
                layers.append(decoding.dense_cache_layer(self, batch))
                continue
            if L % page_size:
                raise ValueError(
                    "cache_len ({}) must be a positive multiple of "
                    "page_size ({}).".format(L, page_size))
            if num_pages < 2:
                raise ValueError("num_pages must be >= 2 (page 0 is the "
                                 "scratch page).")
            if page_dtype not in ("", "int8"):
                raise ValueError(
                    "page_dtype must be '' or 'int8'; got {!r}.".format(
                        page_dtype))
            store = torch.int8 if page_dtype == "int8" else self.compute_dtype
            shape = (num_pages, page_size, heads, head_dim)
            att = {
                "key_pages": torch.zeros(shape, dtype=store, device=dev),
                "value_pages": torch.zeros(shape, dtype=store, device=dev),
                "page_table": torch.zeros((batch, L // page_size),
                                          dtype=torch.int32, device=dev),
                "slot_steps": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev),
                "slot_valid": torch.zeros((batch, L), dtype=torch.bool,
                                          device=dev),
            }
            if page_dtype == "int8":
                att["key_scales"] = torch.zeros((num_pages, heads),
                                                device=dev)
                att["value_scales"] = torch.zeros((num_pages, heads),
                                                  device=dev)
            layers.append(att)
        return {"pos_count": torch.zeros((batch,), dtype=torch.int32,
                                         device=dev),
                "layers": layers}

    def forward(self, tokens, mask=None, cache=None, deterministic=True,
                generator=None):
        """tokens [B, S] -> f32 logits [B, S, V].

        Without `cache`: the training/scoring forward at positions
        0..S-1; mask (optional [B, S] bool) marks the keys attention may
        see; `deterministic=False` with `generator` (a `torch.Generator`
        on the model's device) applies dropout. In training mode it
        leaves the MoE blocks' aux losses in `aux_losses`.

        With `cache`: decode, appending to the cache, without gradients.
        mask marks REAL incoming tokens: positions count only real
        tokens, so a padded prompt looks up the position rows of its
        unpadded equivalent.
        """
        batch, seq = tokens.shape
        if seq > self.max_seq_len:
            raise ValueError(
                "Sequence length {} exceeds max_seq_len {}.".format(
                    seq, self.max_seq_len))
        self.aux_losses = []
        if cache is not None:
            with torch.no_grad():
                return self._decode(tokens, mask, cache)
        gen = None if deterministic else generator
        losses = [] if self.training and self.moe_experts else None
        x = self.embed.weight[tokens] + self.pos_embed.weight[:seq]
        for block in self.blocks:
            x = block(x, mask, None, generator=gen, losses=losses)
        self.aux_losses = losses or []
        return self._head(x)

    def _decode(self, tokens, mask, cache):
        batch, seq = tokens.shape
        # The residual stream stays in f32 (the JAX model keeps it in the
        # compute dtype): rounding it at each of 2 x layers additions is
        # the largest error a bf16 decode adds to the logits.
        x = self.embed.weight[tokens]
        m = (torch.ones((batch, seq), dtype=torch.int32, device=self.device)
             if mask is None else mask.to(torch.int32))
        positions = cache["pos_count"][:, None] + torch.cumsum(m, 1) - m
        cache["pos_count"] += m.sum(dim=1).to(torch.int32)
        x = x + self.pos_embed.weight[positions]
        for block, layer_cache in zip(self.blocks, cache["layers"]):
            x = block(x, mask, layer_cache)
        return self._head(x)

    def _head(self, x):
        # The final norm and the output head run in f32: the logits
        # feed an argmax or a draw over the whole vocabulary, and bf16
        # logits (steps of 1/128 near |2|) tie often over 50257 tokens.
        x = F.layer_norm(x.float(), self.ln_final.normalized_shape,
                         self.ln_final.weight, self.ln_final.bias,
                         self.ln_final.eps)
        return F.linear(x, self.lm_head.weight)


#: Rows of generate()'s decode batch are padded to a multiple of this
#: count, the serving engine's slot width, so that a row's logits do
#: not depend on how many rows share its batch.
DECODE_ROW_ALIGN = 8


@torch.no_grad()
def generate(model, prompt, max_new_tokens, seed=None, temperature=1.0,
             top_k=None, top_p=None, eos_token=None, prompt_mask=None,
             page_size=16, kv_dtype="", bucket_prompts=True):
    """Autoregressive sampling with a KV cache.

    The port of `cloud_tpu.models.transformer.generate`, by model:

    - A `TransformerLM` decodes the way the serving engine does, so a
      request served by `Scheduler` equals this function's output for
      it: each row prefills alone (`decoding.prefill_request`: its real
      tokens right-padded to a pow2 bucket), is scattered into its own
      pages of a pool (`decoding.scatter_prefill`), and the rows then
      decode together as slots of that pool through
      `ops.paged_attention`, one token per step, the batch padded to
      `DECODE_ROW_ALIGN` rows.
    - A model without a paged cache (`LlamaLM`) follows the JAX route
      over a dense cache (`decoding.acquire_cache`): the prompt
      left-padded to its bucket (`bucket_prompts`), one prefill of the
      whole batch, then single-token steps.

    Args:
        model: A `TransformerLM` or `LlamaLM`.
        prompt: [B, S] int prompt tokens (S >= 1).
        max_new_tokens: tokens to sample beyond the prompt.
        seed: int sampling seed; required unless temperature == 0. Row
            r draws with row r of `decoding.sample_seeds(seed, B, n)`
            (one prefill draw, then one per step).
        temperature: 0 = greedy argmax; else softmax temperature.
        top_k, top_p: optional truncations (`decoding.warp_logits`).
        eos_token: optional stop token: positions after a sampled eos
            are filled with eos_token.
        prompt_mask: optional [B, S] bool marking REAL tokens; prompts
            must be LEFT-padded (last column real).
        page_size, kv_dtype: the page pool's geometry and page dtype
            ("" = compute dtype, "int8" = quantized pages); paged route
            only.
        bucket_prompts: dense route: left-pad the prompt to
            `decoding.bucket_length(S, max_seq_len - max_new_tokens)`
            before the prefill (the mask keeps the pad out of attention
            and positions, so the tokens do not change); False prefills
            at S.

    Returns:
        [B, S + max_new_tokens] int64 CPU tensor: prompt + continuation.
    """
    prompt = np.asarray(torch.as_tensor(prompt).cpu(), np.int64)
    batch, prompt_len = prompt.shape
    if max_new_tokens < 0:
        raise ValueError("max_new_tokens must be >= 0; got {}.".format(
            max_new_tokens))
    if max_new_tokens == 0:
        return torch.from_numpy(prompt)
    if prompt_len + max_new_tokens > model.max_seq_len:
        raise ValueError(
            "prompt ({}) + max_new_tokens ({}) exceeds max_seq_len {}."
            .format(prompt_len, max_new_tokens, model.max_seq_len))
    if temperature and seed is None:
        raise ValueError("Sampling (temperature > 0) needs `seed`.")
    if top_k is not None and not 1 <= top_k <= model.vocab_size:
        raise ValueError(
            "top_k must be in [1, vocab_size={}]; got {}.".format(
                model.vocab_size, top_k))
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(
            "top_p must be in (0, 1]; got {}.".format(top_p))
    real = None
    if prompt_mask is not None:
        decoding.validate_prompt_mask(prompt_mask, batch, prompt_len,
                                      "sampling")
        real = np.asarray(torch.as_tensor(prompt_mask).cpu(), bool)
    seeds = decoding.sample_seeds(0 if seed is None else seed, batch,
                                  max_new_tokens)
    sampling = {"temperature": float(temperature), "top_k": top_k,
                "top_p": top_p}
    if isinstance(model, TransformerLM) and model.moe_experts:
        raise NotImplementedError(MOE_DECODE_NOT_PORTED)
    if not isinstance(model, TransformerLM):
        tokens = _generate_dense(model, prompt, real, max_new_tokens, seeds,
                                 sampling, eos_token, bucket_prompts)
    else:
        if real is None:
            real = np.ones((batch, prompt_len), bool)
        tokens = _generate_paged(model, prompt, real, max_new_tokens, seeds,
                                 sampling, eos_token, page_size, kv_dtype)
    return torch.from_numpy(np.concatenate([prompt, tokens], axis=1))


def _sample_rows(logits, seeds, sampling):
    """One draw for each row of [R, V] logits (`decoding.sample_slots`)."""
    rows = logits.shape[0]
    return decoding.sample_slots(
        logits, seeds, [sampling["temperature"]] * rows,
        [sampling["top_k"]] * rows, [sampling["top_p"]] * rows)


def _stop_at_eos(nxt, done, eos_token):
    """Rows already done emit eos_token; returns (tokens, done)."""
    if eos_token is None:
        return nxt, done
    nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
    return nxt, done | (nxt == eos_token)


def _generate_dense(model, prompt, real, max_new_tokens, seeds, sampling,
                    eos_token, bucket_prompts):
    """generate()'s route over a dense cache (the JAX one): the whole
    batch prefills once, left-padded to its bucket, then decodes one
    token a step. Returns the [B, max_new_tokens] tokens (numpy)."""
    batch, prompt_len = prompt.shape
    tokens, mask = prompt, real
    if bucket_prompts:
        bucket = decoding.bucket_length(prompt_len,
                                        model.max_seq_len - max_new_tokens)
        if bucket > prompt_len:
            pad = ((0, 0), (bucket - prompt_len, 0))
            tokens = np.pad(prompt, pad)
            mask = np.pad(np.ones((batch, prompt_len), bool)
                          if real is None else real, pad)
    dev = model.device
    cache = decoding.acquire_cache(model, batch)
    latency = decoding.decode_latency_start()
    logits = model(torch.from_numpy(tokens).to(dev),
                   None if mask is None else torch.from_numpy(mask).to(dev),
                   cache)
    cur = _sample_rows(logits[:, -1], seeds[:, 0], sampling)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    if eos_token is not None:
        done = cur == eos_token
    out = [cur]
    for step in range(1, max_new_tokens):
        logits = model(cur[:, None], None, cache)[:, 0]
        cur, done = _stop_at_eos(_sample_rows(logits, seeds[:, step],
                                              sampling), done, eos_token)
        out.append(cur)
    result = runtime.device_fetch(torch.stack(out, dim=1))
    decoding.release_cache(model, batch, cache)
    decoding.decode_latency_finish(latency, max_new_tokens)
    return result


def _generate_paged(model, prompt, real, max_new_tokens, seeds, sampling,
                    eos_token, page_size, kv_dtype):
    """generate()'s route over a page pool (the serving engine's), for a
    `TransformerLM`. Returns the [B, max_new_tokens] tokens (numpy)."""
    batch = prompt.shape[0]
    temperature = sampling["temperature"]
    slots = -(-batch // DECODE_ROW_ALIGN) * DECODE_ROW_ALIGN
    pages_per_slot = model.max_seq_len // page_size
    cache = model.init_cache(slots, page_size=page_size,
                             num_pages=batch * pages_per_slot + 1,
                             page_dtype=kv_dtype)
    dev = model.device
    cur = torch.zeros((slots,), dtype=torch.int64, device=dev)
    for row in range(batch):
        first, dense, _ = decoding.prefill_request(
            model, prompt[row][real[row]], seeds[row, 0], sampling)
        vec = 1 + row * pages_per_slot + np.arange(pages_per_slot)
        decoding.scatter_prefill(cache, dense, row, vec, vec)
        cur[row] = first
    active = torch.zeros((slots, 1), dtype=torch.bool, device=dev)
    active[:batch] = True
    done = torch.zeros((slots,), dtype=torch.bool, device=dev)
    if eos_token is not None:
        done = cur == eos_token
    temps = np.zeros(slots)
    temps[:batch] = float(temperature)
    step_seeds = np.zeros((slots,), np.int64)
    out = [cur]
    for step in range(1, max_new_tokens):
        logits = model(cur[:, None], active, cache)[:, 0]
        step_seeds[:batch] = seeds[:, step]
        nxt = decoding.sample_slots(logits, step_seeds, temps,
                                    [sampling["top_k"]] * slots,
                                    [sampling["top_p"]] * slots)
        cur, done = _stop_at_eos(nxt, done, eos_token)
        out.append(cur)
    return runtime.device_fetch(torch.stack(out, dim=1)[:batch])


__all__ = ["CausalSelfAttention", "DECODE_ROW_ALIGN",
           "MOE_DECODE_NOT_PORTED", "TransformerBlock", "TransformerLM",
           "generate"]
