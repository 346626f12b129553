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
from cloud_tpu_torch.ops import decode_block
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

    def fused(self, layers):
        """The weights and biases of `layers` (Linears of one input
        width) concatenated along the output, in the compute dtype: one
        product in place of several (decode, without grad). Made once
        and reused until a parameter changes."""
        params = [t for layer in layers for t in (layer.weight, layer.bias)]
        key = tuple(id(t) for t in params)
        stamp = tuple((t._version, t.data_ptr()) for t in params)
        hit = self._memo.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        fused = (torch.cat([l.weight.detach() for l in layers]).to(self.dtype),
                 torch.cat([l.bias.detach() for l in layers]).to(self.dtype))
        self._memo[key] = (stamp, fused)
        return fused


#: Widest window of one example that decode attention sends to the
#: window kernel (`CausalSelfAttention._decode_attention`).
WINDOW_KERNEL_ROWS = 16


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

    def forward(self, x, mask, cache, ctx=None):
        """ctx: with a cache, the call's slot bookkeeping, computed once
        for all layers by `TransformerLM.decode_hidden`."""
        batch, seq, _ = x.shape
        if cache is None:
            # Training / scoring: causal attention over the sequence, the
            # key mask (optional [B, S]) excluding padded keys.
            shape = (batch, seq, self.num_heads, self.head_dim)
            q = _linear(self._cast, self.query, x).view(shape)
            k = _linear(self._cast, self.key, x).view(shape)
            v = _linear(self._cast, self.value, x).view(shape)
            out = attention_ops.attention(q, k, v, causal=True, mask=mask)
        else:
            # Decode: q, k and v from one product; k and v as one [2, B,
            # S, H, D] view, written to the cache in one index write.
            w, b = self._cast.fused((self.query, self.key, self.value))
            qkv = F.linear(x.to(self._cast.dtype), w, b).view(
                batch, seq, 3, self.num_heads, self.head_dim)
            q, kv = qkv[:, :, 0], qkv[:, :, 1:].permute(2, 0, 1, 3, 4)
            if "key_pages" in cache:
                out = self._paged_decode_attention(q, kv, mask, cache, ctx)
            else:
                out = self._decode_attention(q, kv, cache, ctx)
        out = out.to(self._cast.dtype).reshape(batch, seq, -1)
        return _linear(self._cast, self.out, out)

    def _decode_attention(self, q, kv, cache, ctx):
        """Dense KV-cache attention: write this call's K/V at its slots,
        then attend q against everything cached so far, as JAX's
        `_decode_attention` (`ops.decode_block.dense_decode_attention`;
        `ctx`: the slots of `decoding.dense_slot_update` and its mask as
        an additive bias, 0 or -1e30, which gives the same logits). A
        window of one example of at most `WINDOW_KERNEL_ROWS` queries (a
        prefix hit's suffix, a chunk, a short prompt) at a head dim the
        kernel is built for takes `decode_block.window_attention`, the
        CUDA kernel on the card; wider windows are products that cuBLAS
        runs on tensor cores."""
        slots, bias = ctx
        batch, seq = q.shape[:2]
        cached = cache["kv"]                      # [2, B, L, H, D]
        cached.index_copy_(2, slots, kv.to(cached.dtype))
        scale = 1.0 / math.sqrt(self.head_dim)
        if (batch == 1 and seq <= WINDOW_KERNEL_ROWS
                and self.head_dim in decode_block.WINDOW_HEAD_DIMS):
            return decode_block.window_attention(
                q[0], cached[0, 0], cached[1, 0], bias[0, 0], scale)[None]
        return decode_block.dense_decode_attention(q, cached[0], cached[1],
                                                   bias, scale)

    def _paged_decode_attention(self, q, kv, mask, cache, ctx):
        """Decode over the paged pool: the batch dimension is SLOTS, each
        at its own depth (`ctx`: the mask of `decoding.paged_slot_update`
        and each token's physical page and offset). Token j of slot s is
        written at physical page page_table[s, pos // P], offset pos % P
        (inactive slots resolve to scratch page 0 through their zeroed
        table row), then `ops.paged_attention` attends each slot's
        logical view."""
        from cloud_tpu_torch.ops.paged_attention import paged_attention

        slots, seq = q.shape[:2]
        pages = cache["pages"]                    # [2, N, P, H, D]
        allowed, phys, off = ctx
        scales = {}
        if "scales" in cache:
            # Dead tokens are zeroed before quantizing so they never
            # inflate a real page's scale.
            decode_block.int8_page_write(
                pages, cache["scales"], kv, phys, off,
                None if mask is None else mask.reshape(slots, seq).bool())
            scales = dict(key_scales=cache["key_scales"],
                          value_scales=cache["value_scales"])
        else:
            pages[:, phys, off] = kv.to(pages.dtype)
        return paged_attention(q.contiguous(), cache["key_pages"],
                               cache["value_pages"], cache["page_table"],
                               allowed,
                               sm_scale=1.0 / math.sqrt(self.head_dim),
                               **scales)


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

    def forward(self, x, mask, cache, generator=None, losses=None,
                ctx=None):
        """generator: a `torch.Generator` on x's device when dropout is
        on for this call (None = deterministic). losses: a list the
        MoE's aux loss is appended to (None: not collected). ctx: the
        decode call's slot bookkeeping (`CausalSelfAttention.forward`)."""
        cast = self._cast
        drop = self.dropout_rate > 0 and generator is not None
        y = self.attention(_layer_norm(cast, self.ln_attn, x), mask, cache,
                           ctx)
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

    def decode(self, x, pending, mask, cache, ctx):
        """The block in decode: returns (h, y) where h + y is the block's
        output. `pending` (the previous block's y, or None) is added to
        the f32 residual stream x by the same call that takes the first
        LayerNorm, and this block's own attention output likewise by the
        second (`decode_block.add_layer_norm`, a kernel on the card), so
        each residual add costs no launch of its own."""
        cast = self._cast
        ln = self.ln_attn
        normed, x = decode_block.add_layer_norm(x, pending, ln.weight,
                                                ln.bias, ln.eps, cast.dtype)
        y = self.attention(normed, mask, cache, ctx)
        ln = self.ln_mlp
        normed, x = decode_block.add_layer_norm(x, y, ln.weight, ln.bias,
                                                ln.eps, cast.dtype)
        if hasattr(self, "moe"):
            return x, self.moe(normed)[0]
        y = _linear(cast, self.mlp_in, normed)
        return x, _linear(cast, self.mlp_out, F.gelu(y, approximate="tanh"))


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
        """A zeroed decode cache for `batch` rows: dense per example
        (`decoding.transformer_dense_cache`), or (page_size > 0) a page
        pool of `num_pages` pages (page 0 is the scratch page) with
        `batch` slots, pages in the compute dtype or int8 with
        [num_pages, H] f32 scales. Every layer has its own pages; the
        page table, the slots' pointers and validity are one set of
        tensors that every layer's dict shares (each decode call moves
        them once)."""
        if not page_size:
            return decoding.transformer_dense_cache(self, batch)
        dev = self.device
        heads, head_dim, L = self.num_heads, self.head_dim, self.max_seq_len
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
        shared = {
            "page_table": torch.zeros((batch, L // page_size),
                                      dtype=torch.int32, device=dev),
            "slot_steps": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev),
            "slot_valid": torch.zeros((batch, L), dtype=torch.bool,
                                      device=dev),
        }
        # Every layer's K and V pages in one tensor (and the int8
        # scales in another), so that a prefix gather or a request's
        # scatter moves all of them in one indexing operation.
        cache = {"pos_count": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev),
                 "pages": torch.zeros((self.num_layers, 2) + shape,
                                      dtype=store, device=dev)}
        if page_dtype == "int8":
            cache["scales"] = torch.zeros(
                (self.num_layers, 2, num_pages, heads), device=dev)
        layers = []
        for i in range(self.num_layers):
            att = dict(shared, pages=cache["pages"][i],
                       key_pages=cache["pages"][i, 0],
                       value_pages=cache["pages"][i, 1])
            if page_dtype == "int8":
                att.update(scales=cache["scales"][i],
                           key_scales=cache["scales"][i, 0],
                           value_scales=cache["scales"][i, 1])
            layers.append(att)
        cache["layers"] = layers
        return cache

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
        return self.head(x)

    def _decode(self, tokens, mask, cache):
        return self.head(self.decode_hidden(tokens, mask, cache))

    def decode_hidden(self, tokens, mask, cache):
        """The decode forward up to the final norm: appends to `cache`
        (from `init_cache`) in place and returns the f32 residual stream
        [B, S, d_model] (`head` turns it into logits). The slot
        bookkeeping, which every layer's dict shares, moves once for the
        call."""
        batch, seq = tokens.shape
        layers = cache["layers"]
        first = layers[0]
        for layer in layers[1:]:
            if layer["slot_valid"] is not first["slot_valid"]:
                raise ValueError(
                    "the decode cache's layers must share one set of "
                    "bookkeeping tensors (make it with init_cache).")
        if "key_pages" in first:
            pos, allowed = decoding.paged_slot_update(
                first, mask, batch, seq, first["slot_valid"].shape[1])
            # Where each token's K/V go: physical page and offset, the
            # same for every layer.
            page_size = first["key_pages"].shape[1]
            table = first["page_table"]
            page_idx = (pos // page_size).clamp(max=table.shape[1] - 1)
            ctx = (allowed, table.gather(1, page_idx).long(),
                   pos % page_size)
        else:
            slots, allowed = decoding.dense_slot_update(first, mask, batch,
                                                        seq)
            # The mask as an additive bias of the logits, for all layers.
            ctx = (slots, torch.where(allowed, 0.0, -1e30)[:, None])
        # The residual stream stays in f32 (the JAX model keeps it in the
        # compute dtype): rounding it at each of 2 x layers additions is
        # the largest error a bf16 decode adds to the logits.
        x = self.embed.weight[tokens]
        m = (torch.ones((batch, seq), dtype=torch.int32, device=self.device)
             if mask is None else mask.to(torch.int32))
        positions = cache["pos_count"][:, None] + torch.cumsum(m, 1) - m
        cache["pos_count"] += m.sum(dim=1).to(torch.int32)
        x = x + self.pos_embed.weight[positions]
        y = None
        for block, layer_cache in zip(self.blocks, layers):
            x, y = block.decode(x, y, mask, layer_cache, ctx)
        return x + y

    def head(self, x):
        """f32 logits [..., V] of the residual stream: the final norm
        and the output head, in f32."""
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
        decoding.release_cache(model, 1, dense)
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
