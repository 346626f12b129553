"""Import HuggingFace Llama-family and GPT-2 checkpoints into the port's
`LlamaLM` and `TransformerLM`; the port of `cloud_tpu/models/hf_import.py`.

The input is a `transformers` model (anything with `.config` and
`.state_dict()`) or a state dict with its config (an object or a dict);
`transformers` itself is never imported. The result is the port's model
with the weights loaded, on `device` (default: the CUDA card). Every
family switch of the JAX importer is carried (GQA, rms_norm_eps,
rope_theta, `rope_scaling` llama3 / linear / yarn, the Mistral window
and its Qwen gating, decoupled `head_dim`, Qwen2 q/k/v biases, Qwen3 and
Gemma3 q/k norms, Gemma 1/2/3 and Phi-3), and so is every rejection:
LongRoPE and other rope schemes, `partial_rotary_factor`, the multimodal
`gemma3` wrapper, bidirectional attention, unknown activations, the
GPT-2 attention variants, and any tensor the mapping does not consume.
The mixture-of-experts families (Mixtral, Qwen3-MoE) import drop-free
(`moe_capacity_factor=None`, HF's inference semantics); Qwen3-MoE with
dense layers interleaved (`mlp_only_layers`, `decoder_sparse_step` != 1)
is rejected, as in JAX.

HF stores `nn.Linear` weights [out, in], as the port does, so the Llama
mapping is renames (Phi-3's fused `qkv_proj` and `gate_up_proj` split by
rows; Gemma's (1 + w) RMSNorm convention folded into the scale):

    model.embed_tokens.weight               -> embed.weight
    model.layers.i.input_layernorm          -> blocks.i.norm_attn
    model.layers.i.self_attn.{q,k,v}_proj   -> blocks.i.attention.
                                               {query,key,value}
    model.layers.i.self_attn.o_proj         -> blocks.i.attention.out
    model.layers.i.self_attn.{q,k}_norm     -> blocks.i.attention.{q,k}_norm
    model.layers.i.post_attention_layernorm -> blocks.i.norm_mlp
        (Gemma 2/3: blocks.i.norm_attn_post; pre/post_feedforward_layernorm
        -> blocks.i.norm_mlp / norm_mlp_post)
    model.layers.i.mlp.{gate,up,down}_proj  -> blocks.i.mlp.{gate,up,down}
    Mixtral block_sparse_moe.gate / Qwen3-MoE mlp.gate [E, d]
                                            -> blocks.i.moe.router [d, E]
    ....experts.e.{w1,w3,w2} / {gate,up,down}_proj [out, in]
                                            -> blocks.i.moe.expert_{gate,
                                               up,down}[e] [in, out]
    model.norm.weight                       -> norm_final.weight
    lm_head.weight                          -> lm_head.weight (else the
                                               embedding, tied)

GPT-2's Conv1D weights are [in, out] and are transposed; its fused
c_attn splits into q/k/v by columns.
"""

import re

import torch

from cloud_tpu_torch.models.llama import LlamaLM, RopeScaling
from cloud_tpu_torch.models.transformer import TransformerLM


def _translate_rope_scaling(hf_scaling, default_original_max=None):
    """HF `rope_scaling` dict -> RopeScaling (or None): "llama3",
    "yarn" (with DeepSeek's mscale pair) and "linear"; "default" is no
    transform. Any other scheme (dynamic, longrope) rotates in a way
    `apply_rope` does not, and is rejected."""
    if not hf_scaling:
        return None
    if not isinstance(hf_scaling, dict):
        hf_scaling = dict(hf_scaling)
    kind = hf_scaling.get("rope_type", hf_scaling.get("type", ""))
    if kind == "default":
        return None
    if kind == "linear":
        return RopeScaling(kind="linear",
                           factor=float(hf_scaling["factor"]))
    if kind == "llama3":
        return RopeScaling(
            kind="llama3",
            factor=float(hf_scaling["factor"]),
            low_freq_factor=float(hf_scaling["low_freq_factor"]),
            high_freq_factor=float(hf_scaling["high_freq_factor"]),
            original_max_len=int(
                hf_scaling["original_max_position_embeddings"]))
    if kind == "yarn":
        original = (hf_scaling.get("original_max_position_embeddings")
                    or default_original_max)
        if not original:
            raise ValueError(
                "yarn rope_scaling needs original_max_position_"
                "embeddings (or the config's max_position_embeddings).")
        af = hf_scaling.get("attention_factor")
        mscale = hf_scaling.get("mscale")
        mscale_all = hf_scaling.get("mscale_all_dim")
        return RopeScaling(
            kind="yarn",
            factor=float(hf_scaling["factor"]),
            original_max_len=int(original),
            beta_fast=float(hf_scaling.get("beta_fast") or 32.0),
            beta_slow=float(hf_scaling.get("beta_slow") or 1.0),
            attention_factor=(None if af is None else float(af)),
            mscale=(None if mscale is None else float(mscale)),
            mscale_all_dim=(None if mscale_all is None
                            else float(mscale_all)),
            truncate=bool(hf_scaling.get("truncate", True)))
    raise NotImplementedError(
        "This checkpoint uses rope_scaling={!r}; only 'llama3', "
        "'yarn', 'linear', and 'default' import.".format(hf_scaling))


def _to_tensor(value):
    """A tensor (any dtype, on its own device) or array -> float32."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32)
    return torch.as_tensor(value).to(torch.float32)


def _unpack(model, state_dict, config):
    """(model | state_dict + config) -> (state_dict, config)."""
    if model is not None:
        return dict(model.state_dict()), model.config
    if state_dict is None or config is None:
        raise ValueError("Pass either `model` or both `state_dict` "
                         "and `config`.")
    return state_dict, config


def _cfg_reader(config):
    """One reader over HF config objects and plain dicts."""
    def cfg(name, default=None):
        if isinstance(config, dict):
            value = config.get(name, default)
        else:
            value = getattr(config, name, default)
        if value is None and default is None:
            raise ValueError("HF config is missing {!r}.".format(name))
        return value
    return cfg


def _taker(state_dict, prefix=""):
    """(take, consumed): take() fetches a tensor or raises, and records
    it for `_check_all_consumed`."""
    consumed = set()

    def take(name):
        name = prefix + name
        if name not in state_dict:
            raise KeyError(
                "HF state_dict is missing {!r} (have e.g. {}).".format(
                    name, sorted(state_dict)[:5]))
        consumed.add(name)
        return _to_tensor(state_dict[name])

    return take, consumed


def _check_all_consumed(state_dict, consumed, skip_pattern):
    """Every tensor of the checkpoint must have landed somewhere: an
    unmapped one (an o_proj or MLP bias, an adapter) would give a model
    whose logits are silently wrong. skip_pattern: a regex of derivable
    buffers (rotary tables, causal-mask buffers)."""
    leftover = sorted(
        name for name in state_dict
        if name not in consumed and not re.search(skip_pattern, name))
    if leftover:
        raise ValueError(
            "HF state_dict has parameters this importer does not map "
            "(the imported model would silently diverge): {}".format(
                leftover[:8]))


def _mlp_activation(act):
    """HF hidden_act name -> the port's SwiGLU activation name."""
    try:
        return {"silu": "silu",
                "gelu_pytorch_tanh": "gelu_tanh",
                "gelu": "gelu"}[act]
    except KeyError:
        raise NotImplementedError(
            "hidden activation {!r} is not supported (silu / "
            "gelu_pytorch_tanh / gelu import).".format(act))


def import_hf_llama(model=None, state_dict=None, config=None,
                    compute_dtype=torch.bfloat16, attention_impl="auto",
                    max_seq_len=None, device=None):
    """Converts an HF Llama-family model to the port's `LlamaLM`.

    Args:
        model: a `transformers` causal LM (anything with `.config` and
            `.state_dict()`); OR pass `state_dict` + `config`.
        state_dict: mapping of HF parameter names to tensors or arrays.
        config: HF config object or dict (hidden_size,
            num_attention_heads, num_key_value_heads, intermediate_size,
            num_hidden_layers, vocab_size, rope_theta, rms_norm_eps,
            max_position_embeddings, and the family's switches).
        compute_dtype: the model's compute dtype (parameters stay f32).
        attention_impl: forwarded to `LlamaLM`.
        max_seq_len: overrides max_position_embeddings (it sizes the
            decode cache).
        device: where the model lives (default: the CUDA card).

    Returns:
        a `LlamaLM` configured as the checkpoint (rotate-half RoPE, its
        theta) with its weights loaded; Mixtral and Qwen3-MoE with their
        routed experts, drop-free.
    """
    state_dict, config = _unpack(model, state_dict, config)
    cfg = _cfg_reader(config)

    d_model = cfg("hidden_size")
    heads = cfg("num_attention_heads")
    kv_heads = cfg("num_key_value_heads", heads)
    layers = cfg("num_hidden_layers")
    head_dim = d_model // heads
    explicit_head_dim = cfg("head_dim", False)
    if explicit_head_dim:
        # Mistral-Nemo-style decoupled head_dim.
        head_dim = int(explicit_head_dim)

    # Mistral-style sliding window. Qwen2/Qwen3 apply it only when
    # use_sliding_window is true (default False; HF config objects null
    # the window themselves, so this acts on dict configs).
    window = cfg("sliding_window", False)
    if window:
        gated_family = str(cfg("model_type", "llama")).startswith("qwen")
        if not cfg("use_sliding_window", not gated_family):
            window = False
    horizon = max_seq_len or cfg("max_position_embeddings", 2048)

    rope_scaling = _translate_rope_scaling(
        cfg("rope_scaling", False),
        default_original_max=cfg("max_position_embeddings", 2048))

    # Qwen2-style q/k/v biases and Phi-3's fused projections, detected
    # from the weights (config names differ across families).
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state_dict
    fused_qkv = "model.layers.0.self_attn.qkv_proj.weight" in state_dict
    fused_gate_up = ("model.layers.0.mlp.gate_up_proj.weight"
                     in state_dict)
    partial_rotary = cfg("partial_rotary_factor", 1.0) or 1.0
    if float(partial_rotary) != 1.0:
        raise NotImplementedError(
            "partial_rotary_factor={} is not supported; apply_rope "
            "rotates the full head_dim.".format(partial_rotary))

    # Gemma: GeGLU, sqrt(d_model)-scaled embeddings and the (1 + w)
    # RMSNorm, folded into the scales; Gemma2 adds sandwich norms,
    # softcaps, query_pre_attn_scalar and local/global layers; Gemma3
    # q/k norms, 5:1 local:global layers and an unscaled local rotary.
    model_type = cfg("model_type", "llama")
    if model_type == "gemma3":
        raise NotImplementedError(
            "model_type='gemma3' is the multimodal wrapper; import the "
            "text tower (model_type='gemma3_text', e.g. "
            "model.language_model with config.text_config).")
    is_gemma2 = model_type == "gemma2"
    is_gemma3 = model_type == "gemma3_text"
    if is_gemma3 and cfg("use_bidirectional_attention", False):
        raise NotImplementedError(
            "use_bidirectional_attention=True (embedding-Gemma) is not "
            "supported; causal gemma3_text imports.")
    gemma_family = model_type == "gemma" or is_gemma2 or is_gemma3
    mlp_activation = _mlp_activation(
        cfg("hidden_activation", False) or cfg("hidden_act", False)
        or ("gelu_pytorch_tanh" if gemma_family else "silu"))

    def norm_scale(w):
        # HF Gemma's RMSNorm computes x * (1 + w).
        return w + 1.0 if gemma_family else w

    # Per-layer attention kinds: HF layer_types when given, else each
    # family's documented default (gemma2 alternating from local, gemma3
    # 5 local then 1 global; Qwen2 bands layers >= max_window_layers,
    # HF's default 28).
    attn_kinds = None
    layer_types = cfg("layer_types", False)
    if layer_types:
        kinds = {"sliding_attention": "local", "full_attention": "global"}
        try:
            attn_kinds = tuple(kinds[t] for t in layer_types)
        except KeyError:
            raise NotImplementedError(
                "Unknown layer_types entries {!r}.".format(
                    sorted(set(layer_types) - set(kinds))))
    elif is_gemma2:
        attn_kinds = tuple(
            "local" if (i + 1) % 2 else "global" for i in range(layers))
    elif is_gemma3:
        pattern = int(cfg("sliding_window_pattern", 6))
        attn_kinds = tuple(
            "local" if (i + 1) % pattern else "global"
            for i in range(layers))
    elif window and str(model_type).startswith("qwen"):
        mwl = int(cfg("max_window_layers", 28))
        if mwl > 0:
            attn_kinds = tuple("global" if i < mwl else "local"
                               for i in range(layers))

    attn_scale = None
    if is_gemma2 or is_gemma3:
        attn_scale = float(cfg("query_pre_attn_scalar")) ** -0.5
    has_qk_norm = ("model.layers.0.self_attn.q_norm.weight"
                   in state_dict)

    # Mixtral / Qwen3-MoE: the routed MoE in every block, imported
    # drop-free. Each family's HF config defaults stand in for a missing
    # key (top-k 2 and 8; Qwen3MoeConfig's norm_topk_prob is False).
    is_mixtral = model_type == "mixtral"
    is_qwen3_moe = model_type == "qwen3_moe"
    if is_qwen3_moe:
        if cfg("mlp_only_layers", False) or \
                int(cfg("decoder_sparse_step", 1) or 1) != 1:
            raise NotImplementedError(
                "qwen3_moe with dense layers interleaved "
                "(mlp_only_layers / decoder_sparse_step != 1) is not "
                "supported; LlamaLM's MoE applies to every block.")
        moe_experts = int(cfg("num_experts"))
        d_ff = int(cfg("moe_intermediate_size"))
    else:
        moe_experts = int(cfg("num_local_experts", 8)) if is_mixtral else 0
        d_ff = cfg("intermediate_size")
    moe_top_k = (int(cfg("num_experts_per_tok", 8 if is_qwen3_moe else 2))
                 if moe_experts else 2)
    moe_norm_topk = (bool(cfg("norm_topk_prob", False)) if is_qwen3_moe
                     else True)

    take, consumed = _taker(state_dict)
    embed = take("model.embed_tokens.weight")
    state = {"embed.weight": embed,
             "norm_final.weight": norm_scale(take("model.norm.weight"))}
    state["lm_head.weight"] = (take("lm_head.weight")
                               if "lm_head.weight" in state_dict
                               else embed.clone())
    for i in range(layers):
        hf = "model.layers.{}.".format(i)
        port = "blocks.{}.".format(i)
        if fused_qkv:
            # Phi-3: rows cat(q [H*hd], k [H_kv*hd], v [H_kv*hd]).
            w = take(hf + "self_attn.qkv_proj.weight")
            q_rows, kv_rows = heads * head_dim, kv_heads * head_dim
            state[port + "attention.query.weight"] = w[:q_rows]
            state[port + "attention.key.weight"] = \
                w[q_rows:q_rows + kv_rows]
            state[port + "attention.value.weight"] = w[q_rows + kv_rows:]
        else:
            for src, dst in (("q", "query"), ("k", "key"), ("v", "value")):
                name = hf + "self_attn.{}_proj.".format(src)
                state[port + "attention." + dst + ".weight"] = \
                    take(name + "weight")
                if qkv_bias:
                    state[port + "attention." + dst + ".bias"] = \
                        take(name + "bias")
        state[port + "attention.out.weight"] = \
            take(hf + "self_attn.o_proj.weight")
        if has_qk_norm:
            for name in ("q_norm", "k_norm"):
                state[port + "attention." + name + ".weight"] = norm_scale(
                    take(hf + "self_attn." + name + ".weight"))
        if moe_experts:
            moe = hf + ("block_sparse_moe." if is_mixtral else "mlp.")
            names = (("w1", "w3", "w2") if is_mixtral
                     else ("gate_proj", "up_proj", "down_proj"))
            state[port + "moe.router"] = take(moe + "gate.weight").T
            for dst, src in zip(("gate", "up", "down"), names):
                state[port + "moe.expert_" + dst] = torch.stack([
                    take(moe + "experts.{}.{}.weight".format(e, src)).T
                    for e in range(moe_experts)])
        elif fused_gate_up:
            # Phi-3: rows cat(gate [f], up [f]).
            gu = take(hf + "mlp.gate_up_proj.weight")
            d_ff = gu.shape[0] // 2
            state[port + "mlp.gate.weight"] = gu[:d_ff]
            state[port + "mlp.up.weight"] = gu[d_ff:]
        else:
            for name in ("gate", "up"):
                state[port + "mlp." + name + ".weight"] = \
                    take(hf + "mlp.{}_proj.weight".format(name))
        if not moe_experts:
            state[port + "mlp.down.weight"] = take(
                hf + "mlp.down_proj.weight")
        norms = {"norm_attn": "input_layernorm"}
        if is_gemma2 or is_gemma3:
            # Sandwich norms: here post_attention_layernorm normalizes the
            # attention output, and the pre/post_feedforward pair
            # brackets the MLP.
            norms.update(norm_attn_post="post_attention_layernorm",
                         norm_mlp="pre_feedforward_layernorm",
                         norm_mlp_post="post_feedforward_layernorm")
        else:
            norms["norm_mlp"] = "post_attention_layernorm"
        for dst, src in norms.items():
            state[port + dst + ".weight"] = norm_scale(
                take(hf + src + ".weight"))

    # Rotary inv_freq tables are derivable buffers.
    _check_all_consumed(state_dict, consumed, r"rotary_emb")

    lm = LlamaLM(
        vocab_size=cfg("vocab_size"),
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv_heads,
        d_model=d_model,
        d_ff=d_ff,
        max_seq_len=horizon,
        rope_theta=float(cfg("rope_theta", 10000.0)),
        rope_style="rotate_half",
        norm_eps=float(cfg("rms_norm_eps", 1e-6)),
        compute_dtype=compute_dtype,
        attention_impl=attention_impl,
        head_dim=(head_dim if head_dim != d_model // heads else None),
        rope_scaling=rope_scaling,
        sliding_window=(int(window) if window else None),
        qkv_bias=qkv_bias,
        mlp_activation=mlp_activation,
        scale_embed=gemma_family,
        post_block_norms=is_gemma2 or is_gemma3,
        attn_scale=attn_scale,
        attn_logit_softcap=(
            float(cfg("attn_logit_softcapping", 0) or 0) or None
            if is_gemma2 else None),
        final_logit_softcap=(
            float(cfg("final_logit_softcapping", 0) or 0) or None
            if is_gemma2 else None),
        qk_norm=has_qk_norm,
        attn_kinds=attn_kinds,
        rope_theta_local=(float(cfg("rope_local_base_freq", 10000.0))
                          if is_gemma3 else None),
        # Gemma3 alone runs its local layers on an unscaled rotary.
        rope_scaling_local=(None if is_gemma3 else rope_scaling),
        moe_experts=moe_experts, moe_top_k=moe_top_k,
        moe_capacity_factor=None, moe_norm_topk=moe_norm_topk,
        device=device, seed=None)
    lm.load_state_dict(state)
    return lm


def import_hf_gpt2(model=None, state_dict=None, config=None,
                   compute_dtype=torch.bfloat16, max_seq_len=None,
                   device=None):
    """Converts an HF GPT-2 model to the port's `TransformerLM`.

    `TransformerLM` is GPT-2 shaped (pre-LN blocks, learned positions,
    tanh-approximate GELU), so the conversion is layout: Conv1D weights
    [in, out] are transposed to [out, in], the fused c_attn [d, 3d]
    splits into q/k/v, and the head is the checkpoint's `lm_head.weight`
    where it has one, else tied to wte. layer_norm_epsilon becomes
    norm_eps. Non-parameter attention buffers (h.i.attn.bias /
    masked_bias) are skipped; any other unmapped tensor raises. Args as
    `import_hf_llama` (the port's `TransformerLM` has no
    attention_impl). Returns the `TransformerLM` with its weights.
    """
    state_dict, config = _unpack(model, state_dict, config)
    cfg = _cfg_reader(config)

    act = cfg("activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(
            "GPT-2 activation_function={!r} is not supported; "
            "TransformerLM uses tanh-approximate GELU "
            "(gelu_new).".format(act))
    # Attention variants with no parameters of their own would pass the
    # leftover check and import with wrong logits.
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if cfg(flag, False):
            raise NotImplementedError(
                "GPT-2 {}=True is not supported; TransformerLM always "
                "scales attention by 1/sqrt(head_dim).".format(flag))
    if not cfg("scale_attn_weights", True):
        raise NotImplementedError(
            "GPT-2 scale_attn_weights=False is not supported; "
            "TransformerLM always scales attention by "
            "1/sqrt(head_dim).")

    d_model = cfg("n_embd")
    heads = cfg("n_head")
    layers = cfg("n_layer")
    d_ff = cfg("n_inner", False) or 4 * d_model
    n_positions = cfg("n_positions", 1024)
    horizon = max_seq_len or n_positions
    if horizon > n_positions:
        raise ValueError(
            "max_seq_len={} exceeds the checkpoint's n_positions={}; "
            "GPT-2's learned position table cannot be extended.".format(
                horizon, n_positions))

    prefix = ("transformer."
              if any(k.startswith("transformer.") for k in state_dict)
              else "")
    take, consumed = _taker(state_dict, prefix=prefix)
    wte = take("wte.weight")
    if "lm_head.weight" in state_dict:
        consumed.add("lm_head.weight")
        head_w = _to_tensor(state_dict["lm_head.weight"])
    else:
        head_w = wte.clone()
    state = {"embed.weight": wte,
             "pos_embed.weight": take("wpe.weight")[:horizon].clone(),
             "ln_final.weight": take("ln_f.weight"),
             "ln_final.bias": take("ln_f.bias"),
             "lm_head.weight": head_w}
    for i in range(layers):
        hf = "h.{}.".format(i)
        port = "blocks.{}.".format(i)
        for src, dst in (("ln_1", "ln_attn"), ("ln_2", "ln_mlp")):
            state[port + dst + ".weight"] = take(hf + src + ".weight")
            state[port + dst + ".bias"] = take(hf + src + ".bias")
        ca = take(hf + "attn.c_attn.weight")      # [d, 3d], Conv1D [in, out]
        cb = take(hf + "attn.c_attn.bias")
        for j, name in enumerate(("query", "key", "value")):
            cols = slice(j * d_model, (j + 1) * d_model)
            state[port + "attention." + name + ".weight"] = \
                ca[:, cols].T.contiguous()
            state[port + "attention." + name + ".bias"] = cb[cols].clone()
        state[port + "attention.out.weight"] = \
            take(hf + "attn.c_proj.weight").T.contiguous()
        state[port + "attention.out.bias"] = take(hf + "attn.c_proj.bias")
        for src, dst in (("c_fc", "mlp_in"), ("c_proj", "mlp_out")):
            state[port + dst + ".weight"] = \
                take(hf + "mlp." + src + ".weight").T.contiguous()
            state[port + dst + ".bias"] = take(hf + "mlp." + src + ".bias")

    _check_all_consumed(state_dict, consumed,
                        r"\.attn\.(bias|masked_bias)$")

    lm = TransformerLM(
        vocab_size=cfg("vocab_size"),
        num_layers=layers,
        num_heads=heads,
        d_model=d_model,
        d_ff=d_ff,
        max_seq_len=horizon,
        norm_eps=float(cfg("layer_norm_epsilon", 1e-5)),
        compute_dtype=compute_dtype,
        device=device, seed=None)
    lm.load_state_dict(state)
    return lm


__all__ = ["import_hf_gpt2", "import_hf_llama"]
