"""The port's HuggingFace importers (`import_hf_llama`, `import_hf_gpt2`)
against the JAX package's, on the CPU.

- Parameters: for each family, a HF-named numpy state dict drawn from a
  seed and its config dict go through JAX's importer and
  `llama_params_from_flax` / `params_from_flax`, and through the port's
  importer: every tensor bit for bit (both are renames, row splits,
  transposes and Gemma's + 1 in f32), and the model's configuration
  field by field. No `transformers` is needed.
- Logits: against tiny `transformers` models, where the package is
  installed (it is skipped otherwise), f32 within 2e-4 relative and
  absolute (3e-4 for the Gemma family), the JAX suite's own limits for
  the same comparison (`tests/unit/test_hf_import.py`): two frameworks
  summing the same products in another order over 2-3 layers.
- Every rejection of the JAX importers raises here too, the
  mixture-of-experts families' (Qwen3-MoE with dense layers) included.
"""

import jax
import numpy as np
import pytest
import torch

from cloud_tpu.models import hf_import as jhf
from cloud_tpu_torch.models import (generate, import_hf_gpt2,
                                    import_hf_llama, llama_params_from_flax,
                                    params_from_flax)

BASE = dict(model_type="llama", hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=48,
            num_hidden_layers=2, vocab_size=64, rope_theta=5000.0,
            rms_norm_eps=1e-5, max_position_embeddings=32)

# name: (config overrides, state-dict switches)
FAMILIES = {
    "llama": ({}, {}),
    "llama_tied_mha": (dict(num_key_value_heads=4), dict(tied=True)),
    "llama3_rope": (dict(rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0,
        high_freq_factor=4.0, original_max_position_embeddings=16)), {}),
    "linear_rope": (dict(rope_scaling=dict(type="linear", factor=2.0)), {}),
    "yarn_rope": (dict(rope_scaling=dict(rope_type="yarn", factor=4.0,
                                         mscale=1.0, mscale_all_dim=0.5)),
                  {}),
    "mistral_window": (dict(model_type="mistral", sliding_window=8), {}),
    "mistral_nemo_head_dim": (dict(model_type="mistral", head_dim=16), {}),
    "qwen2_bias_window": (dict(model_type="qwen2", sliding_window=8,
                               use_sliding_window=True,
                               max_window_layers=1), dict(bias=True)),
    "qwen2_window_gated_off": (dict(model_type="qwen2", sliding_window=8),
                               dict(bias=True)),
    "qwen3_qk_norm": (dict(model_type="qwen3", head_dim=16),
                      dict(qk_norm=True)),
    "gemma": (dict(model_type="gemma", head_dim=16,
                   hidden_act="gelu_pytorch_tanh"), dict(tied=True)),
    "gemma2": (dict(model_type="gemma2", head_dim=16, num_hidden_layers=3,
                    query_pre_attn_scalar=8, sliding_window=4,
                    attn_logit_softcapping=5.0,
                    final_logit_softcapping=3.0),
               dict(tied=True, sandwich=True)),
    "gemma3": (dict(model_type="gemma3_text", head_dim=16,
                    num_hidden_layers=3, query_pre_attn_scalar=16,
                    sliding_window=4, sliding_window_pattern=3,
                    rope_local_base_freq=100.0,
                    rope_scaling=dict(rope_type="linear", factor=2.0)),
               dict(tied=True, sandwich=True, qk_norm=True)),
    "phi3": (dict(model_type="phi3"), dict(fused=True)),
    "layer_types": (dict(model_type="mistral", sliding_window=6,
                         layer_types=["full_attention",
                                      "sliding_attention"]), {}),
    # The mixture-of-experts families: the routed experts in every block.
    "mixtral": (dict(model_type="mixtral", num_local_experts=4,
                     num_experts_per_tok=2), dict(moe="mixtral")),
    "qwen3_moe": (dict(model_type="qwen3_moe", head_dim=16, num_experts=8,
                       num_experts_per_tok=3, moe_intermediate_size=24,
                       norm_topk_prob=True),
                  dict(moe="qwen3_moe", qk_norm=True)),
}

# The fields that configure the model, compared between the importers.
FIELDS = ("vocab_size", "num_layers", "num_heads", "num_kv_heads",
          "d_model", "d_ff", "max_seq_len", "rope_theta", "rope_style",
          "norm_eps", "sliding_window", "qkv_bias", "mlp_activation",
          "scale_embed", "post_block_norms", "attn_scale",
          "attn_logit_softcap", "final_logit_softcap", "qk_norm",
          "attn_kinds", "rope_theta_local", "moe_experts", "moe_top_k",
          "moe_capacity_factor", "moe_norm_topk")


def hf_llama_state(cfg, seed=0, tied=False, bias=False, qk_norm=False,
                   sandwich=False, fused=False, moe=None):
    """A HF-named float32 state dict for `cfg`, drawn from `seed`, with
    a rotary buffer the importers skip; `moe` ("mixtral" or
    "qwen3_moe") puts that family's router and experts in place of the
    MLP."""
    rng = np.random.default_rng(seed)
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads", heads)
    hd = cfg.get("head_dim") or d // heads

    def w(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg["vocab_size"], d),
          "model.norm.weight": 1 + w(d)}
    if not tied:
        sd["lm_head.weight"] = w(cfg["vocab_size"], d)
    for i in range(cfg["num_hidden_layers"]):
        p = "model.layers.{}.".format(i)
        sd[p + "input_layernorm.weight"] = 1 + w(d)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(d)
        if sandwich:
            sd[p + "pre_feedforward_layernorm.weight"] = 1 + w(d)
            sd[p + "post_feedforward_layernorm.weight"] = 1 + w(d)
        if fused:
            sd[p + "self_attn.qkv_proj.weight"] = w((heads + 2 * kv) * hd, d)
            sd[p + "mlp.gate_up_proj.weight"] = w(2 * f, d)
        else:
            for name, n in (("q", heads), ("k", kv), ("v", kv)):
                sd[p + "self_attn.{}_proj.weight".format(name)] = w(n * hd, d)
                if bias:
                    sd[p + "self_attn.{}_proj.bias".format(name)] = w(n * hd)
            if not moe:
                sd[p + "mlp.gate_proj.weight"] = w(f, d)
                sd[p + "mlp.up_proj.weight"] = w(f, d)
        sd[p + "self_attn.o_proj.weight"] = w(d, heads * hd)
        if moe == "mixtral":
            experts, prefix = cfg["num_local_experts"], "block_sparse_moe."
            names, width = ("w1", "w3", "w2"), f
        elif moe:
            experts, prefix = cfg["num_experts"], "mlp."
            names = ("gate_proj", "up_proj", "down_proj")
            width = cfg["moe_intermediate_size"]
        else:
            sd[p + "mlp.down_proj.weight"] = w(d, f)
        if moe:
            sd[p + prefix + "gate.weight"] = w(experts, d)
            for e in range(experts):
                ex = p + prefix + "experts.{}.".format(e)
                sd[ex + names[0] + ".weight"] = w(width, d)
                sd[ex + names[1] + ".weight"] = w(width, d)
                sd[ex + names[2] + ".weight"] = w(d, width)
        if qk_norm:
            sd[p + "self_attn.q_norm.weight"] = 1 + w(hd)
            sd[p + "self_attn.k_norm.weight"] = 1 + w(hd)
        sd[p + "self_attn.rotary_emb.inv_freq"] = w(hd // 2)
    return sd


def _family(name):
    overrides, switches = FAMILIES[name]
    cfg = dict(BASE, **overrides)
    return cfg, hf_llama_state(cfg, seed=len(name), **switches)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key].cpu(), value), key


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_llama_import_equals_jax_bit_for_bit(name):
    cfg, sd = _family(name)
    jlm, variables = jhf.import_hf_llama(state_dict=sd, config=cfg)
    want = llama_params_from_flax(jax.device_get(variables))
    tlm = import_hf_llama(state_dict=sd, config=cfg,
                          compute_dtype=torch.float32, device="cpu")
    _assert_same_state(tlm.state_dict(), want)
    for field in FIELDS:
        assert getattr(tlm, field) == getattr(jlm, field), field
    assert tlm.head_dim == (jlm.head_dim or jlm.d_model // jlm.num_heads)
    for field in ("rope_scaling", "rope_scaling_local"):
        j, t = getattr(jlm, field), getattr(tlm, field)
        assert (j is None and t is None) or tuple(j) == tuple(t), field
    assert tlm.device == torch.device("cpu")
    assert tlm.compute_dtype == torch.float32


def test_llama_import_reads_torch_tensors_and_model_objects():
    """A `model=` with `.config` and `.state_dict()` of bf16 torch
    tensors imports as the same tensors in f32."""
    cfg, sd = _family("qwen2_bias_window")

    class Model:
        config = type("Config", (), cfg)

        def state_dict(self):
            return {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}

    got = import_hf_llama(model=Model(), compute_dtype=torch.float32,
                          device="cpu").state_dict()
    want = import_hf_llama(state_dict={
        k: v.float() for k, v in Model().state_dict().items()}, config=cfg,
        compute_dtype=torch.float32, device="cpu").state_dict()
    _assert_same_state(got, want)
    with pytest.raises(ValueError, match="Pass either"):
        import_hf_llama(state_dict=sd, device="cpu")


def hf_gpt2_state(cfg, seed=0, prefix="transformer.", head=True):
    rng = np.random.default_rng(seed)
    d = cfg["n_embd"]
    f = cfg.get("n_inner") or 4 * d

    def w(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    sd = {prefix + "wte.weight": w(cfg["vocab_size"], d),
          prefix + "wpe.weight": w(cfg["n_positions"], d),
          prefix + "ln_f.weight": 1 + w(d), prefix + "ln_f.bias": w(d)}
    if head:
        sd["lm_head.weight"] = w(cfg["vocab_size"], d)
    for i in range(cfg["n_layer"]):
        p = prefix + "h.{}.".format(i)
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = 1 + w(d)
            sd[p + ln + ".bias"] = w(d)
        sd[p + "attn.c_attn.weight"] = w(d, 3 * d)
        sd[p + "attn.c_attn.bias"] = w(3 * d)
        sd[p + "attn.c_proj.weight"] = w(d, d)
        sd[p + "attn.c_proj.bias"] = w(d)
        sd[p + "mlp.c_fc.weight"] = w(d, f)
        sd[p + "mlp.c_fc.bias"] = w(f)
        sd[p + "mlp.c_proj.weight"] = w(f, d)
        sd[p + "mlp.c_proj.bias"] = w(d)
        sd[p + "attn.bias"] = np.ones((1, 1, 4, 4), np.float32)
    return sd


GPT2 = dict(vocab_size=64, n_embd=32, n_layer=2, n_head=4, n_positions=32,
            layer_norm_epsilon=1e-5)


@pytest.mark.parametrize("prefix,head,max_seq_len",
                         [("transformer.", True, None), ("", False, 16)])
def test_gpt2_import_equals_jax_bit_for_bit(prefix, head, max_seq_len):
    sd = hf_gpt2_state(GPT2, seed=4, prefix=prefix, head=head)
    jlm, variables = jhf.import_hf_gpt2(state_dict=sd, config=GPT2,
                                        max_seq_len=max_seq_len)
    want = params_from_flax(jax.device_get(variables))
    tlm = import_hf_gpt2(state_dict=sd, config=GPT2,
                         compute_dtype=torch.float32,
                         max_seq_len=max_seq_len, device="cpu")
    _assert_same_state(tlm.state_dict(), want)
    for field in ("vocab_size", "num_layers", "num_heads", "d_model",
                  "d_ff", "max_seq_len", "norm_eps"):
        assert getattr(tlm, field) == getattr(jlm, field), field


def _rejects(importer, exc, match, cfg, sd):
    with pytest.raises(exc, match=match):
        importer(state_dict=sd, config=cfg, device="cpu")
    with pytest.raises(exc, match=match):
        getattr(jhf, importer.__name__)(state_dict=sd, config=cfg)


def test_llama_rejections_match_jax():
    cfg, sd = _family("llama")
    cases = [
        (NotImplementedError, "text tower", dict(model_type="gemma3"), {}),
        (NotImplementedError, "bidirectional",
         dict(model_type="gemma3_text", query_pre_attn_scalar=8,
              use_bidirectional_attention=True), {}),
        (NotImplementedError, "rope_scaling",
         dict(rope_scaling=dict(rope_type="longrope", factor=2.0)), {}),
        (NotImplementedError, "rope_scaling",
         dict(rope_scaling=dict(type="dynamic", factor=2.0)), {}),
        (NotImplementedError, "partial_rotary_factor",
         dict(partial_rotary_factor=0.5), {}),
        (NotImplementedError, "activation", dict(hidden_act="relu"), {}),
        (NotImplementedError, "layer_types",
         dict(layer_types=["chunked_attention", "full_attention"]), {}),
        (ValueError, "does not map", {},
         {"model.layers.0.self_attn.o_proj.bias": np.zeros(32, np.float32)}),
        (ValueError, "does not map", {},
         {"model.layers.1.mlp.down_proj.bias": np.zeros(32, np.float32)}),
        (ValueError, "missing 'hidden_size'", dict(hidden_size=None), {}),
        (ValueError, "yarn", dict(max_position_embeddings=0,
                                  rope_scaling=dict(rope_type="yarn",
                                                    factor=2.0)), {}),
    ]
    for exc, match, overrides, extra in cases:
        bad_cfg = {k: v for k, v in dict(cfg, **overrides).items()
                   if v is not None}
        _rejects(import_hf_llama, exc, match, bad_cfg, dict(sd, **extra))
    missing = dict(sd)
    del missing["model.layers.1.mlp.up_proj.weight"]
    _rejects(import_hf_llama, KeyError, "missing", cfg, missing)


@pytest.mark.parametrize("model_type", ["mixtral", "qwen3_moe"])
def test_moe_families_raise_with_the_roadmap_item(model_type):
    """The MoE families import (test_llama_import_equals_jax_bit_for_bit
    has their tensors): drop-free, with each family's HF defaults for a
    raw config missing the routing keys, as JAX's importer reads them;
    what JAX rejects (Qwen3-MoE with dense layers interleaved, a
    missing expert) raises here too."""
    cfg, sd = _family(model_type)
    tlm = import_hf_llama(state_dict=sd, config=cfg, device="cpu")
    assert tlm.moe_capacity_factor is None and all(
        hasattr(b, "moe") for b in tlm.blocks)
    bare = {k: v for k, v in cfg.items()
            if k not in ("num_experts_per_tok", "norm_topk_prob")}
    jlm, _ = jhf.import_hf_llama(state_dict=sd, config=bare)
    tlm = import_hf_llama(state_dict=sd, config=bare, device="cpu")
    assert (tlm.moe_top_k, tlm.moe_norm_topk) == \
        (jlm.moe_top_k, jlm.moe_norm_topk) == \
        ((8, False) if model_type == "qwen3_moe" else (2, True))
    if model_type == "qwen3_moe":
        for overrides in (dict(mlp_only_layers=[1]),
                          dict(decoder_sparse_step=2)):
            _rejects(import_hf_llama, NotImplementedError, "mlp_only_layers",
                     dict(cfg, **overrides), sd)
    missing = dict(sd)
    del missing[next(k for k in sd if ".experts.1." in k)]
    _rejects(import_hf_llama, KeyError, "missing", cfg, missing)


def test_gpt2_rejections_match_jax():
    sd = hf_gpt2_state(GPT2)
    for overrides, exc, match in (
            (dict(activation_function="relu"), NotImplementedError,
             "activation"),
            (dict(scale_attn_by_inverse_layer_idx=True),
             NotImplementedError, "inverse_layer_idx"),
            (dict(reorder_and_upcast_attn=True), NotImplementedError,
             "reorder"),
            (dict(scale_attn_weights=False), NotImplementedError,
             "scale_attn_weights")):
        _rejects(import_hf_gpt2, exc, match, dict(GPT2, **overrides), sd)
    _rejects(import_hf_gpt2, ValueError, "does not map", GPT2,
             dict(sd, **{"transformer.h.0.attn.adapter.weight":
                         np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match="n_positions"):
        import_hf_gpt2(state_dict=sd, config=GPT2, max_seq_len=64,
                       device="cpu")


# -- against tiny `transformers` models -----------------------------------


@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


def _hf_logits(hf, tokens):
    with torch.no_grad():
        return hf(torch.from_numpy(tokens)).logits.float().numpy()


def _tiny(transformers, kind, **kw):
    config = getattr(transformers, kind + "Config")(**kw)
    torch.manual_seed(0)
    return getattr(transformers, kind + "ForCausalLM")(config).eval()


SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=32,
             rms_norm_eps=1e-6, attn_implementation="eager")

TINY = {
    "Llama": (dict(tie_word_embeddings=False), 2e-4),
    "Gemma2": (dict(num_hidden_layers=3, head_dim=16,
                    query_pre_attn_scalar=8, sliding_window=4,
                    attn_logit_softcapping=5.0,
                    final_logit_softcapping=3.0), 3e-4),
    "Qwen2": (dict(tie_word_embeddings=False), 2e-4),
    "Phi3": (dict(intermediate_size=48, pad_token_id=0, bos_token_id=1,
                  eos_token_id=2, tie_word_embeddings=False), 2e-4),
    # The MoE families, imported drop-free as HF routes.
    "Mixtral": (dict(num_local_experts=4, num_experts_per_tok=2,
                     tie_word_embeddings=False), 2e-4),
    "Qwen3Moe": (dict(num_experts=8, num_experts_per_tok=2,
                      moe_intermediate_size=24, norm_topk_prob=True,
                      head_dim=8, tie_word_embeddings=False), 2e-4),
}


@pytest.mark.parametrize("kind", sorted(TINY))
def test_logits_match_transformers(transformers, kind):
    overrides, tol = TINY[kind]
    hf = _tiny(transformers, kind, **dict(SMALL, **overrides))
    tokens = np.random.default_rng(3).integers(0, 64, size=(2, 16))
    lm = import_hf_llama(hf, compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, tokens), rtol=tol,
                               atol=tol)


def test_llama_greedy_generate_matches_transformers(transformers):
    hf = _tiny(transformers, "Llama", **dict(SMALL,
                                             tie_word_embeddings=False))
    prompt = np.random.default_rng(4).integers(0, 64, size=(2, 8))
    lm = import_hf_llama(hf, compute_dtype=torch.float32, device="cpu")
    got = generate(lm, prompt, 6, temperature=0.0)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt), max_new_tokens=6,
                           do_sample=False, use_cache=True, pad_token_id=0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_gpt2_logits_and_greedy_generate_match_transformers(transformers):
    config = transformers.GPT2Config(vocab_size=64, n_embd=32, n_layer=2,
                                     n_head=4, n_positions=32,
                                     attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(config).eval()
    tokens = np.random.default_rng(5).integers(0, 64, size=(2, 16))
    lm = import_hf_gpt2(hf, compute_dtype=torch.float32, device="cpu")
    assert lm.norm_eps == pytest.approx(1e-5)
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, tokens), rtol=2e-4,
                               atol=2e-4)
    prompt = tokens[:, :8]
    out = generate(lm, prompt, 4, temperature=0.0)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt), max_new_tokens=4,
                           do_sample=False, use_cache=True, pad_token_id=0)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
