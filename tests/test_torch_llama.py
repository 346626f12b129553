"""`LlamaLM` of the PyTorch port (training forward, parameter gradients,
RoPE, the converters and `Trainer.fit`) against the JAX package on the
same parameters and tokens, at a small f32 size on the CPU (2 layers,
d 64, 4 heads over 2 KV heads, d_ff 176). The JAX model runs with
`attention_impl="flash"` (its Pallas flash kernels in interpret mode);
its fused norm and MLP then take their lax references, which the JAX
suite holds bitwise to its kernels in f32.

Tolerances, with their reasons:
- `apply_rope`: 1e-5 (f32 rotation on both sides; the angles at
  positions < 64 agree to a few f32 steps).
- logits and every parameter's gradient: 2e-5 relative and absolute
  (f32 on both sides; the frameworks sum the same products in another
  order over 2 blocks, |logits| up to ~4, gradients up to ~0.5).
- the converters: bit-equal round trip (transposes and reshapes only).
- `Trainer.fit` (adamw, 2 epochs of 3 steps): history and final
  parameters within 1e-4. Adam's first steps divide by sqrt(v) + eps
  with v near 0 for small gradients, which magnifies the frameworks'
  rounding differences (as in `test_torch_training.py`). `evaluate`'s
  accuracy within one token of the 96 it scores: a token whose top two
  logits lie within that difference may take the other argmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import llama as jl
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import (LlamaLM, RopeScaling, apply_rope,
                                    llama_params_from_flax,
                                    llama_params_to_flax)
from cloud_tpu_torch.models import llama as tl
from cloud_tpu_torch.training import trainer as ttrainer

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=176, max_seq_len=64, norm_eps=1e-5)
TOL = 2e-5

SCALINGS = {
    "none": None,
    "linear": dict(kind="linear", factor=4.0),
    "llama3": dict(kind="llama3", factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_len=32),
    "yarn": dict(kind="yarn", factor=4.0, original_max_len=32,
                 mscale=1.0, mscale_all_dim=0.5),
}


@pytest.mark.parametrize("scaling", sorted(SCALINGS))
@pytest.mark.parametrize("style", ["interleaved", "rotate_half"])
def test_apply_rope_matches_jax(style, scaling):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    spec = SCALINGS[scaling]
    jscale = None if spec is None else jl.RopeScaling(**spec)
    tscale = None if spec is None else RopeScaling(**spec)
    for positions in (np.arange(40), rng.integers(0, 60, size=(2, 40))):
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(positions), 500.0,
                             style, jscale)
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                         500.0, style, tscale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # bf16 in, bf16 out (the rotation itself in f32).
    xb = torch.from_numpy(x).bfloat16()
    got = apply_rope(xb, torch.arange(40), 500.0, style, tscale)
    assert got.dtype == torch.bfloat16
    want = apply_rope(xb.float(), torch.arange(40), 500.0, style, tscale)
    assert torch.equal(got, want.bfloat16())


def test_yarn_attention_factor_matches_jax():
    for spec in ({"kind": "yarn", "factor": 4.0},
                 {"kind": "yarn", "factor": 4.0, "attention_factor": 0.7},
                 {"kind": "yarn", "factor": 8.0, "mscale": 1.0,
                  "mscale_all_dim": 0.5}):
        assert tl.yarn_attention_factor(RopeScaling(**spec)) == \
            jl.yarn_attention_factor(jl.RopeScaling(**spec))
    with pytest.raises(ValueError, match="Unknown RopeScaling kind"):
        apply_rope(torch.zeros((1, 2, 1, 4)), torch.arange(2),
                   scaling=RopeScaling("ntk", 2.0))
    with pytest.raises(ValueError, match="RoPE style"):
        apply_rope(torch.zeros((1, 2, 1, 4)), torch.arange(2),
                   style="halves")


# -- the model -----------------------------------------------------------

VARIANTS = {
    "base": {},
    "qkv_bias": dict(qkv_bias=True),
    "gelu_tanh_scale_embed": dict(mlp_activation="gelu_tanh",
                                  scale_embed=True),
    "gemma2": dict(post_block_norms=True, attn_logit_softcap=2.0,
                   final_logit_softcap=3.0, attn_scale=0.4,
                   attn_kinds=("local", "global"), sliding_window=8),
    "qk_norm_theta_local": dict(qk_norm=True, rope_theta_local=100.0,
                                attn_kinds=("local", "global"),
                                sliding_window=12),
    "rotate_half": dict(rope_style="rotate_half",
                        rope_scaling=("llama3", 4.0)),
    "head_dim": dict(head_dim=32),
    # Gemma 2 at head_dim 256 (google/gemma-2-2b's head_dim, softcaps,
    # query scale 1/16, alternating local and global layers, gelu_tanh,
    # scaled embedding, sandwich norms) at narrow widths.
    "gemma2_head_dim256": dict(head_dim=256, post_block_norms=True,
                               attn_logit_softcap=50.0,
                               final_logit_softcap=30.0, attn_scale=1 / 16,
                               attn_kinds=("local", "global"),
                               sliding_window=8, mlp_activation="gelu_tanh",
                               scale_embed=True),
    "key_mask": dict(mlp_activation="gelu"),
}


def _variant(name):
    kw = dict(VARIANTS[name])
    jkw, tkw = dict(kw), dict(kw)
    if "rope_scaling" in kw:
        kind, factor = kw["rope_scaling"]
        jkw["rope_scaling"] = jl.RopeScaling(kind, factor,
                                             original_max_len=32)
        tkw["rope_scaling"] = RopeScaling(kind, factor, original_max_len=32)
    return jkw, tkw


def _jax_params(model, seed):
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    # Non-trivial norm scales and biases, so every leaf matters.
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _models(name, seed=3):
    jkw, tkw = _variant(name)
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, attention_impl="flash",
                        **CFG, **jkw)
    params = _jax_params(jmodel, seed)
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu", **CFG, **tkw)
    tmodel.load_state_dict(llama_params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_logits_and_gradients_match_jax(name):
    """Logits and every parameter's gradient of a cross-entropy loss at
    S 40 (not a multiple of the kernels' blocks)."""
    jmodel, params, tmodel = _models(name)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 64, size=(2, 40))
    labels = rng.integers(0, 64, size=(2, 40))
    mask = None
    if name == "key_mask":
        mask = np.ones((2, 40), bool)
        mask[1, 25:] = False
        mask[0, 3] = False

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens),
                              None if mask is None else jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1)
        return jnp.mean(nll), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tmodel(torch.from_numpy(tokens),
                    None if mask is None else torch.from_numpy(mask))
    tloss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).reshape(-1))
    tloss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = _leaves(llama_params_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, 4, 2))
    want = _leaves(jgrads)
    assert set(grads) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(grads[key], w, rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_converters_round_trip_bit_equal():
    """Every kind of leaf (biases, q/k norms, sandwich norms) there and
    back, bit for bit; unmapped names raise."""
    jkw, tkw = _variant("qkv_bias")
    extra = dict(qk_norm=True, post_block_norms=True)
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, **CFG, **jkw, **extra)
    params = jax.device_get(_jax_params(jmodel, 5))
    state = llama_params_from_flax({"params": params})
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu", **CFG,
                     **tkw, **extra)
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    back = _leaves(llama_params_to_flax(tmodel.state_dict(), 4, 2))
    want = _leaves(params)
    assert set(back) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)
    q = np.asarray(params["block_1"]["attention"]["query"]["kernel"])
    np.testing.assert_array_equal(
        state["blocks.1.attention.query.weight"].numpy(),
        q.reshape(q.shape[0], -1).T)
    with pytest.raises(ValueError, match="unmapped"):
        llama_params_from_flax({"block_0": {"mlp": {"gate": {
            "bias": np.zeros(2)}}}})
    with pytest.raises(ValueError, match="unmapped"):
        llama_params_to_flax({"blocks.0.mlp.gate.bias": torch.zeros(2)}, 4)


def test_unported_paths_raise():
    # decode=True is ported (tests/test_torch_llama_decode.py).
    assert LlamaLM(decode=True, device="cpu", **CFG).decode
    # The MoE MLP is ported (tests/test_torch_llama_moe.py).
    moe = LlamaLM(moe_experts=4, device="cpu", **CFG)
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in moe.blocks)
    assert moe.blocks[0].moe.expert_gate.shape == (4, 64, 176)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="parallel/"):
            LlamaLM(attention_impl=impl, device="cpu", **CFG)
    with pytest.raises(ValueError, match="sliding_window"):
        LlamaLM(attn_kinds=("local",), device="cpu", **CFG)
    with pytest.raises(ValueError, match="Unknown mlp activation"):
        LlamaLM(mlp_activation="relu", device="cpu", **CFG)
    model = LlamaLM(compute_dtype=torch.float32, device="cpu", **CFG)
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros((1, 65), dtype=torch.long))


def test_bf16_forward_runs_in_the_compute_dtype():
    """The residual stream and the head run in bf16 (as in JAX); the
    logits come out f32 and the kernels' plain versions run on the
    CPU."""
    from cloud_tpu_torch.ops import fused_mlp, fused_norm

    model = LlamaLM(compute_dtype=torch.bfloat16, device="cpu", **CFG)
    seen = []
    hook = model.blocks[0].register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    fused_norm.reset_launches()
    fused_mlp.reset_launches()
    logits = model(torch.zeros((2, 8), dtype=torch.long))
    hook.remove()
    assert logits.dtype == torch.float32 and seen == [torch.bfloat16]
    assert not any(fused_norm.launches.values())
    assert not any(fused_mlp.launches.values())
    assert torch.isfinite(logits).all()


def test_dropout_is_seeded_by_the_generator():
    model = LlamaLM(compute_dtype=torch.float32, device="cpu",
                    dropout_rate=0.3, **CFG)
    tok = torch.zeros((1, 8), dtype=torch.long)
    a = model(tok)
    assert torch.equal(a, model(tok, deterministic=False))
    b = model(tok, deterministic=False,
              generator=torch.Generator().manual_seed(1))
    c = model(tok, deterministic=False,
              generator=torch.Generator().manual_seed(1))
    assert torch.equal(b, c) and not torch.equal(a, b)


def test_trainer_fit_matches_jax():
    """A few adamw steps of `Trainer.fit` (2 epochs of 3, shuffled) from
    the same parameters: history, final parameters, evaluate and
    predict."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(16, 17))
    x, y = tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, attention_impl="flash",
                        **CFG)
    jt = jtrainer.Trainer(jmodel, optimizer="adamw", metrics=("accuracy",),
                          seed=0)
    jt.build(x[:1])
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu", **CFG)
    tt = ttrainer.Trainer(tmodel, optimizer="adamw", metrics=("accuracy",),
                          seed=0)
    tt.build(variables=llama_params_from_flax(jax.device_get(
        jt.state.params)))
    kw = dict(epochs=2, batch_size=4, steps_per_epoch=3, verbose=False)
    jh, th = jt.fit(x, y, **kw), tt.fit(x, y, **kw)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert th["loss"][1] < th["loss"][0]
    got = _leaves(llama_params_to_flax(tmodel.state_dict(), 4, 2))
    for key, w in _leaves(jax.device_get(jt.state.params)).items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    je = jt.evaluate(x[:6], y[:6], batch_size=4, verbose=False)
    te = tt.evaluate(x[:6], y[:6], batch_size=4, verbose=False)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4, atol=1e-4)
    # 96 scored tokens: one whose top two logits sit within the
    # frameworks' rounding difference may take the other argmax.
    assert abs(te["accuracy"] - je["accuracy"]) <= 1 / 96 + 1e-9
    np.testing.assert_allclose(tt.predict(x[:3], batch_size=2),
                               np.asarray(jt.predict(x[:3], batch_size=2)),
                               rtol=1e-3, atol=1e-3)
