"""`LlamaLM` with the top-k MoE MLP (Mixtral / Qwen3-MoE: `moe_experts`,
q/k norms) in the PyTorch port against the JAX package on the same numpy
parameters, f32 on the CPU, at 2 layers, d 64, 4 heads over 2 KV heads,
8 experts of width 32, top 2: the training forward (logits, each
block's aux loss, the loss with the aux and every parameter's gradient),
`Trainer.fit` with `aux_loss_weight` (the history and the parameters),
`evaluate` (no aux), greedy `generate()` at a capacity that binds at
decode and drop-free, and the converters.

Tolerances, with their reasons:
- routes: the logits and losses below only agree if every token takes
  the same experts on both sides; no case puts two router probabilities
  within f32 rounding of each other.
- logits, aux losses, the loss and gradients: 3e-5 relative and
  absolute (f32 on both sides, the frameworks summing the same products
  in another order over 2 blocks; the aux gradient reaches the router
  through the mean router probabilities).
- `Trainer.fit` (adamw, 2 epochs of 3 steps) and `evaluate`: 1e-4, as
  `test_torch_llama.py` (Adam's first steps magnify rounding
  differences).
- greedy tokens: equal. Converters: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import llama as jl
from cloud_tpu.models.transformer import generate as jgenerate
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import (LlamaLM, generate, llama_params_from_flax,
                                    llama_params_to_flax)
from cloud_tpu_torch.training import trainer as ttrainer

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=32, max_seq_len=64, norm_eps=1e-6, qk_norm=True,
           moe_experts=8, moe_top_k=2)
TOL = 3e-5


def _models(capacity_factor=2.0, norm_topk=True, seed=3):
    kw = dict(CFG, moe_capacity_factor=capacity_factor,
              moe_norm_topk=norm_topk)
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, **kw)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    # A router that prefers some experts, so capacity binds.
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 4 if "router" in jax.tree_util.keystr(p) else a,
        params)
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu", **kw)
    tmodel.load_state_dict(llama_params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("capacity_factor,norm_topk",
                         [(1.0, True), (None, True), (0.5, False)],
                         ids=["binding", "drop_free", "no_norm_topk"])
def test_logits_aux_and_gradients_match_jax(capacity_factor, norm_topk):
    jmodel, params, tmodel = _models(capacity_factor, norm_topk)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 64, size=(2, 24))
    labels = rng.integers(0, 64, size=(2, 24))

    def loss(p):
        logits, sown = jmodel.apply({"params": p}, jnp.asarray(tokens),
                                    mutable=["losses"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1)
        auxes = [sown["losses"]["block_%d" % i]["moe_aux_loss"]
                 for i in range(2)]
        return jnp.mean(nll) + 0.01 * sum(auxes), (logits, auxes)

    (jloss, (jlogits, jaux)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(params)
    tmodel.train()
    logits = tmodel(torch.from_numpy(tokens))
    assert len(tmodel.aux_losses) == 2
    tloss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).reshape(-1)) \
        + 0.01 * sum(tmodel.aux_losses)
    tloss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose([a.item() for a in tmodel.aux_losses],
                               [float(a) for a in jaux], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = _leaves(llama_params_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, 4, 2))
    want = _leaves(jgrads)
    assert set(grads) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(grads[key], w, rtol=TOL, atol=TOL,
                                   err_msg=key)
    # Eval and decode forwards collect nothing.
    tmodel.eval()
    with torch.no_grad():
        tmodel(torch.from_numpy(tokens))
    assert tmodel.aux_losses == []


def test_trainer_fit_adds_the_aux_loss_as_jax_does():
    """2 epochs of 3 adamw steps from the same parameters: the history
    (loss with 0.01 x the aux) and the parameters; evaluate without the
    aux; accumulation over 2 steps divides the aux with the loss."""
    jmodel, params, _ = _models(capacity_factor=1.0)
    params = jax.device_get(params)  # the JAX Trainer donates its buffers
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(16, 17))
    x, y = tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)
    for accumulation in (1, 2):
        jt = jtrainer.Trainer(jmodel, optimizer="adamw",
                              metrics=("accuracy",), seed=0,
                              gradient_accumulation_steps=accumulation)
        jt.build(x[:1], variables={"params": params})
        tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu",
                         moe_capacity_factor=1.0, **CFG)
        tt = ttrainer.Trainer(tmodel, optimizer="adamw",
                              metrics=("accuracy",), seed=0,
                              gradient_accumulation_steps=accumulation)
        assert tt.aux_loss_weight == jt.aux_loss_weight == 0.01
        tt.build(variables=llama_params_from_flax(params))
        kw = dict(epochs=2, batch_size=4, steps_per_epoch=3, verbose=False)
        jh, th = jt.fit(x, y, **kw), tt.fit(x, y, **kw)
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
        got = _leaves(llama_params_to_flax(tmodel.state_dict(), 4, 2))
        for key, w in _leaves(jax.device_get(jt.state.params)).items():
            np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    je = jt.evaluate(x[:6], y[:6], batch_size=4, verbose=False)
    te = tt.evaluate(x[:6], y[:6], batch_size=4, verbose=False)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4, atol=1e-4)
    # evaluate's loss is the data loss alone.
    tmodel.eval()
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(x[:4]).long())
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(y[:4]).long().reshape(-1))
    four = tt.evaluate(x[:4], y[:4], batch_size=4, verbose=False)
    np.testing.assert_allclose(four["loss"], ce.item(), rtol=1e-6)


def test_aux_loss_weight_enters_the_training_loss():
    """The first step's logged loss with weight w minus that with weight
    0 is w x the sum of the forward's aux losses."""
    _, params, _ = _models(capacity_factor=1.0)
    state = llama_params_from_flax(jax.device_get(params))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, size=(4, 17))
    x, y = tokens[:, :-1], tokens[:, 1:]
    losses = {}
    for weight in (0.0, 0.5):
        tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu",
                         moe_capacity_factor=1.0, **CFG)
        tt = ttrainer.Trainer(tmodel, optimizer="sgd", seed=0,
                              aux_loss_weight=weight)
        tt.build(variables=state)
        losses[weight] = tt.fit(x, y, batch_size=4, shuffle=False,
                                verbose=False)["loss"][0]
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu",
                     moe_capacity_factor=1.0, **CFG)
    tmodel.load_state_dict(state)
    tmodel(torch.from_numpy(x))
    aux = sum(a.item() for a in tmodel.aux_losses)
    np.testing.assert_allclose(losses[0.5] - losses[0.0], 0.5 * aux,
                               rtol=1e-5)


def _left_padded(rng, batch=3, seq=10, pads=(0, 2, 5)):
    tokens = rng.integers(0, 64, size=(batch, seq))
    mask = np.ones((batch, seq), bool)
    for row, pad in enumerate(pads):
        mask[row, :pad] = False
        tokens[row, :pad] = 0
    return tokens, mask


@pytest.mark.parametrize("capacity_factor", [1.0, None],
                         ids=["binding", "drop_free"])
def test_greedy_generate_matches_jax(capacity_factor):
    """generate() at temperature 0 on a left-padded batch (bucketed to
    16, the pads routed with the rest): the tokens equal JAX's. At
    factor 1.0 a decode step's 3 tokens x 2 routes get capacity
    int(6 / 8) -> 1 per expert, so routes are dropped at every step."""
    jmodel, params, tmodel = _models(capacity_factor)
    if capacity_factor is not None:
        assert tmodel.blocks[0].moe.capacity(3) == 1
    rng = np.random.default_rng(5)
    prompt, mask = _left_padded(rng)
    want = jgenerate(jmodel, params, jnp.asarray(prompt), 8,
                     temperature=0.0, prompt_mask=jnp.asarray(mask))
    got = generate(tmodel, prompt, 8, temperature=0.0, prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_converters_round_trip_with_moe_bit_equal():
    jmodel, params, tmodel = _models()
    state = llama_params_from_flax({"params": jax.device_get(params)})
    assert set(state) == set(tmodel.state_dict())
    assert state["blocks.1.moe.router"].shape == (64, 8)
    assert state["blocks.0.moe.expert_down"].shape == (8, 32, 64)
    back = _leaves(llama_params_to_flax(state, 4, 2))
    for key, w in _leaves(jax.device_get(params)).items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)
    np.testing.assert_array_equal(
        state["blocks.0.moe.expert_gate"].numpy(),
        np.asarray(params["block_0"]["moe"]["expert_gate"]))
    with pytest.raises(ValueError, match="unmapped"):
        llama_params_from_flax({"block_0": {"moe": {"expert_in": np.zeros(
            (2, 2, 2))}}})
    with pytest.raises(ValueError, match="unmapped"):
        llama_params_to_flax({"blocks.0.moe.gate": torch.zeros(2)}, 4)
