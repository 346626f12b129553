"""`TransformerLM` (decode and the training forward with its parameter
gradients), its parameter converters and `generate()`: the PyTorch port
against the JAX package on the same parameters and tokens, at a small
f32 size on the CPU.

Tolerance: logits and gradients within 1e-5 (f32 on both sides; the
frameworks sum the same products in another order, at |logit| < ~2);
1e-4 over int8
pages, where a K/V value that lands within an f32 rounding of a
quantization boundary may round to the neighbouring int8 step. The
int8 page write itself is compared bit for bit: it is elementwise f32
arithmetic and round-half-to-even on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import decoding as jdec
from cloud_tpu.models import transformer as jtf
from cloud_tpu_torch.models import (TransformerLM, generate, params_from_flax,
                                    params_to_flax)
from cloud_tpu_torch.models import transformer as ttf

TOL = 1e-5
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=64)


@pytest.fixture(scope="module")
def jax_model():
    model = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                              **CFG)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    # Non-trivial norms and biases so the converter's every leaf matters.
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    return model, params


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params = jax_model
    model = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                          device="cpu", **CFG)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def test_params_from_flax_round_trips(jax_model, port_model):
    _, params = jax_model
    state = port_model.state_dict()
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(state) == len(flat)
    q = np.asarray(params["block_1"]["attention"]["query"]["kernel"])
    np.testing.assert_array_equal(
        state["blocks.1.attention.query.weight"].numpy(),
        q.reshape(q.shape[0], -1).T)
    o = np.asarray(params["block_0"]["attention"]["out"]["kernel"])
    np.testing.assert_array_equal(
        state["blocks.0.attention.out.weight"].numpy(),
        o.reshape(-1, o.shape[-1]).T)
    np.testing.assert_array_equal(
        state["lm_head.weight"].numpy(),
        np.asarray(params["lm_head"]["kernel"]).T)
    np.testing.assert_array_equal(
        state["blocks.0.ln_mlp.weight"].numpy(),
        np.asarray(params["block_0"]["ln_mlp"]["scale"]))
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax({"block_0": {"attention": {"rope": {
            "kernel": np.zeros((2, 2))}}}})


def _jax_decode(model, params, cache, tokens, mask, **clone):
    decoder = model.clone(decode=True, **clone)
    logits, vars_ = decoder.apply(
        {"params": params, "cache": cache}, jnp.asarray(tokens),
        None if mask is None else jnp.asarray(mask), mutable=["cache"])
    return np.asarray(logits), vars_["cache"]


def test_dense_decode_logits_match_jax(jax_model, port_model):
    """Left-padded prefill, then two single-token steps."""
    model, params = jax_model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, size=(2, 8))
    mask = np.ones((2, 8), bool)
    mask[1, :3] = False
    jcache = jdec.empty_cache(model.clone(decode=True), 2)
    tcache = port_model.init_cache(2)
    steps = [(tokens, mask)] + [(rng.integers(0, 64, size=(2, 1)), None)
                                for _ in range(2)]
    for tok, m in steps:
        jl, jcache = _jax_decode(model, params, jcache, tok, m)
        tl = port_model(torch.from_numpy(tok),
                        None if m is None else torch.from_numpy(m), tcache)
        np.testing.assert_allclose(tl.numpy()[:, -1], jl[:, -1],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("page_dtype", ["", "int8"])
def test_paged_decode_logits_match_jax(jax_model, port_model, page_dtype):
    """Slots at different depths over a shared pool: a 3-token window
    (the verify-window shape), then single-token ticks with one slot
    inactive."""
    model, params = jax_model
    page_size, num_pages, slots = 8, 20, 3
    clone = dict(kv_page_size=page_size, kv_num_pages=num_pages,
                 kv_page_dtype=page_dtype)
    jcache = jax.device_get(jdec.empty_cache(model.clone(decode=True,
                                                         **clone), slots))
    tcache = port_model.init_cache(slots, page_size=page_size,
                                   num_pages=num_pages,
                                   page_dtype=page_dtype)
    table = np.zeros((slots, 8), np.int32)
    table[:, :3] = 1 + np.random.default_rng(2).permutation(
        num_pages - 1)[:9].reshape(slots, 3)
    jcache = {k: dict(v) if isinstance(v, dict) else jnp.asarray(v)
              for k, v in jcache.items()}
    for i in range(model.num_layers):
        att = dict(jcache["block_%d" % i]["attention"])
        att["page_table"] = table
        jcache["block_%d" % i] = {
            "attention": {k: jnp.asarray(v) for k, v in att.items()}}
        tcache["layers"][i]["page_table"].copy_(torch.from_numpy(table))
    rng = np.random.default_rng(3)
    window = rng.integers(0, 64, size=(slots, 3))
    wmask = np.ones((slots, 3), bool)
    wmask[2, 2] = False
    steps = [(window, wmask)]
    for _ in range(3):
        steps.append((rng.integers(0, 64, size=(slots, 1)),
                      np.array([[True], [False], [True]])))
    tol = TOL if not page_dtype else 1e-4
    for tok, m in steps:
        jl, jcache = _jax_decode(model, params, jcache, tok, m, **clone)
        tl = port_model(torch.from_numpy(tok), torch.from_numpy(m),
                        tcache).numpy()
        live = m
        np.testing.assert_allclose(tl[live], jl[live], atol=tol, rtol=tol)
    for i in range(model.num_layers):
        jatt = jcache["block_%d" % i]["attention"]
        tatt = tcache["layers"][i]
        np.testing.assert_array_equal(tatt["slot_steps"].numpy(),
                                      np.asarray(jatt["slot_steps"]))
        np.testing.assert_array_equal(tatt["slot_valid"].numpy(),
                                      np.asarray(jatt["slot_valid"]))


def test_quantized_page_write_bitwise(jax_model):
    rng = np.random.default_rng(4)
    pages = rng.integers(-127, 128, size=(6, 8, 2, 16)).astype(np.int8)
    scales = rng.uniform(0.0, 0.02, size=(6, 2)).astype(np.float32)
    scales[3] = 0.0
    x = (rng.normal(size=(3, 2, 2, 16)) * np.array(
        [0.5, 3.0, 1.0])[:, None, None, None]).astype(np.float32)
    phys = np.array([[1, 1], [3, 3], [4, 5]])
    off = np.array([[2, 3], [0, 1], [7, 0]])
    jp, js = jtf._quantized_page_write(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(x),
        jnp.asarray(phys), jnp.asarray(off))
    tp, ts = ttf._quantized_page_write(
        torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy()),
        torch.from_numpy(x), torch.from_numpy(phys), torch.from_numpy(off))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("eos", [None, 5])
def test_generate_greedy_matches_jax_left_padded(jax_model, port_model,
                                                 eos):
    model, params = jax_model
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 64, size=(3, 7))
    mask = np.ones((3, 7), bool)
    mask[0, :4] = False
    mask[2, :1] = False
    want = np.asarray(jtf.generate(model, params, jnp.asarray(prompt), 12,
                                   temperature=0.0, eos_token=eos,
                                   prompt_mask=jnp.asarray(mask)))
    got = generate(port_model, prompt, 12, temperature=0.0, eos_token=eos,
                   prompt_mask=mask).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_is_seeded(port_model):
    prompt = np.array([[3, 9, 27, 17]])
    a = generate(port_model, prompt, 10, seed=7, temperature=0.8, top_k=20,
                 top_p=0.9)
    b = generate(port_model, prompt, 10, seed=7, temperature=0.8, top_k=20,
                 top_p=0.9)
    c = generate(port_model, prompt, 10, seed=8, temperature=0.8, top_k=20,
                 top_p=0.9)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        generate(port_model, prompt, 3, temperature=0.5)


def test_warp_logits_matches_jax():
    from cloud_tpu_torch.models import decoding as tdec

    logits = np.random.default_rng(6).normal(size=(4, 64)).astype(
        np.float32)
    logits[0, 10] = logits[0, 11]  # an exact tie at the nucleus edge
    want = np.asarray(jdec.warp_logits(jnp.asarray(logits), 0.7, 20, 0.8))
    got = tdec.warp_logits(torch.from_numpy(logits), 0.7, 20, 0.8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_non_decode_forward_is_not_ported(port_model):
    """The non-decode forward is ported (see the tests below), with the
    MoE MLP (test_moe_training_forward_matches_jax); an MoE model's
    generate() and serving, and bidirectional blocks, raise."""
    from cloud_tpu_torch.serving import Scheduler

    moe = TransformerLM(moe_experts=4, device="cpu", **CFG)
    assert all(hasattr(b, "moe") for b in moe.blocks)
    with pytest.raises(NotImplementedError, match="item 5"):
        generate(moe, np.zeros((1, 4), np.int64), 2, temperature=0.0)
    with pytest.raises(NotImplementedError, match="item 5"):
        Scheduler(moe, slots=2)
    with pytest.raises(NotImplementedError, match="TransformerEncoder"):
        ttf.TransformerBlock(64, 4, 128, 1e-5, None, causal=False)
    logits = port_model(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, CFG["vocab_size"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_training_forward_matches_jax(dtype):
    """A Switch-MoE TransformerLM (8 experts, capacity factor 1.25, which
    binds): logits and each block's aux loss against JAX's (its sown
    "losses"), and in f32 every gradient of the cross entropy plus 0.01
    x the aux. f32: TOL. bf16: the port keeps the residual stream, the
    final norm and the head in f32 where JAX rounds them to bf16 (ROADMAP
    §3): each of those roundings moves a logit by up to 2^-8 of the
    values it came from, and 2 blocks' residual adds and the head's
    output at |logits| < ~2 reach 0.07 here, so the logits agree within
    0.1; the aux losses within 1e-2 relative (block 1's router reads
    that residual stream, and a 2^-8 change of its logits, which the
    sharpened router makes ~5, moves each probability by ~1%)."""
    cfg = dict(CFG, moe_experts=8)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jtf.TransformerLM(compute_dtype=jdtype, norm_eps=1e-5, **cfg)
    params = jmodel.init(jax.random.PRNGKey(4),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 8 if "router" in jax.tree_util.keystr(p) else a,
        params)
    tmodel = TransformerLM(compute_dtype=dtype, norm_eps=1e-5, device="cpu",
                           **cfg)
    tmodel.load_state_dict(params_from_flax(jax.device_get(params)))
    tokens = rng.integers(0, 64, size=(2, 20))
    labels = rng.integers(0, 64, size=(2, 20))

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
    aux = [a.item() for a in tmodel.aux_losses]
    tol = TOL if dtype == torch.float32 else 0.1
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(aux, [float(a) for a in jaux],
                               rtol=TOL if dtype == torch.float32 else 1e-2)
    assert all(a > 1.0 for a in aux)  # the router is far from uniform
    if dtype == torch.bfloat16:
        return
    tloss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).reshape(-1)) \
        + 0.01 * sum(tmodel.aux_losses)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL)
    grads = params_to_flax({n: p.grad for n, p in tmodel.named_parameters()},
                           4)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        node = grads
        for entry in path:
            node = node[entry.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4,
                                   atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _jax_train_loss(model, tokens, labels, mask):
    def loss(params):
        logits = model.apply({"params": params}, jnp.asarray(tokens),
                             None if mask is None else jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                   -1)
        return jnp.mean(nll), logits
    return loss


@pytest.mark.parametrize("masked", [False, True])
def test_training_forward_and_gradients_match_jax(jax_model, port_model,
                                                  masked):
    """The non-decode forward (flash attention, which CPU tensors run
    through its plain version) and every parameter's gradient against
    jax.grad of the JAX model with attention_impl="flash" (interpret
    mode), at S = 40 (not a block multiple)."""
    model, params = jax_model
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 64, size=(2, 40))
    labels = rng.integers(0, 64, size=(2, 40))
    mask = None
    if masked:
        mask = np.ones((2, 40), bool)
        mask[1, 25:] = False
    flash = model.clone(attention_impl="flash")
    (jl, jlogits), jgrads = jax.value_and_grad(
        _jax_train_loss(flash, tokens, labels, mask), has_aux=True)(params)
    port_model.zero_grad(set_to_none=True)
    logits = port_model(torch.from_numpy(tokens),
                        None if mask is None else torch.from_numpy(mask))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).reshape(-1))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.item(), float(jl), atol=TOL, rtol=TOL)
    grads = params_to_flax({n: p.grad for n, p in
                            port_model.named_parameters()},
                           CFG["num_heads"])
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        node = grads
        for entry in path:
            node = node[entry.key]
        np.testing.assert_allclose(node, np.asarray(want), atol=TOL,
                                   rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    port_model.zero_grad(set_to_none=True)


def test_params_to_flax_inverts_params_from_flax(jax_model, port_model):
    _, params = jax_model
    back = params_to_flax(port_model.state_dict(), CFG["num_heads"])
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    assert len(want) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in want:
        node = back
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    with pytest.raises(ValueError, match="unmapped"):
        params_to_flax({"blocks.0.attention.rope.weight": torch.zeros(2)},
                       4)


def test_dropout_needs_a_generator_and_is_inverted(port_model):
    """Dropout only with deterministic=False and a generator; kept values
    are scaled by 1 / (1 - rate)."""
    x = torch.ones((4, 1000))
    gen = torch.Generator().manual_seed(0)
    y = ttf._dropout(x, 0.25, gen)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < kept.float().mean().item() < 0.8
    drop = TransformerLM(compute_dtype=torch.float32, device="cpu",
                         dropout_rate=0.5, **CFG)
    tok = torch.zeros((1, 4), dtype=torch.long)
    a = drop(tok)
    assert torch.equal(a, drop(tok, deterministic=False))
    b = drop(tok, deterministic=False,
             generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, b)
