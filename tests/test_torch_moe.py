"""`cloud_tpu_torch.models.moe` against `cloud_tpu/models/moe.py` on the
CPU: `TopKMoEMLP` and `routed_expert_ffn` (routes, gates, the kept
routes, output and aux loss) and `MoEMLP`, on the same numpy inputs and
parameters (d 32, E 4-16, f 48), and the port's sorted dispatch against
its one-hot reference (the JAX einsums, line by line).

Tolerances, with their reasons:
- routes (expert ids) and kept routes: equal. Router logits are f32
  products of the same values on both sides and no case puts two
  probabilities within their rounding of each other, except the zero
  router, where every probability is exactly 1/E and the tie-break
  decides.
- f32: output, gates and aux within 2e-5 relative and 1e-6 absolute
  (the frameworks sum the same f32 products in another order; outputs
  are O(0.1)).
- bf16: output element by element within 2^-8 |want| + 4e-2 rms(row)
  (rms over the row's d values, floored at 1e-2 of the tensor's rms).
  Both sides round g, u, act(g) * u, each expert's output and the
  combine weights to bf16 at the same points, but JAX's silu on bf16
  rounds sigmoid(g) and g * sigmoid(g) each to bf16, where PyTorch's
  rounds silu(g) once (GELU alike), so an element of act(g) * u may sit
  one bf16 step (2^-8 of it) apart; the down product spreads that over
  the row, measured at up to 0.028 rms(row) on these cases, and the
  output's own rounding adds 2^-8 |want|. Rows whose routes were all
  dropped are exact zeros on both sides.
- The sorted dispatch against its one-hot reference: f32 within 1e-6
  (the same products, summed in another order); bf16 bit-equal except
  for those sums (2^-8 relative, one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import moe as jmoe
from cloud_tpu_torch.models import moe as tmoe

D, F_ = 32, 48
F32 = dict(rtol=2e-5, atol=1e-6)


def _close_bf16(got, want):
    """|got - want| <= 2^-8 |want| + 4e-2 rms(row) (module doc)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    rms = np.maximum(np.sqrt((want ** 2).mean(-1, keepdims=True)),
                     1e-2 * np.sqrt((want ** 2).mean()))
    err = np.abs(got - want)
    worst = (err / (2.0 ** -8 * np.abs(want) + 4e-2 * rms)).max()
    assert worst <= 1.0, "error {:.3f} of the bound".format(worst)


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **F32)
    else:
        _close_bf16(got, want)


def _topk_params(rng, experts, zero_router=False):
    def draw(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(
            np.float32)
    return {"router": (np.zeros((D, experts), np.float32) if zero_router
                       else draw(D, experts) * 4),
            "expert_gate": draw(experts, D, F_),
            "expert_up": draw(experts, D, F_),
            "expert_down": draw(experts, F_, D)}


def _jax_keep(top_idx, experts, capacity):
    """The kept mask [k, T] of JAX's `routed_expert_ffn` (its lines)."""
    tokens, k = top_idx.shape
    sel = jax.nn.one_hot(jnp.asarray(top_idx), experts, dtype=jnp.float32)
    sel_sm = jnp.transpose(sel, (1, 0, 2)).reshape(k * tokens, experts)
    position = (jnp.cumsum(sel_sm, axis=0) - 1.0) * sel_sm
    keep = (position < capacity).astype(jnp.float32) * sel_sm
    return np.asarray(keep.sum(-1) > 0).reshape(k, tokens)


def _port_keep(top_idx, experts, capacity):
    tokens, k = top_idx.shape
    kept, sizes = tmoe.dispatch_plan(torch.from_numpy(np.asarray(top_idx)),
                                     experts, capacity)
    mask = np.zeros(k * tokens, bool)
    mask[kept.numpy()] = True
    assert sum(sizes) == len(kept)
    return mask.reshape(k, tokens)


TOPK_CASES = {
    # name: (experts, top_k, capacity_factor, norm_topk, zero_router)
    "binding": (8, 2, 0.5, True, False),
    "drop_free": (8, 2, None, True, False),
    "no_norm_topk": (16, 4, 1.0, False, False),
    "zero_router": (8, 2, 0.75, True, True),
    "k1": (4, 1, 0.5, True, False),
    "k_is_e": (4, 4, 0.6, True, False),
}


def _topk_models(name, dtype, seed=0):
    experts, k, cf, norm, zero = TOPK_CASES[name]
    rng = np.random.default_rng(seed)
    params = _topk_params(rng, experts, zero)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jmoe.TopKMoEMLP(num_experts=experts, top_k=k, d_ff=F_,
                         capacity_factor=cf, compute_dtype=jdtype,
                         norm_topk=norm)
    tm = tmoe.TopKMoEMLP(D, num_experts=experts, top_k=k, d_ff=F_,
                         capacity_factor=cf, compute_dtype=dtype,
                         norm_topk=norm, device="cpu")
    tm.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()})
    x = rng.normal(size=(3, 10, D)).astype(np.float32)
    return jm, params, tm, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_moe_matches_jax(name, dtype):
    """Routes, gates and kept routes, then the output and aux loss of
    the whole layer."""
    experts, k, cf, norm, _ = TOPK_CASES[name]
    jm, params, tm, x = _topk_models(name, dtype)
    xin = x if dtype == torch.float32 else x.astype(jnp.bfloat16)
    tokens = x.shape[0] * x.shape[1]
    # Routing, as JAX computes it inside the layer.
    logits = jnp.asarray(xin, jnp.float32).reshape(tokens, D) @ \
        params["router"]
    jprobs = jax.nn.softmax(logits, axis=-1)
    jtop, jidx = jax.lax.top_k(jprobs, k)
    jgates = jtop / jtop.sum(-1, keepdims=True) if norm else jtop
    tx = torch.from_numpy(np.array(jnp.asarray(xin, jnp.float32))).to(
        dtype)
    probs, top_idx, gates = tm.route(tx)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.detach().numpy(), np.asarray(jgates),
                               **F32)
    capacity = tm.capacity(tokens)
    want_cap = (tokens if cf is None
                else max(1, int(cf * tokens * k / experts)))
    assert capacity == want_cap
    keep = _port_keep(top_idx.numpy(), experts, capacity)
    np.testing.assert_array_equal(keep, _jax_keep(np.asarray(jidx), experts,
                                                  capacity))
    if cf is not None and name != "drop_free":
        assert not keep.all(), "the case should drop routes"
    jout, jaux = jm.apply({"params": params}, jnp.asarray(xin))
    out, aux = tm(tx)
    assert out.dtype == dtype and out.shape == x.shape
    _close(out.detach().float().numpy(), jout, dtype)
    np.testing.assert_allclose(aux.item(), float(jaux), **F32)


def test_zero_router_breaks_ties_to_the_lower_index():
    """Every probability is 1/E: jax.lax.top_k and the port pick experts
    0..k-1 in order, with gates 1/k; the aux loss is exactly k."""
    _, params, tm, x = _topk_models("zero_router", torch.float32)
    probs, top_idx, gates = tm.route(torch.from_numpy(x))
    assert (top_idx == torch.arange(2)).all()
    assert torch.equal(gates, torch.full_like(gates, 0.5))
    _, aux = tm(torch.from_numpy(x))
    assert aux.item() == pytest.approx(2.0, abs=1e-6)
    vals, idx = tmoe.top_k_lower_index(torch.tensor([[1., 3., 3., 1.]]), 3)
    assert idx.tolist() == [[1, 2, 0]] and vals.tolist() == [[3., 3., 1.]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["binding", "drop_free", "k_is_e"])
def test_routed_expert_ffn_matches_its_one_hot_reference(name, dtype):
    """The sorted dispatch against the JAX einsums mirrored in PyTorch,
    with gradients in f32."""
    experts, k, cf, norm, _ = TOPK_CASES[name]
    _, params, tm, x = _topk_models(name, dtype)
    tx = torch.from_numpy(x).reshape(-1, D).to(dtype)
    probs, top_idx, gates = tm.route(tx[None])
    capacity = tm.capacity(tx.shape[0])
    ws = [torch.from_numpy(params[n]).requires_grad_(True)
          for n in ("expert_gate", "expert_up", "expert_down")]
    got = tmoe.routed_expert_ffn(tx, top_idx, gates, *ws, capacity,
                                 compute_dtype=dtype)
    want = tmoe.routed_expert_ffn_reference(tx, top_idx, gates, *ws,
                                            capacity, compute_dtype=dtype)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        dy = torch.from_numpy(np.random.default_rng(1).normal(
            size=got.shape).astype(np.float32))
        g1 = torch.autograd.grad(got, ws, dy)
        g2 = torch.autograd.grad(want, ws, dy)
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -8,
                                   atol=1e-6)


def test_routed_expert_ffn_matches_jax_function():
    """The port's functional `routed_expert_ffn` against JAX's on the same
    top_idx, gates and weights (JAX's takes its weights from a module)."""
    rng = np.random.default_rng(4)
    experts, k, tokens = 8, 3, 40
    params = _topk_params(rng, experts)
    x = rng.normal(size=(tokens, D)).astype(np.float32)
    top_idx = np.stack([rng.permutation(experts)[:k] for _ in range(tokens)])
    gates = rng.random((tokens, k)).astype(np.float32)
    capacity = 9

    class Holder(jmoe.nn.Module):
        @jmoe.nn.compact
        def __call__(self, x2d, idx, g):
            return jmoe.routed_expert_ffn(self, x2d, idx, g, experts, F_,
                                          capacity, jax.nn.silu,
                                          jnp.float32)

    want = Holder().apply({"params": {n: params[n] for n in (
        "expert_gate", "expert_up", "expert_down")}}, jnp.asarray(x),
        jnp.asarray(top_idx), jnp.asarray(gates))
    got = tmoe.routed_expert_ffn(
        torch.from_numpy(x), torch.from_numpy(top_idx),
        torch.from_numpy(gates), *(torch.from_numpy(params[n]) for n in (
            "expert_gate", "expert_up", "expert_down")), capacity,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert not _port_keep(top_idx, experts, capacity).all()


def test_topk_moe_gradients_match_jax():
    """Gradients of sum(out * w) + aux through router, gates and experts,
    f32, at a binding capacity."""
    jm, params, tm, x = _topk_models("binding", torch.float32)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def loss(p):
        out, aux = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * w) + aux

    jgrads = jax.grad(loss)(params)
    out, aux = tm(torch.from_numpy(x))
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for name, param in tm.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(jgrads[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_topk_moe_rejects_bad_top_k():
    with pytest.raises(ValueError, match="top_k"):
        tmoe.TopKMoEMLP(D, num_experts=4, top_k=5, device="cpu")
    with pytest.raises(ValueError, match="activation"):
        tmoe.TopKMoEMLP(D, activation="relu", device="cpu")


# -- MoEMLP (Switch top-1) -------------------------------------------------

SWITCH_CASES = {
    # name: (experts, capacity_factor, zero_router)
    "binding": (4, 0.5, False),
    "roomy": (4, 4.0, False),
    "zero_router": (8, 1.25, True),
}


def _switch_models(name, dtype, seed=0):
    experts, cf, zero = SWITCH_CASES[name]
    rng = np.random.default_rng(seed)
    p = _topk_params(rng, experts, zero)
    params = {"router": p["router"], "expert_in": p["expert_gate"],
              "expert_out": p["expert_down"]}
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jmoe.MoEMLP(num_experts=experts, d_ff=F_, capacity_factor=cf,
                     compute_dtype=jdtype)
    tm = tmoe.MoEMLP(D, num_experts=experts, d_ff=F_, capacity_factor=cf,
                     compute_dtype=dtype, device="cpu")
    tm.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()})
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    return jm, params, tm, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SWITCH_CASES))
def test_switch_moe_matches_jax(name, dtype):
    """Output (tanh GELU experts) and aux loss; the zero router sends
    every token to expert 0 with aux exactly 1, and capacity
    int(1.25 * 24 / 8) = 3 keeps the first 3."""
    experts, cf, zero = SWITCH_CASES[name]
    jm, params, tm, x = _switch_models(name, dtype)
    xin = x if dtype == torch.float32 else x.astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jnp.asarray(xin, jnp.float32))).to(
        dtype)
    jout, jaux = jm.apply({"params": params}, jnp.asarray(xin))
    out, aux = tm(tx)
    _close(out.detach().float().numpy(), jout, dtype)
    np.testing.assert_allclose(aux.item(), float(jaux), **F32)
    assert tm.capacity(24) == max(1, int(cf * 24 / experts))
    if zero:
        assert aux.item() == 1.0
        _, index, _ = tm.route(tx)
        assert (index == 0).all()
        flat = out.reshape(24, D)
        assert (flat[3:] == 0).all() and (flat[:3] != 0).any()
    want = tmoe.switch_expert_ffn_reference(
        tx.reshape(24, D), *tm.route(tx)[1:], tm.expert_in, tm.expert_out,
        tm.capacity(24), compute_dtype=dtype)
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(out.reshape(24, D).float(), want.float(),
                               rtol=rtol, atol=1e-6)


def test_switch_router_noise_draws_from_the_generator():
    _, _, tm, x = _switch_models("binding", torch.float32)
    tm.router_noise = 1.0
    tx = torch.from_numpy(x)
    plain = tm(tx)[0]
    assert torch.equal(plain, tm(tx)[0])
    a = tm(tx, generator=torch.Generator().manual_seed(3))[0]
    b = tm(tx, generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b) and not torch.equal(a, plain)
