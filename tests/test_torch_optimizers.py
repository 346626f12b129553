"""The port's optimizers against optax on the CPU: each of the eight
names in `OPTIMIZERS` (and `make_optimizer` with a learning rate or a
schedule) over 6 steps of seeded gradients on a 128 x 256 matrix (the
factored branch of Adafactor), a 2 x 3 x 130 x 128 tensor (factored
over its two largest axes) and a vector, from the same parameters.

Tolerances, with their reasons: the same f32 formulas in another
operation order (optax's `(1 - d) g^2 + d nu` against a multiply, then
an add with alpha; `rsqrt` against `pow(-0.5)`) differ by a few ulps a
step, and a rsqrt of a small second moment or a trust ratio multiplies
them: 2e-5 relative plus 2e-6 of the update's scale (lr x steps) on the
parameters. Lion's sign update is exact wherever (1 - b1) g + b1 m is
not within rounding of 0, which seeded normal gradients never are: its
parameters agree to 1e-6. The state tensors after the steps agree to
the same limits, and go through `torch.save` / `weights_only=True`.
"""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.training import schedules as jsched
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.training import optimizers as topt
from cloud_tpu_torch.training import schedules as tsched
from cloud_tpu_torch.training import trainer as ttrainer

SHAPES = {"w": (128, 256), "c": (2, 3, 130, 128), "b": (256,)}
STEPS = 6
NAMES = ["adam", "adamw", "sgd", "rmsprop", "adagrad", "adafactor",
         "lamb", "lion"]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) * 0.5
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.normal(size=s).astype(np.float32) * (0.1 + step)
            for k, s in SHAPES.items()}


def _run_optax(tx, params):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    for step in range(STEPS):
        grads = {k: jnp.asarray(v) for k, v in _grads(step).items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(make, params):
    tensors = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = make(list(tensors.values()))
    for step in range(STEPS):
        schedule = getattr(opt, "lr_schedule", None)
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = float(schedule(step))
        for k, g in _grads(step).items():
            tensors[k].grad = torch.tensor(g)
        opt.step()
    return {k: v.detach().numpy() for k, v in tensors.items()}, opt


def _close(got, want, lr):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                   atol=2e-6 * max(lr, 1e-3) * STEPS
                                   + 2e-6 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_named_optimizer_matches_optax(name):
    params = _params()
    want = _run_optax(jtrainer.OPTIMIZERS[name](), params)
    got, _ = _run_port(ttrainer.OPTIMIZERS[name], params)
    lr = {"sgd": 1e-2, "adagrad": 1e-2, "lion": 1e-4}.get(name, 1e-3)
    if name == "lion":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    else:
        _close(got, want, lr)


@pytest.mark.parametrize("name,optax_fn", [
    ("rmsprop", optax.rmsprop), ("adagrad", optax.adagrad),
    ("lamb", optax.lamb), ("lion", optax.lion),
    ("adafactor", lambda lr: optax.adafactor(learning_rate=lr))])
@pytest.mark.parametrize("scheduled", [False, True])
def test_make_optimizer_rate_and_schedule(name, optax_fn, scheduled):
    params = _params(1)
    if scheduled:
        jlr = jsched.warmup_cosine(3e-3, STEPS, warmup_steps=2)
        tlr = tsched.warmup_cosine(3e-3, STEPS, warmup_steps=2)
    else:
        jlr = tlr = 3e-3
    want = _run_optax(optax_fn(jlr), params)
    got, _ = _run_port(ttrainer.make_optimizer(name, tlr), params)
    if name == "lion":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    else:
        _close(got, want, 3e-3)


def test_adafactor_state_is_factored_like_optax():
    params = _params()
    opt = topt.Adafactor([torch.nn.Parameter(torch.tensor(v))
                          for v in params.values()])
    state = list(opt.state.values())
    jstate = optax.adafactor().init({k: jnp.asarray(v)
                                     for k, v in params.items()})
    inner = jstate[0]
    for s, k in zip(state, params):
        if "v_row" in s:
            assert tuple(s["v_row"].shape) == inner.v_row[k].shape
            assert tuple(s["v_col"].shape) == inner.v_col[k].shape
        else:
            assert tuple(s["v"].shape) == inner.v[k].shape
    assert topt.factored_dims((128, 256)) == (0, 1)
    assert topt.factored_dims((127, 256)) is None
    assert topt.factored_dims((256,)) is None


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "adafactor",
                                  "lamb", "lion"])
def test_state_round_trips_weights_only(name):
    params = _params()
    _, opt = _run_port(ttrainer.OPTIMIZERS[name], params)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=True)
    fresh = ttrainer.OPTIMIZERS[name](
        [torch.nn.Parameter(torch.tensor(v)) for v in params.values()])
    fresh.load_state_dict(loaded)
    for a, b in zip(opt.state.values(), fresh.state.values()):
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_tensor_learning_rate_equals_float():
    """A 0-d tensor learning rate (what a captured step reads) gives the
    float rate's result bit for bit."""
    params = _params()
    for cls in (topt.RMSprop, topt.Adagrad, topt.Lamb, topt.Lion):
        a, _ = _run_port(lambda p, cls=cls: cls(p, lr=2e-3), params)
        b, _ = _run_port(lambda p, cls=cls: cls(p, lr=torch.tensor(2e-3)),
                         params)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
