"""The Trainer options of the image slice against the JAX Trainer on the
CPU: `steps_per_execution` (histories against JAX's grouped fits, bit
for bit against the port's own single-step fit: on the CPU a group is a
loop of the same steps; leftover and ragged batches; weighted groups),
`remat=True` (bit for bit against the plain step, with dropout drawn
from the step's generator and with BatchNorm, whose running averages
move once), and `warmup()` / `fit(warm_start=True)` (the warm step's
effects undone: the fit equals a cold one bit for bit).

Tolerances: a port fit against JAX's, 1e-5 (f32 models, other
summation orders); the port against itself, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jmnist
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import (ResNet, TransformerLM, ViT, convert)
from cloud_tpu_torch.models import mnist as tmnist
from cloud_tpu_torch.models import resnet as tresnet
from cloud_tpu_torch.ops import _build
from cloud_tpu_torch.training import trainer as ttrainer


def _toy(n=192, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    return x, y


def _pair(spe, optimizer="adam", lr=1e-2, **kw):
    """A JAX Trainer and a port Trainer on the same f32 MLP weights."""
    x, _ = _toy(8)
    jopt = {"adam": optax.adam(lr),
            "sgd": optax.sgd(lr, momentum=0.9)}[optimizer]
    jt = jtrainer.Trainer(jmnist.MLP(hidden=16, num_classes=4,
                                     compute_dtype=jnp.float32),
                          optimizer=jopt, seed=0, steps_per_execution=spe,
                          **kw)
    jt.build(x)
    tm = tmnist.MLP(hidden=16, num_classes=4, in_features=8,
                    compute_dtype=torch.float32, device="cpu")
    tt = ttrainer.Trainer(tm, optimizer=ttrainer.make_optimizer(
        optimizer, lr), seed=0, steps_per_execution=spe, **kw)
    tt.build(x, variables=convert.image_params_from_flax(
        {"params": jt.state.params}))
    return jt, tt


def _state(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- steps_per_execution ------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_spe_history_matches_jax_and_single_step(optimizer):
    x, y = _toy()
    jt, tt = _pair(3, optimizer)
    jh = jt.fit(x, y, epochs=3, batch_size=32, shuffle=True, verbose=False)
    th = tt.fit(x, y, epochs=3, batch_size=32, shuffle=True, verbose=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["accuracy"], jh["accuracy"], rtol=1e-5)
    assert tt.state.step == int(jt.state.step) == 18
    _, single = _pair(1, optimizer)
    hs = single.fit(x, y, epochs=3, batch_size=32, shuffle=True,
                    verbose=False)
    assert hs["loss"] == th["loss"]
    _same(_state(single), _state(tt))


def test_spe_leftover_and_ragged_batches_run_singly():
    x, y = _toy(160)
    _, tt = _pair(2)
    tt.fit(x, y, epochs=1, batch_size=32, shuffle=False, verbose=False)
    assert tt.state.step == 5
    x, y = _toy(112)
    batches = [(x[i:i + 32], y[i:i + 32]) for i in (0, 32, 64)]
    batches.append((x[96:], y[96:]))          # a ragged 16-row tail
    jt, tt = _pair(2)
    jh = jt.fit(batches, epochs=2, verbose=False)
    th = tt.fit(batches, epochs=2, verbose=False)
    assert tt.state.step == 8
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)


def test_weighted_spe_with_leftover_matches_jax():
    x, y = _toy(96)
    w = np.linspace(0.2, 2.0, 96).astype(np.float32)
    jt, tt = _pair(2, "sgd", lr=0.0)
    jh = jt.fit(x, y, epochs=1, batch_size=32, shuffle=False,
                sample_weight=w, verbose=False)
    th = tt.fit(x, y, epochs=1, batch_size=32, shuffle=False,
                sample_weight=w, verbose=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["accuracy"], jh["accuracy"], rtol=1e-5)
    logs = tt.evaluate(x, y, batch_size=32, sample_weight=w, verbose=False)
    assert th["accuracy"][0] == pytest.approx(logs["accuracy"], rel=1e-5)


def test_spe_rejects_zero_and_loops_on_the_cpu():
    with pytest.raises(ValueError, match="steps_per_execution"):
        ttrainer.Trainer(torch.nn.Linear(2, 2), steps_per_execution=0)
    _, tt = _pair(4)
    tt.build()
    assert tt._spe_route == "loop"


# -- remat --------------------------------------------------------------------

def _lm(dropout):
    return TransformerLM(vocab_size=32, num_layers=2, num_heads=2,
                         d_model=16, d_ff=32, max_seq_len=8,
                         dropout_rate=dropout, compute_dtype=torch.float32,
                         device="cpu", seed=0)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_equals_plain_with_dropout(dropout):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 32, size=(16, 8)).astype(np.int32)
    y = rng.integers(0, 32, size=(16, 8)).astype(np.int32)
    runs = []
    for remat in (False, True):
        trainer = ttrainer.Trainer(
            _lm(dropout), optimizer="adamw", seed=3, remat=remat,
            train_kwargs={"deterministic": False})
        h = trainer.fit(x, y, epochs=2, batch_size=4, verbose=False)
        runs.append((h["loss"], _state(trainer)))
    assert runs[0][0] == runs[1][0]
    _same(runs[0][1], runs[1][1])


@pytest.mark.parametrize("kind", ["resnet", "vit"])
def test_remat_equals_plain_and_moves_stats_once(kind):
    x = np.random.default_rng(1).normal(size=(8, 16, 16, 3)).astype(
        np.float32)
    y = np.arange(8) % 5
    runs = []
    for remat in (False, True):
        if kind == "resnet":
            model = tresnet.ResNet(stage_sizes=(1, 1), num_classes=5,
                                   num_filters=8, block=tresnet.BasicBlock,
                                   compute_dtype=torch.float32, device="cpu")
        else:
            model = ViT(num_classes=5, patch_size=4, num_layers=2,
                        num_heads=2, d_model=16, d_ff=32, image_size=16,
                        compute_dtype=torch.float32, device="cpu")
        trainer = ttrainer.Trainer(
            model, optimizer=ttrainer.make_optimizer("sgd", 0.1), seed=0,
            remat=remat, train_kwargs={"train": True},
            eval_kwargs={"train": False})
        h = trainer.fit(x, y, epochs=2, batch_size=4, shuffle=False,
                        verbose=False)
        runs.append((h["loss"], _state(trainer), trainer))
    assert runs[0][0] == runs[1][0]
    _same(runs[0][1], runs[1][1])
    if kind == "resnet":
        # Running averages moved once per step: one manual flax update
        # from the plain run's statistics before its last step would
        # differ; equality with the plain run (above) is the check, and
        # the step count is 4 in both.
        assert runs[1][2].state.step == 4
        np.testing.assert_allclose(
            runs[1][2].evaluate(x, y, batch_size=4, verbose=False)["loss"],
            runs[0][2].evaluate(x, y, batch_size=4, verbose=False)["loss"])


# -- warm starts --------------------------------------------------------------

def _resnet_trainer(**kw):
    model = ResNet(stage_sizes=(1,), num_classes=3, num_filters=8,
                   compute_dtype=torch.float32, device="cpu", seed=2)
    return ttrainer.Trainer(model, optimizer=ttrainer.make_optimizer(
        "sgd", 0.1), seed=0, train_kwargs={"train": True},
        eval_kwargs={"train": False}, **kw)


@pytest.mark.parametrize("cache", [None, "device"])
def test_warm_start_fit_equals_cold_fit(cache):
    x = np.random.default_rng(2).normal(size=(12, 9, 9, 3)).astype(
        np.float32)
    y = np.arange(12) % 3
    cold, warm = _resnet_trainer(), _resnet_trainer()
    hc = cold.fit(x, y, epochs=2, batch_size=4, cache=cache, verbose=False)
    hw = warm.fit(x, y, epochs=2, batch_size=4, cache=cache,
                  warm_start=True, verbose=False)
    assert hc["loss"] == hw["loss"]
    _same(_state(cold), _state(warm))
    for a, b in zip(cold.optimizer.state.values(),
                    warm.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])


def test_warmup_then_fit_moves_no_counter():
    x, y = _toy(64)
    _, tt = _pair(2, "sgd", lr=0.1)
    before = _state(tt)
    stats = tt.warmup(x, y, batch_size=16, input_cast="bfloat16",
                      include_eval=True, include_predict=True)
    assert stats == {"builds": _build.build_count(),
                     "captures": ttrainer.graph_captures()}
    _same(before, _state(tt))
    assert tt.state.step == 0
    builds, captures = _build.build_count(), ttrainer.graph_captures()
    tt.fit(x, y, epochs=1, batch_size=16, input_cast="bfloat16",
           verbose=False)
    assert (_build.build_count(), ttrainer.graph_captures()) == (builds,
                                                                captures)
    with pytest.raises(ValueError, match="labels"):
        tt.warmup(x, batch_size=16, include_eval=True)
