"""The port's callbacks, EMA and `trainable=` against the JAX package on
the CPU: two Trainers on a small `TransformerLM` (and a small `LlamaLM`
for `trainable=`) from the same parameters and data, the same callbacks,
then their histories, JSONL records, TensorBoard scalars, restored
weights, EMA shadows and frozen leaves compared; and the hook contract
the port keeps on its own (order of calls, teardown isolation, signal
handlers put back).

Tolerances, with their reasons: 1e-5 wherever values of the two
frameworks meet (f32 models trained with sgd, as the slice tests of
`test_torch_training.py`; float32 TensorBoard scalars hold them exactly
as written); bit-equality within the port (frozen parameters, handlers,
records of one run).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import llama as jl
from cloud_tpu.models import transformer as jtf
from cloud_tpu.training import callbacks as jcb
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu.utils import events as jevents
from cloud_tpu_torch.models import (LlamaLM, TransformerLM,
                                    params_from_flax, params_to_flax)
from cloud_tpu_torch.models import convert
from cloud_tpu_torch.training import callbacks as tcb
from cloud_tpu_torch.training import trainer as ttrainer
from cloud_tpu_torch.utils import events as tevents

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=32)
LLAMA_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                 d_model=64, d_ff=176, max_seq_len=64, norm_eps=1e-5)
TOL = 1e-5


def _data(seed, n, seq=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], size=(n, seq + 1))
    return tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)


def _pair(**kw):
    """A JAX and a port Trainer (sgd, seed 0) on the same parameters."""
    jmodel = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                               **CFG)
    jt = jtrainer.Trainer(jmodel, optimizer="sgd", metrics=("accuracy",),
                          seed=0, **kw)
    jt.build(np.zeros((1, 16), np.int32))
    tmodel = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                           device="cpu", **CFG)
    tt = ttrainer.Trainer(tmodel, optimizer="sgd", metrics=("accuracy",),
                          seed=0, **kw)
    tt.build(variables=params_from_flax(jax.device_get(jt.state.params)))
    return jt, tt


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + k + "/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_params_close(port_state, jax_params, tol=TOL):
    got = _flat(params_to_flax(port_state, CFG["num_heads"]))
    want = _flat(jax.device_get(jax_params))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=tol, atol=tol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Trainers (ema_decay 0.9) fit 6 epochs of 2 steps with a
    MetricsLogger, a TensorBoard and EarlyStopping on the loss in "max"
    mode with patience 1 and restore_best_weights: the loss falls, so
    epoch 0 stays best and the fit stops after epoch 2, putting epoch
    0's weights back."""
    x, y = _data(0, 24)
    root = tmp_path_factory.mktemp("callbacks")
    out = {}
    for name, trainer, lib in zip(("jax", "port"), _pair(ema_decay=0.9),
                                  (jcb, tcb)):
        d = root / name
        stop = lib.EarlyStopping(monitor="loss", mode="max", patience=1,
                                 restore_best_weights=True)
        history = trainer.fit(
            x, y, epochs=6, batch_size=4, steps_per_epoch=2, verbose=False,
            callbacks=[lib.MetricsLogger(str(d / "metrics.jsonl")),
                       lib.TensorBoard(str(d / "tb")), stop])
        out[name] = dict(trainer=trainer, history=history, dir=d)
    return out


def test_early_stopping_stops_and_restores_as_jax_does(runs):
    jh, th = runs["jax"]["history"], runs["port"]["history"]
    assert len(th["loss"]) == len(jh["loss"]) == 3
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=TOL, atol=TOL)
    _assert_params_close(runs["port"]["trainer"].model.state_dict(),
                         runs["jax"]["trainer"].state.params)


def test_metrics_logger_records_match_jax(runs):
    got = tcb.read_metrics_log(str(runs["port"]["dir"] / "metrics.jsonl"))
    want = jcb.read_metrics_log(str(runs["jax"]["dir"] / "metrics.jsonl"))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1,
                                                                       2]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(a[key], b[key], rtol=TOL, atol=TOL)


def test_tensorboard_scalars_read_back_as_jax_wrote_them(runs):
    def scalars(reader, log_dir):
        (name,) = os.listdir(log_dir)
        return reader(os.path.join(log_dir, name))

    got = scalars(tevents.read_events, runs["port"]["dir"] / "tb")
    want = scalars(jevents.read_events, runs["jax"]["dir"] / "tb")
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b) and "epoch_loss" in a
        for tag in ("epoch_loss", "epoch_accuracy"):
            np.testing.assert_allclose(a[tag], b[tag], rtol=TOL, atol=TOL)
    # The port's file is the same wire format: JAX's reader takes it.
    assert scalars(jevents.read_events, runs["port"]["dir"] / "tb") == got


def test_ema_params_match_jax(runs):
    """The shadow after 6 applied updates, through the converters, and
    `evaluate(use_ema=True)` on it (EarlyStopping's restore leaves the
    shadow alone in both)."""
    jt, tt = runs["jax"]["trainer"], runs["port"]["trainer"]
    _assert_params_close(tt.ema_params, jt.ema_params)
    x, y = _data(1, 5)
    je = jt.evaluate(x, y, batch_size=4, verbose=False, use_ema=True)
    te = tt.evaluate(x, y, batch_size=4, verbose=False, use_ema=True)
    for key in je:
        np.testing.assert_allclose(te[key], je[key], rtol=TOL, atol=TOL)
    live = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    tt.predict(x, batch_size=4, use_ema=True)
    for n, p in tt.model.named_parameters():   # the live weights are back
        assert torch.equal(p, live[n])


def test_terminate_on_nan_history_matches_jax():
    """A NaN sample weight poisons the first batch that draws it: the
    loss of that epoch is NaN and TerminateOnNaN stops the fit there, in
    both packages at the same epoch with the same finite epochs
    before."""
    x, y = _data(2, 24)
    w = np.ones(24, np.float32)
    w[17] = np.nan
    histories = []
    for trainer, lib in zip(_pair(), (jcb, tcb)):
        histories.append(trainer.fit(
            x, y, epochs=8, batch_size=4, steps_per_epoch=2,
            sample_weight=w, verbose=False, callbacks=[lib.TerminateOnNaN()]))
    jh, th = histories
    assert 1 < len(th["loss"]) == len(jh["loss"]) < 8
    assert np.isnan(th["loss"][-1]) and np.isnan(jh["loss"][-1])
    np.testing.assert_allclose(th["loss"][:-1], jh["loss"][:-1], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("trainable", [
    "lm_head|block_1", r"attention/(query|key)/", "^embed", "/bias$",
    lambda path: path.endswith("scale")])
def test_trainable_selects_the_leaves_jax_does(trainable):
    jt, tt = _pair()
    labels = jtrainer._trainable_labels(jt.state.params, trainable)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): label
            == "train" for p, label in
            jax.tree_util.tree_leaves_with_path(labels)}
    got = {convert.transformer_param_path(name): on for name, on in
           ttrainer.trainable_mask(tt.model, trainable).items()}
    assert got == want and any(got.values())


def test_trainable_selects_llama_leaves_as_jax_does():
    jmodel = jl.LlamaLM(compute_dtype=jnp.float32, **LLAMA_CFG)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = LlamaLM(compute_dtype=torch.float32, device="cpu",
                     **LLAMA_CFG)
    for trainable in ("lm_head|block_1", "mlp/(gate|up)", "norm"):
        labels = jtrainer._trainable_labels(params, trainable)
        want = {jax.tree_util.keystr(p, simple=True, separator="/"): label
                == "train" for p, label in
                jax.tree_util.tree_leaves_with_path(labels)}
        got = {convert.llama_param_path(name): on for name, on in
               ttrainer.trainable_mask(tmodel, trainable).items()}
        assert got == want, trainable


def test_trainable_fit_matches_jax():
    """One epoch of sgd with `trainable="lm_head|block_1"`: every
    parameter against JAX's, the frozen ones bit for bit unchanged."""
    x, y = _data(3, 16)
    jt, tt = _pair(trainable="lm_head|block_1")
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    for trainer in (jt, tt):
        trainer.fit(x, y, epochs=1, batch_size=4, verbose=False)
    _assert_params_close(tt.model.state_dict(), jt.state.params)
    mask = ttrainer.trainable_mask(tt.model, "lm_head|block_1")
    for n, p in tt.model.named_parameters():
        assert torch.equal(p, before[n]) != mask[n], n


def test_frozen_parameters_get_no_adamw_state_or_decay():
    x, y = _data(4, 8)
    model = TransformerLM(compute_dtype=torch.float32, device="cpu", seed=0,
                          **CFG)
    tt = ttrainer.Trainer(model, optimizer="adamw", seed=0,
                          trainable="lm_head")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tt.fit(x, y, epochs=1, batch_size=4, verbose=False)
    assert len(tt.optimizer.state) == 1   # lm_head.weight alone
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n != "lm_head.weight"), n
    with pytest.raises(ValueError, match="matches no parameter"):
        ttrainer.Trainer(model, trainable="nothing-here").build()


class _Recorder(tcb.Callback):
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def on_train_begin(self):
        self.calls.append((self.name, "train_begin",
                           self.trainer.planned_epochs,
                           self.trainer.initial_epoch))

    def on_epoch_begin(self, epoch):
        self.calls.append((self.name, "epoch_begin", epoch))

    def on_epoch_end(self, epoch, logs):
        self.calls.append((self.name, "epoch_end", epoch))

    def on_train_end(self, history):
        self.calls.append((self.name, "train_end", len(history["loss"])))


def _small_trainer(**kw):
    model = torch.nn.Linear(4, 3)
    torch.manual_seed(0)
    return ttrainer.Trainer(model, optimizer="sgd", seed=0, **kw)


def _small_data(n=32):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def test_hooks_run_in_order_and_teardown_failures_are_isolated():
    x, y = _small_data()
    calls = []

    class Exploding(tcb.Callback):
        def on_train_end(self, history):
            raise RuntimeError("commit failed")

    trainer = _small_trainer()
    with pytest.raises(RuntimeError, match="commit failed"):
        trainer.fit(x, y, epochs=3, initial_epoch=1, batch_size=8,
                    verbose=False,
                    callbacks=[_Recorder(calls, "a"), Exploding(),
                               _Recorder(calls, "b")])
    assert calls == [
        ("a", "train_begin", 3, 1), ("b", "train_begin", 3, 1),
        ("a", "epoch_begin", 1), ("b", "epoch_begin", 1),
        ("a", "epoch_end", 1), ("b", "epoch_end", 1),
        ("a", "epoch_begin", 2), ("b", "epoch_begin", 2),
        ("a", "epoch_end", 2), ("b", "epoch_end", 2),
        ("a", "train_end", 2), ("b", "train_end", 2)]


def test_request_stop_ends_the_epoch_at_the_next_step():
    x, y = _small_data()
    trainer = _small_trainer()
    seen = []

    class StopAfterTwo(tcb.Callback):
        def on_epoch_begin(self, epoch):
            if epoch == 1:
                self.trainer.request_stop()

        def on_epoch_end(self, epoch, logs):
            seen.append(epoch)

    history = trainer.fit(x, y, epochs=4, batch_size=8, verbose=False,
                          callbacks=[StopAfterTwo()])
    # Epoch 1 aborts before its first step: no epoch end, no history.
    assert seen == [0] and len(history["loss"]) == 1
    assert trainer.state.step == 4


def test_preemption_checkpoint_saves_stops_and_restores_handlers(tmp_path):
    from cloud_tpu_torch.training import checkpoint as ckpt

    x, y = _small_data()
    trainer = _small_trainer()
    before = signal.getsignal(signal.SIGTERM)
    sent = []

    def preempt(epoch):
        if epoch == 1 and not sent:
            sent.append(epoch)
            # The callback's handler is in place (else the signal would
            # end the test process).
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)

    history = trainer.fit(
        x, y, epochs=5, batch_size=8, verbose=False,
        callbacks=[tcb.LambdaCallback(on_epoch_begin=preempt),
                   tcb.PreemptionCheckpoint(str(tmp_path))])
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(history["loss"]) == 1 and trainer.state.step == 4
    assert ckpt.latest_step(str(tmp_path)) == 4
