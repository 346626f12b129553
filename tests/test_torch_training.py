"""The port's training slice against the JAX package on the CPU: the
shuffle order, `ArrayDataset`, the schedules, losses, metrics, one
optimizer update, and `Trainer.fit` / `evaluate` / `predict` on a small
`TransformerLM` from the same parameters.

Tolerances, with their reasons:
- `epoch_permutation` and `ArrayDataset` batches: bit-equal (integer
  threefry arithmetic and the same stable sort).
- schedules: 1e-6 relative, or 1e-6 of the peak rate near zero (optax
  evaluates in f32, the port in f64).
- losses and metrics: 1e-6 (f32 on both sides, other summation order).
- one optimizer update: 1e-6 (f32, the same formula; Adam's eps outside
  the sqrt on both sides).
- the whole slice (f32 model, 2 layers, d 64, two epochs of 3 steps):
  sgd histories 1e-5 and parameters 1e-5; Adam's first steps divide by
  sqrt(v) + eps with v near 0 for small gradients, which magnifies the
  frameworks' rounding differences, so Adam runs compare at 1e-4, and
  the attention key bias (whose exact gradient is zero) at Adam's step
  bound, lr x steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu.training import data as jdata
from cloud_tpu.training import schedules as jsched
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import (TransformerLM, params_from_flax,
                                    params_to_flax)
from cloud_tpu_torch.training import data as tdata
from cloud_tpu_torch.training import schedules as tsched
from cloud_tpu_torch.training import trainer as ttrainer

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=32)


@pytest.mark.parametrize("n", [1, 7, 1000, 70000])
def test_epoch_permutation_bit_equal_to_jax(n):
    for seed in (0, 1, 1234):
        for epoch in (0, 1, 3):
            np.testing.assert_array_equal(
                tdata.epoch_permutation(n, seed, epoch),
                np.asarray(jdata.epoch_permutation(n, seed, epoch)))


def test_permutation_round_count():
    """n = 70000 takes two sort rounds (ceil(3 ln n / ln(2^32 - 1)))."""
    key = tdata.fold_in(tdata.prng_key(5), 2)
    want = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(5), 2), 70000))
    np.testing.assert_array_equal(tdata.permutation(key, 70000), want)
    assert int(np.ceil(3 * np.log(70000) / np.log(2.0 ** 32 - 1))) == 2


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_array_dataset_batches_equal_jax(drop_remainder, weighted):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=23)
    kw = dict(batch_size=5, shuffle=True, seed=3,
              drop_remainder=drop_remainder)
    if weighted:
        kw["sample_weight"] = rng.random(23).astype(np.float32)
    jds = jdata.ArrayDataset(x, y, **kw)
    tds = tdata.ArrayDataset(x, y, **kw)
    assert tds.steps_per_epoch == jds.steps_per_epoch
    for _ in range(2):  # two epochs: the order changes, the tail wraps
        jb, tb = list(jds), list(tds)
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), v)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 100)),
    ("warmup_cosine", (1e-3, 60, 7, 1e-5)),
    ("warmup_linear", (5e-4, 80)),
    ("warmup_linear", (5e-4, 50, 10, 1e-4)),
    ("inverse_sqrt", (1e-3, 20)),
    ("constant", (2e-3,)),
])
def test_schedules_equal_optax(name, args):
    want = getattr(jsched, name)(*args)
    got = getattr(tsched, name)(*args)
    for step in range(101):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * args[0])


def _logits_labels(rng, shape=(6, 5), classes=7):
    logits = rng.normal(size=shape + (classes,)).astype(np.float32)
    labels = rng.integers(0, classes, size=shape)
    return logits, labels


@pytest.mark.parametrize("name", sorted(jtrainer.LOSSES))
def test_losses_equal_jax(name):
    rng = np.random.default_rng(1)
    logits, labels = _logits_labels(rng)
    if name == "categorical_crossentropy":
        labels = rng.dirichlet(np.ones(7), size=(6, 5)).astype(np.float32)
    elif name == "binary_crossentropy":
        labels = (rng.random(logits.shape) < 0.5).astype(np.float32)
    elif name in ("mse", "mean_squared_error"):
        labels = rng.normal(size=logits.shape).astype(np.float32)
    want = np.asarray(jtrainer.LOSSES[name](jnp.asarray(logits),
                                            jnp.asarray(labels)))
    got = ttrainer.LOSSES[name](torch.from_numpy(logits),
                                torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_label_smoothing_equals_jax():
    rng = np.random.default_rng(2)
    logits, labels = _logits_labels(rng)
    want = jtrainer.sparse_categorical_crossentropy(0.1)(
        jnp.asarray(logits), jnp.asarray(labels))
    got = ttrainer.sparse_categorical_crossentropy(0.1)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError, match="factory"):
        ttrainer.Trainer(torch.nn.Linear(2, 2),
                         loss=ttrainer.sparse_categorical_crossentropy)


@pytest.mark.parametrize("name", sorted(jtrainer.METRICS))
def test_metrics_equal_jax(name):
    rng = np.random.default_rng(3)
    outputs, labels = _logits_labels(rng, shape=(12,))
    if name in ("mae", "mean_absolute_error", "mse", "mean_squared_error"):
        labels = rng.normal(size=outputs.shape).astype(np.float32)
    want = np.asarray(jtrainer.METRICS[name](jnp.asarray(outputs),
                                             jnp.asarray(labels)))
    got = ttrainer.METRICS[name](torch.from_numpy(outputs),
                                 torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_one_update_equals_optax(name):
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    tx = jtrainer.OPTIMIZERS[name]()
    params = jnp.asarray(p0)
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrainer.OPTIMIZERS[name]([p])
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-6)


def test_schedule_through_make_optimizer_matches_jax():
    """A schedule as the learning rate (read at the update count, 0
    first) gives the optax run's parameters: sgd over warmup_cosine."""
    x, y = _data(6, 8)
    model = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                              attention_impl="flash", **CFG)
    jt = jtrainer.Trainer(model, metrics=(), seed=2, optimizer=optax.sgd(
        jsched.warmup_cosine(0.05, 4, warmup_steps=2), momentum=0.9))
    jt.build(x[:1])
    tm = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                       device="cpu", **CFG)
    tt = ttrainer.Trainer(tm, metrics=(), seed=2,
                          optimizer=ttrainer.make_optimizer(
                              "sgd", tsched.warmup_cosine(0.05, 4,
                                                          warmup_steps=2)))
    tt.build(variables=params_from_flax(jax.device_get(jt.state.params)))
    kw = dict(epochs=2, batch_size=4, verbose=False)
    np.testing.assert_allclose(tt.fit(x, y, **kw)["loss"],
                               jt.fit(x, y, **kw)["loss"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        params_to_flax(tm.state_dict(), 4)["lm_head"]["kernel"],
        np.asarray(jt.state.params["lm_head"]["kernel"]), rtol=1e-5,
        atol=1e-5)


def test_unported_options_raise():
    """Only the options still to port raise, each naming its ROADMAP
    item: the parallel axes (item 6). EMA, trainable and callbacks work
    since the training-loop slice (tests/test_torch_callbacks.py,
    test_torch_checkpoint.py); steps_per_execution, remat, warm starts,
    cache="device", input casts and the five optax optimizers since the
    image slice (tests/test_torch_trainer_options.py,
    test_torch_data_pipeline.py, test_torch_optimizers.py)."""
    model = torch.nn.Linear(2, 2)
    for kw, item in ((dict(zero1=True), 6), (dict(fsdp=True), 6),
                     (dict(mesh=object()), 6),
                     (dict(param_sharding_rules=()), 6)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.*item {}".format(item)):
            ttrainer.Trainer(model, **kw)
    for name in ("rmsprop", "adagrad", "adafactor", "lamb", "lion"):
        ttrainer.OPTIMIZERS[name]([torch.nn.Parameter(torch.zeros(1))])
    x = np.zeros((4, 2), np.float32)
    for ctor, kw in ((dict(steps_per_execution=2), {}),
                     (dict(remat=True), {}), ({}, dict(cache="device")),
                     ({}, dict(input_cast="uint8")),
                     ({}, dict(warm_start=True))):
        trainer = ttrainer.Trainer(torch.nn.Linear(2, 2), loss="mse",
                                   metrics=(), **ctor)
        history = trainer.fit(x, x, batch_size=2, verbose=False, **kw)
        assert trainer.state.step == 2 and len(history["loss"]) == 1


# -- the slice as a whole ----------------------------------------------


def _data(seed, n, seq=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], size=(n, seq + 1))
    return tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)


def _jax_trainer(optimizer):
    model = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                              attention_impl="flash", **CFG)
    return jtrainer.Trainer(model, optimizer=optimizer,
                            metrics=("accuracy",), seed=0)


def _port_trainer(optimizer, params):
    model = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                          device="cpu", **CFG)
    trainer = ttrainer.Trainer(model, optimizer=optimizer,
                               metrics=("accuracy",), seed=0)
    trainer.build(variables=params_from_flax(jax.device_get(params)))
    return trainer


@pytest.fixture(scope="module", params=["sgd", "adam"])
def slice_runs(request):
    """Both Trainers from the same parameters: fit(epochs=2, shuffle,
    steps_per_epoch=3), then evaluate and predict on held-out data whose
    tail batch is padded."""
    optimizer = request.param
    x, y = _data(0, 16)
    x_val, y_val = _data(1, 7)
    jt = _jax_trainer(optimizer)
    jt.build(x[:1])
    tt = _port_trainer(optimizer, jt.state.params)
    fit_kw = dict(epochs=2, batch_size=4, shuffle=True, steps_per_epoch=3,
                  verbose=False)
    runs = {}
    for name, trainer in (("jax", jt), ("port", tt)):
        history = trainer.fit(x, y, validation_data=(x_val, y_val),
                              **fit_kw)
        runs[name] = dict(
            history=history,
            eval=trainer.evaluate(x_val, y_val, batch_size=3,
                                  verbose=False),
            predict=np.asarray(trainer.predict(x_val, batch_size=3)))
    runs["jax"]["params"] = jax.device_get(jt.state.params)
    runs["port"]["params"] = params_to_flax(tt.model.state_dict(),
                                            CFG["num_heads"])
    runs["tol"] = 1e-5 if optimizer == "sgd" else 1e-4
    runs["adam"] = optimizer == "adam"
    runs["port_trainer"] = tt
    return runs


def test_slice_history_matches_jax(slice_runs):
    jh, th = slice_runs["jax"]["history"], slice_runs["port"]["history"]
    assert set(th) == set(jh)
    for key in jh:
        if key == "steps_per_sec":
            continue
        np.testing.assert_allclose(th[key], jh[key], rtol=slice_runs["tol"],
                                   atol=slice_runs["tol"], err_msg=key)
    assert th["loss"][1] < th["loss"][0]


def test_slice_parameters_match_jax(slice_runs):
    want = jax.tree_util.tree_leaves_with_path(slice_runs["jax"]["params"])
    got = slice_runs["port"]["params"]
    for path, leaf in want:
        node = got
        for entry in path:
            node = node[entry.key]
        tol = slice_runs["tol"]
        if slice_runs["adam"] and [e.key for e in path][-2:] == ["key",
                                                                   "bias"]:
            # The key bias's gradient is zero in exact arithmetic (it
            # shifts every logit of a row by the same q . b_k); Adam
            # scales the rounding noise to steps of up to lr, so the
            # two frameworks agree only to lr x steps = 1e-3 x 6.
            tol = 6e-3
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=tol,
                                   atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_slice_evaluate_and_predict_match_jax(slice_runs):
    je, te = slice_runs["jax"]["eval"], slice_runs["port"]["eval"]
    assert set(te) == set(je)
    for key in je:
        np.testing.assert_allclose(te[key], je[key], rtol=slice_runs["tol"],
                                   atol=slice_runs["tol"], err_msg=key)
    jp, tp = slice_runs["jax"]["predict"], slice_runs["port"]["predict"]
    assert tp.shape == jp.shape == (7, 16, CFG["vocab_size"])
    np.testing.assert_allclose(tp, jp, rtol=10 * slice_runs["tol"],
                               atol=10 * slice_runs["tol"])


def test_summary_counts_every_parameter(slice_runs):
    trainer = slice_runs["port_trainer"]
    text = trainer.summary(print_fn=lambda t: None)
    total = sum(p.numel() for p in trainer.model.parameters())
    jax_total = sum(int(np.prod(np.shape(l))) for l in
                    jax.tree_util.tree_leaves(slice_runs["jax"]["params"]))
    assert total == jax_total
    assert "{:,}".format(total) in text and "blocks.1" in text


def test_weighted_fit_and_accumulation_match_jax():
    """sample_weight with gradient accumulation over 2 steps (sgd)."""
    x, y = _data(2, 12)
    w = np.random.default_rng(5).random(12).astype(np.float32)
    model = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                              attention_impl="flash", **CFG)
    jt = jtrainer.Trainer(model, optimizer="sgd", metrics=("accuracy",),
                          seed=1, gradient_accumulation_steps=2)
    jt.build(x[:1])
    tm = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                       device="cpu", **CFG)
    tt = ttrainer.Trainer(tm, optimizer="sgd", metrics=("accuracy",),
                          seed=1, gradient_accumulation_steps=2)
    tt.build(variables=params_from_flax(jax.device_get(jt.state.params)))
    kw = dict(epochs=1, batch_size=3, sample_weight=w, verbose=False)
    jh = jt.fit(x, y, **kw)
    th = tt.fit(x, y, **kw)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        params_to_flax(tm.state_dict(), 4)["lm_head"]["kernel"],
        np.asarray(jt.state.params["lm_head"]["kernel"]), rtol=1e-5,
        atol=1e-5)
    assert tt.state.step == 4 and tt.state.updates == 2


def test_moe_fit_adds_the_aux_loss_as_jax_does():
    """A Switch-MoE TransformerLM (4 experts, capacity factor 1.25) from
    the same parameters: one epoch of sgd with accumulation over 2 steps,
    whose history's loss includes 0.01 x the blocks' aux losses, as in
    JAX (the aux divided with the rest of the loss), and `evaluate`,
    which adds none. f32; the same tolerance as the sgd slice."""
    x, y = _data(3, 12)
    cfg = dict(CFG, moe_experts=4)
    model = jtf.TransformerLM(compute_dtype=jnp.float32, norm_eps=1e-5,
                              **cfg)
    jt = jtrainer.Trainer(model, optimizer="sgd", metrics=("accuracy",),
                          seed=1, gradient_accumulation_steps=2)
    jt.build(x[:1])
    params = jax.device_get(jt.state.params)
    tm = TransformerLM(compute_dtype=torch.float32, norm_eps=1e-5,
                       device="cpu", **cfg)
    tt = ttrainer.Trainer(tm, optimizer="sgd", metrics=("accuracy",),
                          seed=1, gradient_accumulation_steps=2)
    tt.build(variables=params_from_flax(params))
    kw = dict(epochs=1, batch_size=3, verbose=False)
    jh, th = jt.fit(x, y, **kw), tt.fit(x, y, **kw)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, atol=1e-5)
    got = params_to_flax(tm.state_dict(), 4)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jt.state.params)):
        node = got
        for entry in path:
            node = node[entry.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-5,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    je = jt.evaluate(x[:5], y[:5], batch_size=3, verbose=False)
    te = tt.evaluate(x[:5], y[:5], batch_size=3, verbose=False)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5,
                               atol=1e-5)
    tm.eval()
    with torch.no_grad():
        logits = tm(torch.from_numpy(x[:3]).long())
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, CFG["vocab_size"]),
        torch.from_numpy(y[:3]).long().reshape(-1))
    np.testing.assert_allclose(
        tt.evaluate(x[:3], y[:3], batch_size=3, verbose=False)["loss"],
        ce.item(), rtol=1e-6)


def test_fit_fetches_once_per_epoch():
    from cloud_tpu_torch.parallel import runtime

    x, y = _data(3, 8)
    tm = TransformerLM(compute_dtype=torch.float32, device="cpu", **CFG)
    tt = ttrainer.Trainer(tm, optimizer="adamw", seed=0)
    runtime.reset_transfer_stats()
    history = tt.fit(x, y, epochs=3, batch_size=4, verbose=False)
    assert runtime.transfer_stats()["d2h_fetches"] == 3
    assert len(history["loss"]) == 3


def test_dropout_is_seeded_by_trainer_seed_and_step():
    x, y = _data(4, 8)

    def run(seed):
        tm = TransformerLM(compute_dtype=torch.float32, device="cpu",
                           dropout_rate=0.3, **CFG)
        tt = ttrainer.Trainer(tm, optimizer="sgd", seed=seed,
                              train_kwargs={"deterministic": False})
        return tt.fit(x, y, epochs=1, batch_size=4, verbose=False)["loss"]

    assert run(0) == run(0)
    assert run(0) != run(1)


#: JAX exports the port does not have yet, each with the ROADMAP §1 item
#: that brings it (every other public name of a JAX subpackage must be
#: in the ported subpackage).
_EXPORTS_TO_PORT = {
    "analysis": {n: "9" for n in (
        "Finding", "GraftlintError", "GraftsanError", "RULES", "Sanitizer",
        "check_paths", "check_source", "preflight_lint", "sanitize")},
    "models": dict(
        {n: "7a" for n in ("DeepseekLM", "DeepseekMoE", "MLAttention",
                           "TransformerEncoder",
                           "deepseek_tensor_parallel_rules",
                           "import_hf_deepseek")},
        **{n: "5b" for n in ("SpeculativeBatchError",
                             "SpeculativeShardingError", "generate_beam",
                             "generate_speculative")},
        **{n: "6" for n in ("PipelinedLM", "expert_parallel_rules",
                            "llama_tensor_parallel_rules",
                            "pipelined_lm_rules", "tensor_parallel_rules")}),
    "monitoring": {n: "8a" for n in (
        "STEP_TIME_BOUNDS", "STEP_TIME_HISTOGRAM", "TRAINING_EXAMPLES",
        "TRAINING_STEPS", "config_debug_string", "counter_increment",
        "export_count", "flush", "gauge_set", "histogram_observe",
        "native_available", "reset_for_testing", "set_description",
        "snapshot_json", "start_exporter", "stop_exporter")},
    "ops": {},
    "parallel": {n: "6" for n in (
        "SEQUENCE_PARALLEL_IMPLS", "compile_cache", "pipeline_apply",
        "ring_attention", "sequence_parallel_attention", "sharding",
        "sp_attention", "ulysses_attention", "ulysses_local")},
    "serving": {n: "5c" for n in (
        "LoadSpec", "PoolSqueezed", "PrefillFailed", "RequestTracer",
        "ServeFault", "ServeShed", "SlotEvicted", "SlotHang")},
    "training": {},
    "utils": {},
}


@pytest.mark.parametrize("sub", sorted(_EXPORTS_TO_PORT))
def test_ported_subpackage_exports_jax_names(sub):
    """Each ported subpackage exports the JAX subpackage's names: its
    `__all__`, or its public names other than submodules where it has
    none (which submodules a package shows depends on what the process
    imported before); the names still to
    port are listed above with their ROADMAP item, and each of those is
    still missing (an exemption goes when its name lands)."""
    import importlib
    import types

    jpkg = importlib.import_module("cloud_tpu." + sub)
    tpkg = importlib.import_module("cloud_tpu_torch." + sub)
    names = getattr(jpkg, "__all__", None)
    if names is None:
        names = [n for n in dir(jpkg) if not n.startswith("_")
                 and not isinstance(getattr(jpkg, n), types.ModuleType)]
    exempt = _EXPORTS_TO_PORT[sub]
    missing = {n for n in names if not hasattr(tpkg, n)}
    assert missing == set(exempt), (
        "missing beyond ROADMAP items: {}; exempted yet ported: {}".format(
            sorted(missing - set(exempt)), sorted(set(exempt) - missing)))
    assert all(item in ("5b", "5c", "6", "7a", "8a", "9")
               for item in exempt.values())
