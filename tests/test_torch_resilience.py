"""The port's resilient fit (`training/resilience.py`) and fault injector
(`analysis/chaos.py`), modelled on the JAX package's
`tests/unit/test_resilience.py`: a `preempt@12` run resumed under
`fit(resume="auto")` against JAX's uninterrupted run of the same model,
parameters and data, and bit for bit against the port's own
uninterrupted run (also mid-accumulation, and after a transient data
stall); the answer to each typed fault (rescue save, quarantine and
fallback, a fresh data order after NaNLoss, capped backoff, budget
exhaustion); the backoff schedule equal to JAX's for one seed; the chaos
grammar.

Tolerances, with their reasons: against JAX 1e-5 (f32 `TransformerLM`,
sgd, as the slice tests of `test_torch_training.py`); within the port,
bit-equality (a resume restores every bit of the train state and the
data position, and the CPU's kernels are deterministic). Retries back
off by 0 s (CLOUD_TPU_RETRY_BACKOFF=0), and no chaos plan outlives a
test.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jtf
from cloud_tpu.training import resilience as jres
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.analysis import chaos
from cloud_tpu_torch.models import (TransformerLM, params_from_flax,
                                    params_to_flax)
from cloud_tpu_torch.training import callbacks as tcb
from cloud_tpu_torch.training import checkpoint as ckpt
from cloud_tpu_torch.training import resilience
from cloud_tpu_torch.training import trainer as ttrainer
from cloud_tpu_torch.utils import events

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=32)
EPOCHS, BATCH = 3, 8   # 8 steps an epoch over 64 examples, 24 in all


@pytest.fixture(autouse=True)
def _guard_isolation(monkeypatch):
    for key in ("CLOUD_TPU_CHAOS", "CLOUD_TPU_RETRIES",
                "CLOUD_TPU_RESUME_DIR", "CLOUD_TPU_EVENT_LOG"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("CLOUD_TPU_RETRY_BACKOFF", "0")
    chaos.uninstall()
    resilience.reset_guard_stats()
    yield
    chaos.uninstall()
    resilience.reset_guard_stats()


def _data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], size=(64, 17))
    return tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)


@pytest.fixture(scope="module")
def start_params():
    model = jtf.TransformerLM(compute_dtype=jnp.float32, **CFG)
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 16), jnp.int32))["params"])


def _trainer(params, **kw):
    model = TransformerLM(compute_dtype=torch.float32, device="cpu", **CFG)
    trainer = ttrainer.Trainer(model, optimizer="sgd", seed=3, **kw)
    trainer.build(variables=params_from_flax(params))
    return trainer


def _fit(trainer, **kw):
    x, y = _data()
    return trainer.fit(x, y, epochs=EPOCHS, batch_size=BATCH, verbose=False,
                       **kw)


def _fit_chaotic(params, spec, tmp_path, retries=3, trainer_kw=None, **kw):
    chaos.install(spec)
    trainer = _trainer(params, **(trainer_kw or {}))
    history = _fit(trainer, resume="auto", retries=retries,
                   resume_from=str(tmp_path / "ckpt"), **kw)
    return trainer, history


def _states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def clean(start_params):
    """The port's uninterrupted fit and JAX's, from the same
    parameters."""
    port = _trainer(start_params)
    port_history = _fit(port)
    jt = jtrainer.Trainer(jtf.TransformerLM(compute_dtype=jnp.float32, **CFG),
                          optimizer="sgd", seed=3)
    jt.build(np.zeros((1, 16), np.int32), variables={"params": start_params})
    jax_history = _fit(jt)
    return dict(port=port, port_history=port_history,
                jax_params=jax.device_get(jt.state.params),
                jax_history=jax_history)


def test_preemption_resumes_to_jax_and_to_the_uninterrupted_run(
        clean, start_params, tmp_path):
    chaotic, history = _fit_chaotic(start_params, "preempt@12", tmp_path)
    assert chaotic.state.step == EPOCHS * 8
    # Bit for bit the port's own uninterrupted run.
    assert _states_equal(chaotic, clean["port"])
    assert history["loss"][-1] == clean["port_history"]["loss"][-1]
    # Epoch 1 resumed at its batch 4, so its entry is the mean of 4
    # steps; epochs 0 and 2 are whole, and equal JAX's.
    for epoch in (0, 2):
        np.testing.assert_allclose(history["loss"][epoch],
                                   clean["jax_history"]["loss"][epoch],
                                   rtol=1e-5, atol=1e-5)
    got = params_to_flax(chaotic.model.state_dict(), CFG["num_heads"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            clean["jax_params"]):
        node = got
        for entry in path:
            node = node[entry.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-5,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    stats = resilience.guard_stats()
    assert (stats["faults"], stats["retries"], stats["resumes"]) == (1, 1, 1)
    assert stats["last_fault"] == "preemption"
    assert stats["last_resume_latency_seconds"] > 0
    assert stats["last_resume_new_compiles"] == 0
    # The rescue save at 12 carries the mid-epoch position.
    meta = ckpt.load_metadata(str(tmp_path / "ckpt"), 12)
    assert meta["data_state"] == {"epoch": 1, "step_in_epoch": 4,
                                  "dataset_epoch": 2, "data_seed": 3}


@pytest.mark.parametrize("spec", ["preempt@13", "fetch@9"])
def test_resume_is_bit_exact_mid_accumulation_and_after_a_stall(
        start_params, spec, tmp_path):
    """preempt@13 lands between the two micro-steps of an accumulation
    window (the half-built gradient rides the checkpoint); a data stall
    re-enters at the same position."""
    clean = _trainer(start_params, gradient_accumulation_steps=2,
                     ema_decay=0.9)
    _fit(clean)
    chaotic, _ = _fit_chaotic(
        start_params, spec, tmp_path,
        trainer_kw=dict(gradient_accumulation_steps=2, ema_decay=0.9))
    assert chaotic.state.step == clean.state.step == 24
    assert chaotic.state.updates == 12
    assert _states_equal(chaotic, clean)
    for name, value in clean.ema_params.items():
        assert torch.equal(chaotic.ema_params[name], value), name


def test_nan_rolls_back_with_a_fresh_data_order(start_params, tmp_path):
    chaotic, _ = _fit_chaotic(start_params, "nan@12", tmp_path)
    assert chaotic.state.step == EPOCHS * 8
    stats = resilience.guard_stats()
    assert stats["rollbacks"] == 1 and stats["last_fault"] == "nan_loss"
    # No rescue save of the non-finite state: back to the epoch-0
    # checkpoint, then epoch 1 from its start under the new seed.
    assert not os.path.exists(tmp_path / "ckpt" / "12")
    meta = ckpt.load_metadata(str(tmp_path / "ckpt"), 24)
    assert meta["data_state"]["data_seed"] == 3 + 1000003


def test_corrupt_rescue_falls_back_and_completes(start_params, tmp_path,
                                                 monkeypatch):
    """preempt@20 forces a rescue save at 20 and corrupt@18 tears it;
    attempt 2 hits CheckpointCorrupt, quarantines step 20, falls back
    to the epoch-2 checkpoint at 16 and finishes."""
    log = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("CLOUD_TPU_EVENT_LOG", log)
    chaotic, _ = _fit_chaotic(start_params, "preempt@20,corrupt@18",
                              tmp_path)
    assert chaotic.state.step == EPOCHS * 8
    stats = resilience.guard_stats()
    assert stats["faults"] == 2 and stats["rollbacks"] == 1
    assert [n for n in os.listdir(tmp_path / "ckpt")
            if n.endswith(".corrupt")] == ["20.corrupt"]
    guard = events.read_job_events(log, kind="graftguard")
    assert [r["payload"]["event"] for r in guard] == [
        "fault", "rescue_checkpoint", "retry", "fault", "rollback", "retry",
        "resumed"]
    assert {r["payload"]["fault"] for r in guard
            if r["payload"]["event"] == "fault"} == {"preemption",
                                                     "checkpoint_corrupt"}
    assert len(events.read_job_events(log, kind="graftchaos")) == 2


def test_budget_exhaustion_reraises_the_typed_fault(start_params, tmp_path):
    chaos.install("preempt@4,preempt@8")
    with pytest.raises(resilience.Preemption):
        _fit(_trainer(start_params), resume="auto", retries=1,
             resume_from=str(tmp_path / "ckpt"))
    stats = resilience.guard_stats()
    assert stats["giveups"] == 1
    assert stats["faults"] == 2 and stats["retries"] == 1


def test_unguarded_fit_propagates_and_retries_need_auto(start_params):
    chaos.install("preempt@4")
    with pytest.raises(resilience.Preemption):
        _fit(_trainer(start_params))
    with pytest.raises(ValueError, match="resume='auto'"):
        _fit(_trainer(start_params), retries=2)
    with pytest.raises(ValueError, match="resume must be"):
        _fit(_trainer(start_params), resume="always")


def test_auto_checkpoint_stamps_the_data_position(start_params, tmp_path):
    trainer = _trainer(start_params)
    x, y = _data()
    trainer.fit(x, y, epochs=2, batch_size=8, verbose=False,
                callbacks=[resilience.AutoCheckpoint(str(tmp_path))])
    assert ckpt.latest_step(str(tmp_path)) == 16
    state = ckpt.load_metadata(str(tmp_path), 16)["data_state"]
    # The end of epoch 1 normalises to the start of epoch 2.
    assert state == {"epoch": 2, "step_in_epoch": 0, "dataset_epoch": 3,
                     "data_seed": 3}
    assert os.path.isdir(tmp_path / "8")   # earlier steps are kept


def test_backoff_schedule_equals_jax():
    for seed in (0, 7):
        rng_port, rng_jax = random.Random(seed), random.Random(seed)
        port = [resilience.backoff_delay(k, base=0.5, cap=20.0, rng=rng_port)
                for k in range(8)]
        want = [jres.backoff_delay(k, base=0.5, cap=20.0, rng=rng_jax)
                for k in range(8)]
        assert port == want
    rng = random.Random(3)
    for attempt in (0, 3, 64, 10 ** 6):
        raw = min(30.0, 2.0 ** min(attempt, 64))
        assert 0.5 * raw <= resilience.backoff_delay(attempt,
                                                     rng=rng) < raw


def test_fault_taxonomy_and_guard_scope():
    kinds = {cls: cls.fault_kind for cls in (
        resilience.Preemption, resilience.CheckpointCorrupt,
        resilience.DataStall, resilience.NaNLoss)}
    assert kinds == {jcls_port: getattr(jres, jcls_port.__name__).fault_kind
                     for jcls_port in kinds}
    assert resilience.fault_kind(ValueError()) == "unknown"
    fault = resilience.NaNLoss("x", epoch=4, monitor="loss", value=1.0)
    assert isinstance(fault, resilience.FAULT_TYPES)
    assert (fault.epoch, fault.monitor) == (4, "loss")
    with resilience.guard_scope() as scope:
        resilience._stats["faults"] += 2
    assert scope.stats()["faults"] == 2 and scope.stats()["resumes"] == 0


def test_terminate_on_nan_rollback_raises_nan_loss():
    cb = tcb.TerminateOnNaN(rollback=True)
    with pytest.raises(resilience.NaNLoss) as info:
        cb.on_epoch_end(4, {"loss": float("nan")})
    assert info.value.epoch == 4 and info.value.monitor == "loss"
    cb.on_epoch_end(0, {"loss": 0.5})


def test_chaos_grammar(monkeypatch):
    events_ = chaos.parse_spec("preempt@3, corrupt@9,slot_evict@2:4")
    assert [(e.kind, e.step, e.arg) for e in events_] == [
        ("preempt", 3, None), ("corrupt", 9, None), ("slot_evict", 2, 4.0)]
    for bad in ("explode@3", "preempt", "preempt@x"):
        with pytest.raises(ValueError):
            chaos.parse_spec(bad)
    with pytest.raises(NotImplementedError, match="item 8"):
        chaos.parse_spec("hang@12:30")
    plan = chaos.ChaosPlan.parse("fetch@2,nan@5,slot_hang@1")
    plan.pre_dispatch(0, 2)          # covers steps 0 and 1: nothing due
    with pytest.raises(resilience.DataStall):
        plan.pre_dispatch(2)
    plan.pre_dispatch(2)             # one-shot
    assert [e["kind"] for e in plan.remaining()] == ["nan", "slot_hang"]
    monkeypatch.setenv("CLOUD_TPU_CHAOS", "preempt@7")
    assert chaos.active_plan().events[0].step == 7
    chaos.uninstall()
