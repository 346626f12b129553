"""The port's async host loop (`training/async_logs.py`) and the fit
loop's use of it, modelled on the JAX package's
`tests/unit/test_async_host_loop.py`: one coalesced device->host fetch
per epoch (counted by `runtime.transfer_stats()`), the same history
values with and without the background reader (bit for bit: the same
device reduction, fetched by another thread), errors re-raised at the
next submit, at `result()` and out of `fit`, and the `LazyLogs`
contract (reads resolve, writes do not; a callback's write wins over
the late resolution; keys a callback adds stay out of the history).
Port-only: no JAX runs here, so no tolerance is needed.
"""

import numpy as np
import pytest
import torch

from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.training import async_logs as async_logs_lib
from cloud_tpu_torch.training import callbacks as tcb
from cloud_tpu_torch.training import trainer as ttrainer
from cloud_tpu_torch.training.async_logs import (AsyncMetricReader, LazyLogs,
                                                 MetricFuture)


@pytest.fixture(autouse=True)
def _reset_counters():
    runtime.reset_transfer_stats()
    yield
    runtime.reset_transfer_stats()


def _data(n=64):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32))


def _trainer():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    return ttrainer.Trainer(model, optimizer="adam", seed=0)


@pytest.mark.parametrize("async_logging", [True, False])
def test_one_fetch_per_epoch(async_logging):
    x, y = _data()
    history = _trainer().fit(x, y, epochs=3, batch_size=16, verbose=False,
                             async_logging=async_logging)
    assert runtime.transfer_stats()["d2h_fetches"] == 3
    assert len(history["loss"]) == 3


def test_validation_adds_one_fetch_per_epoch():
    x, y = _data()
    _trainer().fit(x[:48], y[:48], epochs=2, batch_size=16, verbose=False,
                   validation_data=(x[48:], y[48:]))
    assert runtime.transfer_stats()["d2h_fetches"] == 4


def test_sync_and_async_histories_are_bit_equal():
    x, y = _data()
    runs = [_trainer().fit(x, y, epochs=2, batch_size=16, verbose=False,
                           async_logging=flag) for flag in (True, False)]
    for key in ("loss", "accuracy"):
        assert runs[0][key] == runs[1][key]
        assert all(type(v) is float for v in runs[0][key])


def test_future_blocks_raises_and_times_out():
    f = MetricFuture()
    assert not f.done()
    f.set_result({"loss": 1.0})
    assert f.done() and f.result() == {"loss": 1.0}
    g = MetricFuture()
    g.set_exception(RuntimeError("device lost"))
    with pytest.raises(RuntimeError, match="device lost"):
        g.result()
    with pytest.raises(TimeoutError):
        MetricFuture().result(timeout=0.01)


def test_reader_resolves_to_floats_and_drains_in_order():
    reader = AsyncMetricReader()
    try:
        futures = [reader.submit({"v": torch.tensor(float(i))})
                   for i in range(3)]
        reader.drain()
        assert [f.result()["v"] for f in futures] == [0.0, 1.0, 2.0]
        assert type(futures[0].result()["v"]) is float
    finally:
        reader.close()
    assert runtime.transfer_stats()["d2h_fetches"] == 3


def test_reader_error_reaches_result_and_next_submit(monkeypatch):
    def boom(tree):
        raise RuntimeError("fetch exploded")

    monkeypatch.setattr(async_logs_lib.runtime, "device_fetch", boom)
    reader = AsyncMetricReader()
    try:
        f = reader.submit({"loss": torch.tensor(1.0)})
        with pytest.raises(RuntimeError, match="fetch exploded"):
            f.result(timeout=10)
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="fetch exploded"):
            reader.submit({"loss": torch.tensor(1.0)})
        # The boundary raise cleared the pending error.
        assert reader.submit({"loss": torch.tensor(1.0)}).result(
            timeout=10) == {"loss": 1.0}
    finally:
        reader.close()


def test_fetch_error_propagates_out_of_fit(monkeypatch):
    def boom(tree):
        raise RuntimeError("fetch exploded")

    x, y = _data()
    trainer = _trainer()
    monkeypatch.setattr(runtime, "device_fetch", boom)
    with pytest.raises(RuntimeError, match="fetch exploded"):
        trainer.fit(x, y, epochs=2, batch_size=16, verbose=False)


def _pending(values, host=None):
    f = MetricFuture()
    f.set_result(values)
    return LazyLogs(f, device_keys=tuple(values), host_items=host or {})


def test_lazy_logs_reads_resolve_and_writes_do_not():
    logs = LazyLogs(MetricFuture(), device_keys=("loss",),
                    host_items={"steps_per_sec": 10.0})   # never resolved
    assert logs["steps_per_sec"] == 10.0
    assert "loss" in logs and len(logs) == 2
    assert "pending" in repr(logs)
    logs["lr"] = 0.1                    # a write never waits
    logs = _pending({"loss": 1.5, "accuracy": 0.5})
    assert logs["loss"] == 1.5 and logs.get("accuracy") == 0.5
    assert dict(logs.items()) == {"loss": 1.5, "accuracy": 0.5}
    with pytest.raises(KeyError):
        logs["nope"]
    assert logs.get("nope", "dflt") == "dflt"


def test_callback_write_wins_over_resolution():
    logs = _pending({"loss": 1.5})
    logs["loss"] = 99.0
    assert logs["loss"] == 99.0 and dict(logs.items())["loss"] == 99.0


def test_callback_added_keys_stay_out_of_history_and_chain():
    """A callback's write reaches later callbacks (EarlyStopping sees
    it), but the history keeps what the epoch produced."""
    class Adds(tcb.Callback):
        def on_epoch_end(self, epoch, logs):
            logs["fake"] = 123.0
            logs["loss"] = 5.0 + epoch     # rising: EarlyStopping fires

    x, y = _data()
    trainer = _trainer()
    stop = tcb.EarlyStopping(monitor="loss", patience=0)
    history = trainer.fit(x, y, epochs=5, batch_size=16, verbose=False,
                          callbacks=(Adds(), stop))
    assert "fake" not in history
    assert len(history["loss"]) == 2 and history["loss"][0] < 5.0
    assert stop.best == 5.0
