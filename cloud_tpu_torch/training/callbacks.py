"""Training callbacks: checkpointing, early stopping, metric streaming.

The port of `cloud_tpu/training/callbacks.py`, with the same hook names
and order of calls: `set_trainer`, then `on_train_begin()`; per epoch
`on_epoch_begin(epoch)` and `on_epoch_end(epoch, logs)`; at the end
`on_train_end(history)`, which `Trainer.fit` calls for every callback
on every exit path (one failing teardown does not skip the others).
Per-trial metrics stream over a JSONL channel (`MetricsLogger`,
`read_metrics_log`); `TensorBoard` writes real event files through the
port's own `utils.events`.
"""

import json
import logging
import math
import signal as signal_lib

from cloud_tpu_torch.parallel import runtime

logger = logging.getLogger("cloud_tpu_torch")


class Callback:
    """Base callback (Keras-parity hook names)."""

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, logs):
        pass

    def on_train_end(self, history):
        pass


class LambdaCallback(Callback):
    """Ad-hoc hooks from callables (Keras parity)."""

    def __init__(self, on_train_begin=None, on_epoch_begin=None,
                 on_epoch_end=None, on_train_end=None):
        self._on_train_begin = on_train_begin
        self._on_epoch_begin = on_epoch_begin
        self._on_epoch_end = on_epoch_end
        self._on_train_end = on_train_end

    def on_train_begin(self):
        if self._on_train_begin:
            self._on_train_begin()

    def on_epoch_begin(self, epoch):
        if self._on_epoch_begin:
            self._on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs):
        if self._on_epoch_end:
            self._on_epoch_end(epoch, logs)

    def on_train_end(self, history):
        if self._on_train_end:
            self._on_train_end(history)


def _resolve_mode(mode, monitor):
    """"auto" infers the direction from the metric's name, as the JAX
    package's tuner does: accuracy-like ("acc", "...auc") is "max", the
    rest "min"."""
    if mode == "auto":
        return "max" if ("acc" in monitor or monitor.endswith("auc")) \
            else "min"
    return mode


def _improved(value, best, mode, min_delta=0.0):
    """Shared monitored-metric comparison for EarlyStopping and
    ModelCheckpoint."""
    if best is None:
        return True
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


class EarlyStopping(Callback):
    """Stops training when a monitored metric stops improving.

    restore_best_weights: keep a copy of the model's state dict
    (parameters and buffers, on their device) from the best epoch and
    load it back when training ends (stopped early or not, once a best
    epoch was recorded). Costs one extra copy of those tensors while
    training runs. The optimizer state is left as it is, as in Keras
    and the JAX package.
    """

    def __init__(self, monitor="val_loss", patience=0, min_delta=0.0,
                 mode="auto", restore_best_weights=False):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = _resolve_mode(mode, monitor)
        self.restore_best_weights = bool(restore_best_weights)
        self.best = None
        self.wait = 0
        self._best_state = None

    def _improved(self, value):
        return _improved(value, self.best, self.mode, self.min_delta)

    def on_train_begin(self):
        self.best = None
        self.wait = 0
        self._best_state = None

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            if self.restore_best_weights:
                # A real copy: the optimizer updates the live tensors in
                # place.
                self._best_state = {
                    k: v.detach().clone()
                    for k, v in self.trainer.model.state_dict().items()}
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.trainer.stop_training = True

    def on_train_end(self, history):
        if self.restore_best_weights and self._best_state is not None:
            self.trainer.model.load_state_dict(self._best_state)
            self._best_state = None


class TerminateOnNaN(Callback):
    """Stops training when the epoch loss goes non-finite (Keras
    `TerminateOnNaN` parity, at epoch granularity: a per-step check
    would read the device every step).

    Under `fit(async_logging=True)` reading `logs["loss"]` here resolves
    the epoch's one coalesced background fetch.

    rollback=True raises the typed `resilience.NaNLoss` instead: under
    `fit(resume="auto")` the run rolls back to the last finite
    checkpoint and resumes with a fresh data order; outside it the fault
    propagates to the caller.
    """

    def __init__(self, monitor="loss", rollback=False):
        self.monitor = monitor
        self.rollback = bool(rollback)

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None or math.isfinite(float(value)):
            return
        if self.rollback:
            from cloud_tpu_torch.training import resilience

            logger.warning("epoch %d: %s is %r — raising NaNLoss for "
                           "rollback.", epoch, self.monitor, value)
            raise resilience.NaNLoss(
                "epoch {}: {} is {!r}".format(epoch, self.monitor, value),
                epoch=epoch, monitor=self.monitor, value=float(value))
        logger.warning("epoch %d: %s is %r — terminating training.",
                       epoch, self.monitor, value)
        self.trainer.stop_training = True


class ModelCheckpoint(Callback):
    """Saves the full train state each epoch under `<filepath>/<step>`
    (`training.checkpoint.save`), or, with `monitor`, each epoch that
    improves it.

    use_async: the epoch's save snapshots the state to host memory and
    writes on a background thread, so the next epoch trains during the
    I/O; on_train_end blocks until the last write commits.
    """

    def __init__(self, filepath, monitor=None, mode="auto", min_delta=0.0,
                 save_freq="epoch", use_async=False):
        self.filepath = filepath
        self.monitor = monitor
        self.mode = _resolve_mode(mode, monitor or "loss")
        self.min_delta = abs(min_delta)
        if save_freq != "epoch":
            raise ValueError("Only save_freq='epoch' is supported.")
        self.use_async = bool(use_async)
        self.best = None

    def on_epoch_end(self, epoch, logs):
        from cloud_tpu_torch.training import checkpoint as checkpoint_lib

        if self.monitor is not None:
            value = logs.get(self.monitor)
            if value is None:
                return
            if not _improved(value, self.best, self.mode, self.min_delta):
                return
            self.best = value
        checkpoint_lib.save(self.filepath, self.trainer.state,
                            step=int(self.trainer.state.step),
                            use_async=self.use_async)

    def on_train_end(self, history):
        if self.use_async:
            from cloud_tpu_torch.training import checkpoint as checkpoint_lib

            checkpoint_lib.wait_until_finished()


class PreemptionCheckpoint(Callback):
    """Checkpoints and stops cleanly on a preemption signal (SIGTERM by
    default):

        trainer.fit(..., callbacks=(PreemptionCheckpoint(ckpt_dir),),
                    resume_from=ckpt_dir)

    The signal calls `Trainer.request_stop()` (a host flag read at the
    next step boundary), the partial epoch closes through the normal
    epoch end, the state is saved here and fit() returns; the restart
    picks the checkpoint up through `resume_from=`. A previous callable
    handler is chained, and every handler this callback replaced is put
    back at train end.
    """

    def __init__(self, filepath, signals=None):
        self.filepath = filepath
        self.signals = (tuple(signals) if signals is not None
                        else (signal_lib.SIGTERM,))
        self._old_handlers = {}
        self.preempted = False
        self._saved_step = None

    def on_train_begin(self):
        self.preempted = False
        self._saved_step = None
        self._old_handlers = {}

        def handler(signum, frame):
            self.preempted = True
            self.trainer.request_stop()
            # Chain a previous callable handler, but not
            # default_int_handler, whose "chain" is a KeyboardInterrupt
            # mid-step, the abrupt unwind this callback replaces.
            old = self._old_handlers.get(signum)
            if callable(old) and old is not signal_lib.default_int_handler:
                old(signum, frame)

        for sig in self.signals:
            try:
                self._old_handlers[sig] = signal_lib.signal(sig, handler)
            except (ValueError, OSError):
                # Not the main thread: no signal handling there;
                # request_stop() can still be called directly.
                self._old_handlers.pop(sig, None)

    def _save(self):
        from cloud_tpu_torch.training import checkpoint as checkpoint_lib

        step = int(self.trainer.state.step)
        checkpoint_lib.save(self.filepath, self.trainer.state, step=step)
        self._saved_step = step

    def on_epoch_end(self, epoch, logs):
        if self.preempted:
            self._save()

    def on_train_end(self, history):
        # The signal can land after the last on_epoch_end (or in an
        # aborted epoch of zero steps, which has no epoch end): a
        # preemption never exits without a checkpoint at the current
        # step.
        if (self.preempted and self.trainer.state is not None
                and self._saved_step != int(self.trainer.state.step)):
            self._save()
        for sig, old in self._old_handlers.items():
            try:
                signal_lib.signal(sig, old)
            except (ValueError, OSError, TypeError):
                pass
        self._old_handlers = {}


class MetricsLogger(Callback):
    """Streams per-epoch logs to a JSONL file, one record per epoch
    (`{"epoch": e, <log>: float, ...}`); local and gs:// paths. Only
    process 0 writes."""

    def __init__(self, path):
        self.path = path

    def on_train_begin(self):
        from cloud_tpu_torch.utils import storage

        if runtime.process_index() != 0:
            return
        storage.write_bytes(self.path, b"")  # truncate a previous run's

    def on_epoch_end(self, epoch, logs):
        from cloud_tpu_torch.utils import storage

        if runtime.process_index() != 0:
            return
        record = {"epoch": epoch}
        record.update({k: float(v) for k, v in logs.items()})
        storage.append_bytes(self.path,
                             (json.dumps(record) + "\n").encode("utf-8"))


class TensorBoard(Callback):
    """Writes per-epoch scalars (`epoch_<log>`) as TensorBoard event
    files under `log_dir`, hand-encoded by `utils.events` (no
    TensorFlow). Only process 0 writes."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self._writer = None

    def on_train_begin(self):
        from cloud_tpu_torch.utils import events

        if runtime.process_index() != 0:
            return
        self._writer = events.EventFileWriter(self.log_dir)

    def on_epoch_end(self, epoch, logs):
        if self._writer is None:
            return
        self._writer.add_scalars(
            epoch, {"epoch_" + k: float(v) for k, v in logs.items()})
        self._writer.flush()

    def on_train_end(self, history):
        if self._writer is not None:
            self._writer.close()


def read_metrics_log(path):
    """Parses a MetricsLogger JSONL stream into a list of epoch
    records."""
    from cloud_tpu_torch.utils import storage

    records = []
    for line in storage.read_bytes(path).decode("utf-8").splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


__all__ = ["Callback", "EarlyStopping", "LambdaCallback", "MetricsLogger",
           "ModelCheckpoint", "PreemptionCheckpoint", "TensorBoard",
           "TerminateOnNaN", "read_metrics_log"]
