"""Trainer: a `model.fit`-style training loop; the port of
`cloud_tpu/training/trainer.py` on one device.

The Trainer runs where the model's parameters live (the port's models
default to the CUDA card; build one with `device="cpu"` to train on the
CPU). Each step is the JAX step's body in eager PyTorch: forward, the
loss mean (weighted Keras semantics under `sample_weight`) plus
`aux_loss_weight` times the aux losses the forward left in the model's
`aux_losses` (the MoE load-balancing losses, JAX's sown "losses"),
backward, one optimizer update (every k-th step under gradient
accumulation, as `optax.MultiSteps`), the EMA shadow after an applied
update (`ema_decay=`), and the step's metrics, which stay on the
device. Each epoch's metrics are reduced on the device and fetched once
through `runtime.device_fetch`, on a background thread by default
(`training.async_logs`).

Around the loop, as in JAX: callbacks (`training.callbacks`), full
train-state checkpoints (`save_checkpoint`, `restore_checkpoint`,
`fit(resume_from=)`, `training.checkpoint`) with an exact mid-epoch
resume, `fit(resume="auto")` (`training.resilience`) and frozen
parameters (`trainable=`).

Example:
    model = TransformerLM(..., device="cuda")
    trainer = Trainer(model, optimizer="adamw", metrics=("accuracy",))
    history = trainer.fit(x_train, y_train, epochs=2, batch_size=8,
                          callbacks=[MetricsLogger("run/metrics.jsonl")],
                          resume="auto", resume_from="run/ckpt")

Not ported yet (they raise NotImplementedError naming their ROADMAP
item): meshes and sharding rules, ZeRO/FSDP, remat,
steps_per_execution > 1, device-resident data, input casts, warm
starts, and the optimizers other than adam, adamw and sgd.
"""

import contextlib
import inspect
import itertools
import logging
import os
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.training import async_logs as async_logs_lib
from cloud_tpu_torch.training import data as data_lib

logger = logging.getLogger("cloud_tpu_torch")

_NOT_PORTED = "is not ported yet (ROADMAP §1: Modules to port, item"


# -- Losses (outputs-in, per-example-loss-out) ---------------------------

def _sparse_categorical_crossentropy(logits, labels):
    classes = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, classes).float(),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _categorical_crossentropy(logits, labels):
    return -(labels * torch.log_softmax(logits.float(), dim=-1)).sum(-1)


def _binary_crossentropy(logits, labels):
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float(),
                                              reduction="none")


def _mse(preds, targets):
    return torch.square(preds - targets).mean(
        dim=tuple(range(1, preds.ndim)))


def sparse_categorical_crossentropy(label_smoothing=0.0):
    """Loss factory: integer-label softmax CE with label smoothing
    (the one-hot target mixed with the uniform distribution)."""
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError("label_smoothing must be in [0, 1); got "
                         "{}.".format(label_smoothing))
    if not label_smoothing:
        return _sparse_categorical_crossentropy

    def loss(logits, labels):
        classes = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, classes).float(),
                               labels.reshape(-1).long(), reduction="none",
                               label_smoothing=label_smoothing).reshape(
                                   labels.shape)

    return loss


LOSSES = {
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "categorical_crossentropy": _categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mse": _mse,
    "mean_squared_error": _mse,
}


# -- Metrics (per-example values) ----------------------------------------

def _accuracy(outputs, labels):
    preds = outputs.argmax(dim=-1)
    if labels.ndim == preds.ndim + 1:  # one-hot
        labels = labels.argmax(dim=-1)
    return (preds == labels).float()


def _top5_accuracy(outputs, labels):
    k = min(5, outputs.shape[-1])
    topk = outputs.topk(k, dim=-1).indices
    return (topk == labels[..., None]).any(dim=-1).float()


def _mae_metric(outputs, labels):
    return (outputs - labels).abs().reshape(outputs.shape[0], -1).mean(1)


def _mse_metric(outputs, labels):
    return torch.square(outputs - labels).reshape(outputs.shape[0],
                                                  -1).mean(1)


METRICS = {
    "accuracy": _accuracy,
    "top5_accuracy": _top5_accuracy,
    "mae": _mae_metric,
    "mean_absolute_error": _mae_metric,
    "mse": _mse_metric,
    "mean_squared_error": _mse_metric,
}


# -- Optimizers, at optax's defaults -------------------------------------

def _lr(learning_rate, default):
    lr = default if learning_rate is None else learning_rate
    return lr(0) if callable(lr) else float(lr)


def _adam(params, learning_rate=None):
    return torch.optim.Adam(params, lr=_lr(learning_rate, 1e-3),
                            betas=(0.9, 0.999), eps=1e-8)


def _adamw(params, learning_rate=None):
    # optax.adamw's weight decay is 1e-4 (torch's default is 1e-2).
    return torch.optim.AdamW(params, lr=_lr(learning_rate, 1e-3),
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _sgd(params, learning_rate=None):
    # optax.sgd(momentum=0.9): trace t = g + 0.9 t, no dampening, no
    # Nesterov.
    return torch.optim.SGD(params, lr=_lr(learning_rate, 1e-2),
                           momentum=0.9, dampening=0.0, nesterov=False)


def _not_ported(name, reason):
    def make(params, learning_rate=None):
        raise NotImplementedError(
            "optimizer {!r} {} 4; {}).".format(name, _NOT_PORTED, reason))
    return make


OPTIMIZERS = {
    "adam": _adam,
    "adamw": _adamw,
    "sgd": _sgd,
    "rmsprop": _not_ported("rmsprop", "optax puts eps inside the sqrt "
                           "and decays 0.9; torch.optim.RMSprop does not"),
    "adagrad": _not_ported("adagrad", "optax starts the accumulator at "
                           "0.1; torch.optim.Adagrad at 0"),
    "adafactor": _not_ported("adafactor", "no torch.optim counterpart"),
    "lamb": _not_ported("lamb", "no torch.optim counterpart"),
    "lion": _not_ported("lion", "no torch.optim counterpart"),
}


def make_optimizer(name, learning_rate=None):
    """An optimizer spec for `Trainer(optimizer=...)`: `name` in
    OPTIMIZERS with a float learning rate or a schedule (step -> lr,
    read at the update count, 0 for the first update, as optax reads
    it)."""
    factory = OPTIMIZERS[name]

    def make(params):
        opt = factory(params, learning_rate)
        if callable(learning_rate):
            opt.lr_schedule = learning_rate
        return opt

    return make


def _per_example_view(v, batch_dim):
    """Collapses any non-batch dims (e.g. per-token losses) to one value
    per example."""
    if v.ndim > 1:
        return v.reshape(batch_dim, -1).mean(dim=1)
    return v


def _weighted_mean(v, weights):
    """sum(v * w) / sum(w), 0 (not nan) on all-zero weights."""
    return (v * weights).sum() / torch.clamp(weights.sum(), min=1e-9)


def _accepts(fn, name):
    """Whether `fn` takes a parameter `name` (a metric's opt-in
    `mask=`, a model's `generator=`)."""
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


class TrainState:
    """The train state: the step counter (train steps taken, micro-steps
    included), the model (its parameters and buffers), the optimizer
    (its state; `updates` counts the updates it applied, the schedule's
    count), the EMA shadow (`ema`, name -> tensor, or None) and the
    gradient-accumulation buffers (the trainable parameters' `.grad`
    between updates). `state_dict()` is the whole of it as a tree of
    tensors and plain values, what `training.checkpoint.save` writes;
    `load_state_dict` takes one back in place."""

    def __init__(self, step, model, optimizer, updates=0, ema=None,
                 accumulation_steps=1):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.updates = updates
        self.ema = ema
        self.accumulation_steps = accumulation_steps

    def _optimizer_names(self):
        """The parameter names in the optimizer's order: torch.optim keys
        its state by that index, so a checkpoint carries the map."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for group in self.optimizer.param_groups
                for p in group["params"]]

    def state_dict(self):
        grads = {n: p.grad for n, p in self.model.named_parameters()
                 if p.grad is not None}
        return {"step": int(self.step), "updates": int(self.updates),
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "optimizer_params": self._optimizer_names(),
                "ema": self.ema,
                "accumulation": {
                    "micro_steps": int(self.step) % self.accumulation_steps,
                    "grads": grads}}

    def load_state_dict(self, tree):
        names = self._optimizer_names()
        if tree["optimizer_params"] != names:
            raise ValueError(
                "checkpoint's optimizer covers parameters {} but this "
                "Trainer's covers {} (another model, or another "
                "trainable=?).".format(tree["optimizer_params"][:4],
                                       names[:4]))
        micro = int(tree["step"]) % self.accumulation_steps
        if tree["accumulation"]["micro_steps"] != micro:
            raise ValueError(
                "checkpoint was written {} micro-steps into an "
                "accumulation window; at gradient_accumulation_steps={} "
                "its step {} is {} into one.".format(
                    tree["accumulation"]["micro_steps"],
                    self.accumulation_steps, tree["step"], micro))
        if (tree["ema"] is None) != (self.ema is None):
            raise ValueError("checkpoint {} an EMA shadow; this Trainer "
                             "{}.".format(
                                 "has" if tree["ema"] is not None
                                 else "has no",
                                 "tracks one" if self.ema is not None
                                 else "tracks none"))
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            if self.ema is not None:
                for name, value in tree["ema"].items():
                    self.ema[name].copy_(value)
            for p in params.values():
                p.grad = None
            for name, grad in tree["accumulation"]["grads"].items():
                params[name].grad = grad.to(params[name].device)
        self.step = int(tree["step"])
        self.updates = int(tree["updates"])


def _param_paths(model):
    """name -> the path string `trainable=` matches: for TransformerLM
    and LlamaLM the JAX package's parameter path (through the
    converters' name map, so a regex written for the JAX Trainer freezes
    the same weights); for any other module the dotted name."""
    from cloud_tpu_torch.models import convert
    from cloud_tpu_torch.models.llama import LlamaLM
    from cloud_tpu_torch.models.transformer import TransformerLM

    if isinstance(model, TransformerLM):
        path_of = convert.transformer_param_path
    elif isinstance(model, LlamaLM):
        path_of = convert.llama_param_path
    else:
        path_of = str
    return {name: path_of(name) for name, _ in model.named_parameters()}


def trainable_mask(model, trainable):
    """name -> whether `trainable` (a regex, `re.search`ed, or a
    callable path -> bool) selects the parameter; see `_param_paths` for
    the path each parameter is matched by."""
    if callable(trainable):
        matches = trainable
    else:
        pattern = re.compile(trainable)
        matches = lambda path: pattern.search(path) is not None
    return {name: bool(matches(path))
            for name, path in _param_paths(model).items()}


class Trainer:
    """Keras-`model.fit` parity on one device."""

    def __init__(self, model, optimizer="adam",
                 loss="sparse_categorical_crossentropy",
                 metrics=("accuracy",), mesh=None,
                 param_sharding_rules=None, train_kwargs=None,
                 eval_kwargs=None, seed=0, aux_loss_weight=0.01,
                 gradient_accumulation_steps=1,
                 remat=False, zero1=False, fsdp=False, ema_decay=None,
                 steps_per_execution=1, trainable=None):
        """Constructor.

        Args:
            model: a `torch.nn.Module`; `model(x, **kwargs)` returns the
                outputs. When its forward takes `generator`, each train
                step passes a `torch.Generator` seeded from `seed` and the
                step (the dropout draws).
            optimizer: a name in OPTIMIZERS (optax's default learning
                rates), a `make_optimizer(...)` spec, any callable
                params -> `torch.optim.Optimizer`, or an optimizer already
                built over the model's parameters.
            loss: callable(outputs, labels) -> per-example loss, or a
                name in LOSSES.
            metrics: names in METRICS or callables (outputs, labels) ->
                per-example values (or a scalar).
            train_kwargs / eval_kwargs: extra forward kwargs for training
                (e.g. {"deterministic": False}) / evaluation.
            seed: the shuffle seed and the dropout generator's seed.
            aux_loss_weight: weight of the aux losses a training forward
                leaves in the model's `aux_losses` (the MoE blocks' load
                balancing), added to the training loss and to the loss
                the history reports; `evaluate` adds none.
            gradient_accumulation_steps: apply the averaged gradient of
                every N steps (optax.MultiSteps semantics).
            ema_decay: track an exponential moving average of the
                parameters, e <- decay e + (1 - decay) p after each
                applied update (once per N micro-steps under
                accumulation); `ema_params`, and `evaluate` / `predict`
                take `use_ema=True`.
            trainable: a regex (`re.search`) or a callable path -> bool
                over the parameters' paths (`trainable_mask`): the others
                are frozen (`requires_grad` off when the Trainer builds):
                no update, no weight decay, no optimizer state.
        """
        unported = {"mesh": (mesh is not None, 6),
                    "param_sharding_rules": (param_sharding_rules
                                             is not None, 6),
                    "zero1": (bool(zero1), 6), "fsdp": (bool(fsdp), 6),
                    "remat": (bool(remat), 2),
                    "steps_per_execution > 1": (
                        int(steps_per_execution) != 1, 2)}
        for name, (used, item) in unported.items():
            if used:
                raise NotImplementedError(
                    "Trainer({}) {} {}).".format(name, _NOT_PORTED, item))
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module; got "
                            "{!r}.".format(type(model)))
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError("ema_decay must be in (0, 1); got {}.".format(
                ema_decay))
        self.model = model
        self.optimizer_spec = optimizer
        self.ema_decay = ema_decay
        self.trainable = trainable
        self.gradient_accumulation_steps = int(gradient_accumulation_steps)
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1; "
                             "got {}.".format(gradient_accumulation_steps))
        if loss is sparse_categorical_crossentropy:
            raise TypeError(
                "sparse_categorical_crossentropy is a factory — call it "
                "(e.g. loss=sparse_categorical_crossentropy(0.1)) or "
                "use the string 'sparse_categorical_crossentropy'.")
        self.loss_fn = LOSSES[loss] if isinstance(loss, str) else loss
        self.metric_fns = {}
        for m in metrics:
            if isinstance(m, str):
                self.metric_fns[m] = METRICS[m]
            else:
                self.metric_fns[getattr(m, "__name__", "metric")] = m
        self.train_kwargs = dict(train_kwargs or {})
        self.eval_kwargs = dict(eval_kwargs or {})
        self.seed = seed
        self.aux_loss_weight = aux_loss_weight
        self.state = None
        self.optimizer = None
        self.stop_training = False
        self._abort_epoch = False
        self._data_progress = None
        self._resume_probe = None
        self._chaos = None
        self._metric_reader = None
        self._pending_history = []
        self._takes_generator = _accepts(model.forward, "generator")

    @property
    def device(self):
        return next(self.model.parameters()).device

    # -- state construction --------------------------------------------

    def build(self, sample_x=None, variables=None):
        """Creates the optimizer (lazily called by fit), after freezing
        the parameters `trainable=` leaves out and before copying the EMA
        shadow. `variables`: a state dict (name -> tensor or array) to
        start from, e.g. from `params_from_flax`; keys and shapes must
        match the model's."""
        if self.state is not None:
            if variables is not None:
                raise RuntimeError(
                    "build(variables=...) called on an already-built "
                    "Trainer: the provided weights would be ignored. "
                    "Load weights before the first fit/evaluate/"
                    "predict/build call.")
            return self.state
        if variables is not None:
            own = self.model.state_dict()
            given = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v) for k, v in variables.items()}
            if set(given) != set(own) or any(
                    tuple(given[k].shape) != tuple(own[k].shape)
                    for k in own):
                raise ValueError(
                    "build(variables=...): provided params do not match "
                    "the model's structure/shapes — wrong checkpoint for "
                    "this model configuration?")
            self.model.load_state_dict(given)
        if self.trainable is not None:
            mask = trainable_mask(self.model, self.trainable)
            if not any(mask.values()):
                raise ValueError("trainable={!r} matches no parameter."
                                 .format(self.trainable))
            for name, p in self.model.named_parameters():
                if not mask[name]:
                    p.requires_grad_(False)
        spec = self.optimizer_spec
        params = [p for p in self.model.parameters() if p.requires_grad]
        if isinstance(spec, torch.optim.Optimizer):
            optimizer = spec
        elif isinstance(spec, str):
            optimizer = OPTIMIZERS[spec](params)
        else:
            optimizer = spec(params)
        self.optimizer = optimizer
        ema = None
        if self.ema_decay is not None:
            ema = {n: p.detach().clone()
                   for n, p in self.model.named_parameters()}
        self.state = TrainState(0, self.model, optimizer, ema=ema,
                                accumulation_steps=(
                                    self.gradient_accumulation_steps))
        return self.state

    # -- steps ----------------------------------------------------------

    def _to_device(self, tree):
        dev = self.device

        def put(a):
            if a is None:
                return None
            t = torch.as_tensor(np.asarray(a))
            if t.dtype.is_floating_point:
                t = t.float()
            elif t.dtype != torch.bool:
                t = t.long()
            return t.to(dev, non_blocking=True)

        return _tree_map(put, tree)

    def _step_generator(self, step):
        """The dropout generator of train step `step`: seeded from the
        Trainer's seed folded with the step (threefry), on the model's
        device."""
        key = data_lib.fold_in(data_lib.prng_key(self.seed), step)
        seed = (int(key[0]) << 32 | int(key[1])) & 0x7FFFFFFFFFFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)

    def _metric_logs(self, outputs, y, mask, per_row):
        """Each metric's mean over the batch, weighted by `mask` [B]:
        per-example values take the weighted mean; a scalar is kept as
        it is, unless the batch needs per-row weighting (`per_row`:
        sample weights or padded rows) and the metric cannot take the
        mask, which raises."""
        logs = {}
        lead = mask.shape[0]
        for name, fn in self.metric_fns.items():
            masked = _accepts(fn, "mask")
            v = torch.as_tensor(fn(outputs, y, mask=mask) if masked
                                else fn(outputs, y))
            if v.ndim >= 1:
                logs[name] = _weighted_mean(
                    _per_example_view(v, lead).float(), mask)
            elif per_row and not masked:
                raise ValueError(
                    "Custom metric {!r} returns a scalar and cannot "
                    "apply per-row weights (sample_weight or a padded "
                    "tail batch). Give it a mask-aware signature "
                    "fn(outputs, y, mask=...) or return per-example "
                    "values.".format(name))
            else:
                logs[name] = v.float()
        return logs

    def _update_ema(self):
        """e <- decay e + (1 - decay) p over every parameter (JAX's
        recurrence), after an applied update."""
        ema = self.state.ema
        names = list(ema)
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            shadow = [ema[n] for n in names]
            torch._foreach_mul_(shadow, self.ema_decay)
            torch._foreach_add_(shadow, [params[n].detach() for n in names],
                                alpha=1.0 - self.ema_decay)

    def _train_step(self, batch, weighted):
        if weighted:
            x, y, w = self._to_device(batch)
        else:
            x, y = self._to_device(batch)
            w = None
        self.model.train()
        kwargs = dict(self.train_kwargs)
        if self._takes_generator:
            kwargs["generator"] = self._step_generator(self.state.step)
        outputs = self.model(x, **kwargs)
        per_example = self.loss_fn(outputs, y)
        if w is not None:
            # Weighted Keras semantics: mean(per_example * w), not
            # normalized by sum(w).
            per_example = _per_example_view(per_example, w.shape[0]) * w
        loss = per_example.mean()
        sown = getattr(self.model, "aux_losses", None)
        if sown:
            loss = loss + self.aux_loss_weight * sum(
                aux.to(loss.dtype) for aux in sown)
        k = self.gradient_accumulation_steps
        (loss / k if k > 1 else loss).backward()
        self.state.step += 1
        if self.state.step % k == 0:
            schedule = getattr(self.optimizer, "lr_schedule", None)
            if schedule is not None:
                lr = float(schedule(self.state.updates))
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.state.updates += 1
            if self.state.ema is not None:
                self._update_ema()
        with torch.no_grad():
            mask = w if w is not None else torch.ones(
                (_first_leaf(outputs).shape[0],), device=loss.device)
            logs = {"loss": loss.detach()}
            logs.update(self._metric_logs(_tree_map(torch.Tensor.detach,
                                                    outputs), y, mask,
                                          weighted))
            if weighted:
                logs["_batch_weight"] = w.sum()
        return logs

    # -- fit ------------------------------------------------------------

    def fit(self, x=None, y=None, epochs=1, batch_size=32, shuffle=True,
            validation_data=None, validation_split=0.0, initial_epoch=0,
            callbacks=(), steps_per_epoch=None, verbose=True,
            sample_weight=None, class_weight=None, resume_from=None,
            resume=None, cache=None, input_cast=None, warm_start=False,
            async_logging=True, retries=None):
        """Trains the model; returns a history dict of per-epoch logs
        (the epoch means of loss and metrics, steps_per_sec, and val_*
        from `validation_data` / `validation_split`).

        As the JAX Trainer: array inputs, shuffled per epoch from `seed`
        (`data.epoch_permutation`), the tail batch dropped; `epochs` is
        the final epoch bound (`initial_epoch` the first);
        `steps_per_epoch` caps each epoch; `sample_weight` /
        `class_weight` weight the loss (mean(per_example * w)) and the
        metrics (weighted means); `validation_split` holds out the last
        fraction of the arrays before shuffling.

        callbacks: `training.callbacks.Callback`s; each sees the Trainer
            (`stop_training`, `request_stop()`, `planned_epochs`,
            `initial_epoch`, `state`).
        resume_from: a checkpoint directory; when it holds a checkpoint,
            the full train state is restored before training and the
            shuffle stream re-based to the saved mid-epoch position, so
            the run continues as if uninterrupted. A missing or empty
            directory is ignored.
        resume: "auto" runs the fit under `resilience.resilient_fit`:
            typed faults are caught, answered with a rescue or rollback
            checkpoint under `resume_from` (else CLOUD_TPU_RESUME_DIR,
            else ./graftguard_ckpt, saved every epoch) and retried with
            capped, jittered backoff.
        retries: the retry budget under resume="auto" (default
            CLOUD_TPU_RETRIES, 3).
        async_logging: each epoch's metrics are fetched by a background
            thread in one coalesced read (callbacks get a `LazyLogs`
            that resolves when read); False reads them at the epoch
            boundary. The values are the same either way.
        """
        for name, value, item in (("cache", cache, 4),
                                  ("input_cast", input_cast, 4),
                                  ("warm_start", warm_start or None, 2)):
            if value not in (None, "none"):
                raise NotImplementedError("fit({}=...) {} {}).".format(
                    name, _NOT_PORTED, item))
        kwargs = dict(
            x=x, y=y, epochs=epochs, batch_size=batch_size, shuffle=shuffle,
            validation_data=validation_data,
            validation_split=validation_split, initial_epoch=initial_epoch,
            callbacks=callbacks, steps_per_epoch=steps_per_epoch,
            verbose=verbose, sample_weight=sample_weight,
            class_weight=class_weight, resume_from=resume_from,
            async_logging=async_logging)
        if resume in (None, False, "none"):
            if retries is not None:
                raise ValueError("retries= only applies with resume='auto'.")
            return self._fit_impl(**kwargs)
        if resume != "auto":
            raise ValueError(
                "resume must be 'auto' or None; got {!r}.".format(resume))
        from cloud_tpu_torch.training import resilience

        return resilience.resilient_fit(self, retries=retries, **kwargs)

    def _fit_impl(self, x=None, y=None, epochs=1, batch_size=32,
                  shuffle=True, validation_data=None, validation_split=0.0,
                  initial_epoch=0, callbacks=(), steps_per_epoch=None,
                  verbose=True, sample_weight=None, class_weight=None,
                  resume_from=None, async_logging=True, data_seed=None,
                  history=None):
        """One fit attempt: `fit`'s body without the `resume="auto"`
        dispatch. The retry loop calls it with two extras: `data_seed`
        overrides the shuffle seed (a NaN rollback resumes with a fresh
        data order) and `history` accumulates one dict across
        attempts."""
        if validation_split:
            if not 0.0 < validation_split < 1.0:
                raise ValueError(
                    "validation_split must be in (0, 1); got {}."
                    .format(validation_split))
            if validation_data is not None:
                raise ValueError(
                    "Pass validation_split OR validation_data, not both.")
            n = np.asarray(_first_leaf(x)).shape[0]
            split = int(n * (1.0 - validation_split))
            if split == 0 or split == n:
                raise ValueError(
                    "validation_split={} leaves an empty {} set for {}"
                    " examples.".format(
                        validation_split,
                        "training" if split == 0 else "validation", n))
            take = lambda lo, hi: _tree_map(lambda a: np.asarray(a)[lo:hi],
                                            x)
            y_arr = np.asarray(y)
            if sample_weight is not None:
                sw = np.asarray(sample_weight, np.float32)
                validation_data = (take(split, n), y_arr[split:], sw[split:])
                sample_weight = sw[:split]
            else:
                validation_data = (take(split, n), y_arr[split:])
            x, y = take(0, split), y_arr[:split]
        if class_weight is not None:
            labels = None if y is None else np.asarray(y)
            if labels is None or labels.ndim != 1:
                raise ValueError(
                    "class_weight= needs 1-D integer labels `y`.")
            cw = np.ones(labels.shape[0], np.float32)
            for label, weight in class_weight.items():
                cw[labels == label] = float(weight)
            sample_weight = (cw if sample_weight is None
                             else np.asarray(sample_weight, np.float32) * cw)
        ds_kwargs = {}
        if sample_weight is not None:
            ds_kwargs["sample_weight"] = sample_weight
        dataset = data_lib.as_dataset(
            x, y, batch_size=batch_size, shuffle=shuffle,
            seed=self.seed if data_seed is None else data_seed, **ds_kwargs)
        weighted = dataset.sample_weight is not None
        if steps_per_epoch is None:
            steps_per_epoch = dataset.steps_per_epoch
        # The JAX Trainer peeks one batch to build (which draws epoch 0's
        # order): the training epochs then draw from epoch 1 on. The peek
        # is kept so the batches match the JAX package's.
        sample = next(iter(dataset))
        self.build(sample[0] if isinstance(sample, tuple) else sample)
        start_step = 0
        if resume_from is not None:
            from cloud_tpu_torch.training import checkpoint as checkpoint_lib

            ckpt_step = checkpoint_lib.latest_step(resume_from)
            if ckpt_step is not None:
                # CheckpointCorrupt propagates to resilient_fit, which
                # quarantines the step and re-enters on the one before.
                checkpoint_lib.restore(resume_from, self.state,
                                       step=ckpt_step)
                logger.info("Resumed training from %s at step %d.",
                            resume_from, self.state.step)
                meta = checkpoint_lib.load_metadata(resume_from,
                                                    ckpt_step) or {}
                initial_epoch, start_step = self._apply_data_state(
                    dataset, meta.get("data_state"), initial_epoch,
                    data_seed)

        history = {} if history is None else history
        self.stop_training = False
        self._abort_epoch = False
        # The fault injector: only when its module is loaded (a plan may
        # be installed) or CLOUD_TPU_CHAOS asks for it.
        chaos_mod = sys.modules.get("cloud_tpu_torch.analysis.chaos")
        if chaos_mod is None and os.environ.get("CLOUD_TPU_CHAOS"):
            from cloud_tpu_torch.analysis import chaos as chaos_mod
        self._chaos = None if chaos_mod is None else chaos_mod.active_plan()
        self._async_logging = bool(async_logging)
        if self._metric_reader is None:
            self._metric_reader = async_logs_lib.AsyncMetricReader()
        self._pending_history = []
        # The epoch range of this fit, visible to callbacks.
        self.planned_epochs = epochs
        self.initial_epoch = initial_epoch
        for cb in callbacks:
            cb.set_trainer(self)
            cb.on_train_begin()
        try:
            self._fit_epochs(dataset, epochs, steps_per_epoch,
                             validation_data, batch_size, callbacks, history,
                             verbose, initial_epoch, weighted, start_step)
        finally:
            runtime.set_phase(None)
            # Every exit path: the deferred history first (a failed
            # background fetch surfaces like a teardown error), then each
            # callback's on_train_end (one failing teardown skips no
            # other), then the async checkpoint writes. The first error
            # is raised after all ran, unless a training error is
            # already propagating.
            teardown_error = None
            try:
                self._materialize_history(history)
            except Exception as e:  # noqa: BLE001 - must not mask
                logger.exception("deferred metric fetch failed")
                teardown_error = e
            for cb in callbacks:
                try:
                    cb.on_train_end(history)
                except Exception as e:  # noqa: BLE001 - must not mask
                    logger.exception("on_train_end failed for %r", cb)
                    if teardown_error is None:
                        teardown_error = e
            ckpt_lib = sys.modules.get("cloud_tpu_torch.training.checkpoint")
            if ckpt_lib is not None:
                try:
                    ckpt_lib.wait_until_finished()
                except Exception as e:  # noqa: BLE001 - must not mask
                    logger.exception("async checkpoint drain failed")
                    if teardown_error is None:
                        teardown_error = e
            if teardown_error is not None and sys.exc_info()[1] is None:
                raise teardown_error
        return history

    def _fit_epochs(self, dataset, epochs, steps_per_epoch, validation_data,
                    batch_size, callbacks, history, verbose, initial_epoch,
                    weighted, start_step):
        # The global step at epoch entry; current_data_state subtracts
        # the epoch's base from the live step counter.
        host_base = self.state.step
        for epoch in range(initial_epoch, epochs):
            epoch_start = min(int(start_step) if epoch == initial_epoch
                              else 0, steps_per_epoch)
            self._data_progress = {
                "epoch": epoch,
                "epoch_base": host_base - epoch_start,
                # Before iteration advances it: the value this epoch's
                # permutation draws from.
                "dataset_epoch": int(dataset._epoch),
                "steps_per_epoch": steps_per_epoch,
                "data_seed": dataset.seed,
            }
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            step_logs = []
            count = 0
            t0 = time.time()
            runtime.set_phase("step")
            batches = itertools.islice(iter(dataset), epoch_start,
                                       steps_per_epoch)
            for batch in batches:
                if self._abort_epoch:
                    break
                if self._chaos is not None:
                    self._chaos.pre_dispatch(host_base + count, 1)
                step_logs.append(self._train_step(batch, weighted))
                count += 1
                probe, self._resume_probe = self._resume_probe, None
                if probe is not None:
                    probe.first_step()
            host_base += count
            if not (self._abort_epoch and count == 0):
                # An aborted epoch of zero steps has no metrics.
                self._post_epoch_logs(step_logs, count, t0, epoch,
                                      validation_data, batch_size,
                                      callbacks, history, verbose)
            if self.stop_training:
                break

    def request_stop(self):
        """Stops training at the next step boundary (safe from a signal
        handler or another thread): the partial epoch still runs its
        epoch-end callbacks, then fit() returns."""
        self._abort_epoch = True
        self.stop_training = True

    # -- the resumable data-stream position ----------------------------

    def current_data_state(self):
        """The resumable data-stream position for checkpoint metadata:
        `{"epoch", "step_in_epoch", "dataset_epoch", "data_seed"}` as of
        the current train state, or None outside a fit. A position at an
        epoch's end normalises to `(epoch + 1, 0)`."""
        progress = self._data_progress
        if progress is None or self.state is None:
            return None
        step_in_epoch = max(self.state.step - progress["epoch_base"], 0)
        epoch = progress["epoch"]
        dataset_epoch = progress["dataset_epoch"]
        spe = progress["steps_per_epoch"]
        if spe and step_in_epoch >= spe:
            rolls = step_in_epoch // spe
            epoch += rolls
            dataset_epoch += rolls
            step_in_epoch -= rolls * spe
        return {"epoch": epoch, "step_in_epoch": step_in_epoch,
                "dataset_epoch": dataset_epoch,
                "data_seed": progress["data_seed"]}

    def _apply_data_state(self, dataset, data_state, initial_epoch,
                          data_seed):
        """Re-bases the shuffle stream to a checkpoint's mid-epoch
        position; returns the effective `(initial_epoch, start_step)`.

        With the same data seed, the dataset's epoch counter is rewound
        to the interrupted epoch's (overwriting the tick this fit's peek
        took) and the fit skips the batches that epoch already took, so
        the resumed run continues the same permutation; with the dropout
        generator keyed off the restored step, it is the uninterrupted
        run. A different seed (a NaN rollback's fresh data order)
        restarts the interrupted epoch from its first batch instead."""
        if not data_state:
            return initial_epoch, 0
        epoch = int(data_state.get("epoch", initial_epoch))
        step_in_epoch = int(data_state.get("step_in_epoch", 0))
        dataset_epoch = data_state.get("dataset_epoch")
        seed_then = data_state.get("data_seed")
        seed_now = dataset.seed
        initial_epoch = max(initial_epoch, epoch)
        if dataset_epoch is not None:
            dataset._epoch = int(dataset_epoch)
        if seed_then is not None and seed_then != seed_now:
            logger.info(
                "Resuming epoch %d from its start with a fresh data "
                "order (seed %s -> %s).", epoch, seed_then, seed_now)
            return initial_epoch, 0
        if step_in_epoch:
            logger.info("Resuming mid-epoch: epoch %d, batch %d.", epoch,
                        step_in_epoch)
        return initial_epoch, step_in_epoch

    def _post_epoch_logs(self, step_logs, count, t0, epoch, validation_data,
                         batch_size, callbacks, history, verbose):
        """Epoch end: reduce the step logs on the device into one tree of
        scalars, fetch it once (on the reader thread under async
        logging, where callbacks get a `LazyLogs`), validate, defer the
        history append to fit's exit, run the callbacks."""
        runtime.set_phase("boundary")
        if "_batch_weight" in step_logs[0]:
            # Weighted fit: metrics re-weight each batch's weighted mean
            # by its weight sum; the loss is the plain per-step mean.
            ws = torch.stack([l["_batch_weight"] for l in step_logs])
            total_w = torch.clamp(ws.sum(), min=1e-9)
            dev_logs = {}
            for k in step_logs[0]:
                if k == "_batch_weight":
                    continue
                vals = torch.stack([l[k] for l in step_logs])
                dev_logs[k] = (vals.mean() if k == "loss"
                               else (vals * ws).sum() / total_w)
        else:
            dev_logs = {k: torch.stack([l[k] for l in step_logs]).mean()
                        for k in step_logs[0]}
        host_logs = {"steps_per_sec": count / max(time.time() - t0, 1e-9)}
        if validation_data is not None and not self._abort_epoch:
            # (A stop request's epoch skips validation: the grace window
            # of a preemption is for the checkpoint.)
            if len(validation_data) == 3:
                val_x, val_y, val_sw = validation_data
            else:
                (val_x, val_y), val_sw = validation_data, None
            val_logs = self.evaluate(val_x, val_y, batch_size=batch_size,
                                     verbose=False, sample_weight=val_sw)
            host_logs.update({"val_" + k: v for k, v in val_logs.items()})
        # The history keeps what the epoch produced, not what callbacks
        # write into `logs` afterwards.
        if self._async_logging:
            future = self._metric_reader.submit(dev_logs)
            logs = async_logs_lib.LazyLogs(future, device_keys=tuple(dev_logs),
                                           host_items=host_logs)
            self._pending_history.append((future, tuple(dev_logs),
                                          dict(host_logs)))
        else:
            logs = {k: float(v) for k, v in
                    runtime.device_fetch(dev_logs).items()}
            logs.update(host_logs)
            self._pending_history.append((None, (), dict(logs)))
        if verbose:
            logger.info("epoch %d: %s", epoch,
                        {k: round(v, 4) for k, v in logs.items()})
        for cb in callbacks:
            cb.on_epoch_end(epoch, logs)

    def _materialize_history(self, history):
        """Drains the deferred per-epoch records into `history` (fit's
        exit barrier): device metrics first, then the host entries. The
        first failed fetch re-raises after every healthy epoch landed."""
        pending, self._pending_history = self._pending_history, []
        fetch_error = None
        for future, dev_keys, host_items in pending:
            resolved = {}
            if future is not None:
                try:
                    resolved = future.result()
                except Exception as e:  # noqa: BLE001 - raised below
                    if fetch_error is None:
                        fetch_error = e
                    continue
            for k in dev_keys:
                history.setdefault(k, []).append(resolved[k])
            for k, v in host_items.items():
                history.setdefault(k, []).append(v)
        if fetch_error is not None:
            raise fetch_error

    # -- evaluation -----------------------------------------------------

    def _require_built(self):
        if self.state is None:
            raise RuntimeError("Model is not built; call fit() first or "
                               "build() with a sample batch.")

    @contextlib.contextmanager
    def _weights(self, use_ema):
        """The model's parameters, or (use_ema) the EMA shadow's values
        copied into them for the duration, the live values put back
        after."""
        if not use_ema:
            yield
            return
        ema = self.ema_params
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            live = {n: p.detach().clone() for n, p in params.items()}
            for n, p in params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(live[n])

    def evaluate(self, x, y=None, batch_size=32, verbose=True, steps=None,
                 sample_weight=None, use_ema=False):
        """Exact example-weighted mean loss/metrics over the dataset: the
        tail batch is padded by wrapping and the padded rows masked out
        (times any `sample_weight`), each batch weighted by its real
        weight. Totals stay on the device; one fetch at the end.
        use_ema: evaluate the EMA shadow (needs `ema_decay=`)."""
        self._require_built()
        with self._weights(use_ema):
            return self._evaluate(x, y, batch_size, verbose, steps,
                                  sample_weight)

    @torch.no_grad()
    def _evaluate(self, x, y, batch_size, verbose, steps, sample_weight):
        ds_kwargs = {}
        if sample_weight is not None:
            ds_kwargs["sample_weight"] = sample_weight
        dataset = data_lib.as_dataset(x, y, batch_size=batch_size,
                                      drop_remainder=False, **ds_kwargs)
        weighted = dataset.sample_weight is not None
        if steps is None:
            steps = dataset.steps_per_epoch
        self.model.eval()
        totals, weight = {}, 0.0
        for i, batch in enumerate(dataset):
            if i >= steps:
                break
            if weighted:
                xb, yb, wb = batch
            else:
                (xb, yb), wb = batch, None
            real = min(batch_size, dataset.num_examples - i * batch_size)
            mask = (np.arange(batch_size) < real).astype(np.float32)
            padded = real < batch_size
            if wb is not None:
                mask = mask * np.asarray(wb, np.float32)
            xb, yb, mask_t = self._to_device((xb, yb, mask))
            outputs = self.model(xb, **self.eval_kwargs)
            per_ex = _per_example_view(self.loss_fn(outputs, yb),
                                       mask_t.shape[0])
            logs = {"loss": _weighted_mean(per_ex, mask_t)}
            logs.update(self._metric_logs(outputs, yb, mask_t,
                                          padded or weighted))
            agg = mask_t.sum() if weighted else float(real)
            weight = weight + agg
            for k, v in logs.items():
                totals[k] = totals.get(k, 0.0) + v * agg
        weight, totals = runtime.device_fetch((weight, totals))
        weight = float(weight)
        if weight == 0.0:
            if weighted:
                raise ValueError(
                    "evaluate(): total sample_weight is zero — no "
                    "example carries weight, so no mean exists.")
            raise ValueError("evaluate() received an empty dataset.")
        logs = {k: float(v) / weight for k, v in totals.items()}
        if verbose:
            logger.info("evaluate: %s",
                        {k: round(v, 4) for k, v in logs.items()})
        return logs

    def predict(self, x, batch_size=32, use_ema=False):
        """Stacked model outputs for `x` as numpy (the model's output
        structure kept), batch by batch, the padded tail cut off.
        use_ema: predict with the EMA shadow (needs `ema_decay=`)."""
        self._require_built()
        with self._weights(use_ema):
            return self._predict(x, batch_size)

    @torch.no_grad()
    def _predict(self, x, batch_size):
        dataset = data_lib.as_dataset(x, None, batch_size=batch_size,
                                      drop_remainder=False)
        self.model.eval()
        outs = []
        for xb in dataset:
            outs.append(runtime.device_fetch(
                self.model(self._to_device(xb), **self.eval_kwargs)))
        n = dataset.num_examples

        def join(*leaves):
            if np.ndim(leaves[0]) == 0:
                return np.stack(leaves)
            return np.concatenate(leaves, axis=0)[:n]

        first = outs[0]
        if isinstance(first, dict):
            return {k: join(*[o[k] for o in outs]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(join(*[o[i] for o in outs])
                               for i in range(len(first)))
        return join(*outs)

    @property
    def ema_params(self):
        """The EMA shadow of the parameters, name -> tensor (requires
        `ema_decay=`)."""
        if self.ema_decay is None:
            raise RuntimeError(
                "No EMA is tracked; construct Trainer(ema_decay=...).")
        self._require_built()
        return self.state.ema

    def save_checkpoint(self, directory, use_async=False):
        """Saves the full train state under `<directory>/<step>`; pair
        with `restore_checkpoint` or `fit(resume_from=...)`. With
        use_async=True the write runs on a background thread
        (`checkpoint.wait_until_finished()` blocks on it)."""
        from cloud_tpu_torch.training import checkpoint as checkpoint_lib

        if self.state is None:
            raise RuntimeError("Model is not built; nothing to save.")
        return checkpoint_lib.save(directory, self.state,
                                   step=self.state.step, use_async=use_async)

    def restore_checkpoint(self, directory, sample_x=None, step=None):
        """Builds the train state (`sample_x` is accepted for the JAX
        signature; the port needs none), then restores the checkpoint
        `<directory>/<step>` (default: the latest) into it."""
        from cloud_tpu_torch.training import checkpoint as checkpoint_lib

        self.build(sample_x)
        return checkpoint_lib.restore(directory, self.state, step=step)

    def summary(self, print_fn=None):
        """Keras `model.summary()` parity: parameter counts per top-level
        module (each block of a ModuleList on its own row), totals and
        parameter bytes. Returns the text."""
        self._require_built()
        rows = {}
        for name, p in self.model.named_parameters():
            parts = name.split(".")
            key = ".".join(parts[:2]) if (
                len(parts) > 2 and parts[1].isdigit()) else parts[0]
            rows[key] = rows.get(key, 0) + p.numel()
        total = sum(rows.values())
        nbytes = sum(p.numel() * p.element_size()
                     for p in self.model.parameters())
        width = max([len(n) for n in rows] + [len("Total params")])
        lines = ["{:<{w}}  {:>14}".format("Module", "Params", w=width),
                 "-" * (width + 16)]
        for name in sorted(rows):
            lines.append("{:<{w}}  {:>14,}".format(name, rows[name],
                                                   w=width))
        lines.append("-" * (width + 16))
        lines.append("{:<{w}}  {:>14,}".format("Total params", total,
                                               w=width))
        lines.append("{:<{w}}  {:>14}".format(
            "Param bytes", "{:,}".format(nbytes), w=width))
        text = "\n".join(lines)
        (print_fn or (lambda t: logger.info("%s", t)))(text)
        return text


__all__ = ["LOSSES", "METRICS", "OPTIMIZERS", "TrainState", "Trainer",
           "make_optimizer", "sparse_categorical_crossentropy",
           "trainable_mask"]
