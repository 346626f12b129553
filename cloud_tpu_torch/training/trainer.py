"""Trainer: a `model.fit`-style training loop; the port of
`cloud_tpu/training/trainer.py` on one device.

The Trainer runs where the model's parameters live (the port's models
default to the CUDA card; build one with `device="cpu"` to train on the
CPU). Each step is the JAX step's body in eager PyTorch: the input
cast's widening, forward (recomputed in the backward under `remat=True`),
the loss mean (weighted Keras semantics under `sample_weight`) plus
`aux_loss_weight` times the aux losses the forward left in the model's
`aux_losses` (the MoE load-balancing losses, JAX's sown "losses"),
backward, one optimizer update (every k-th step under gradient
accumulation, as `optax.MultiSteps`), the EMA shadow after an applied
update (`ema_decay=`), and the step's metrics, which stay on the
device. Each epoch's metrics are reduced on the device and fetched once
through `runtime.device_fetch`, on a background thread by default
(`training.async_logs`).

Data reaches the step from host arrays or streams through
`data.prefetch_to_device` (counted host->device feeds, read ahead on a
side stream on the card), narrowed on the wire by `input_cast=`, or, with
`cache="device"`, from a `data.DeviceResidentDataset` gathered on the
device with no example bytes crossing after the upload.

`steps_per_execution=N` runs N steps per host round trip. JAX's one
dispatch (a `lax.scan` of N steps) is, on the card, a CUDA graph of the
train step captured once and replayed N times per group, reading static
input buffers that the feed (or the resident gather, inside the graph)
fills and the schedule's learning rate from a device tensor. An MoE
step reads its expert group sizes on the host, so its groups run as a
loop, with a warning that says so. Any other step that a graph cannot
replay raises instead: gradient accumulation and torch.optim.SGD under a
schedule at `build`, a forward that draws dropout from its generator,
or any other failure, at the capture (before step 1). On the CPU a
group is a loop. `fit(warm_start=True)` / `warmup()` pay the one-off
costs (the kernels' nvcc builds, cuDNN's algorithm choice, the graph's
capture) before step 1 by a warm step whose effects on the state are
undone.

Around the loop, as in JAX: callbacks (`training.callbacks`), full
train-state checkpoints (`save_checkpoint`, `restore_checkpoint`,
`fit(resume_from=)`, `training.checkpoint`) with an exact mid-epoch
resume, `fit(resume="auto")` (`training.resilience`) and frozen
parameters (`trainable=`).

Example:
    model = ResNet50(num_classes=1000)
    trainer = Trainer(model, optimizer=make_optimizer("sgd", 0.1),
                      train_kwargs={"train": True},
                      eval_kwargs={"train": False},
                      steps_per_execution=8)
    history = trainer.fit(x_train, y_train, epochs=2, batch_size=256,
                          cache="device", input_cast="bfloat16",
                          warm_start=True)

Not ported yet (they raise NotImplementedError naming their ROADMAP
item): meshes and sharding rules, ZeRO/FSDP.
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
from cloud_tpu_torch.training import optimizers as optimizers_lib

logger = logging.getLogger("cloud_tpu_torch")

_NOT_PORTED = "is not ported yet (ROADMAP §1: Modules to port, item"
_captures = [0]


def graph_captures():
    """How many train-step CUDA graphs this process has captured (a fit
    after `warmup()` / `warm_start=True` captures none on step 1)."""
    return _captures[0]


def _layers():
    from cloud_tpu_torch.models import _layers as layers

    return layers


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


def _rmsprop(params, learning_rate=None):
    return optimizers_lib.RMSprop(params, lr=_lr(learning_rate, 1e-3))


def _adagrad(params, learning_rate=None):
    return optimizers_lib.Adagrad(params, lr=_lr(learning_rate, 1e-2))


def _adafactor(params, learning_rate=None):
    # optax.adafactor() applies no learning rate (the step is relative to
    # each parameter's RMS); a given rate scales it, as optax does.
    lr = None if learning_rate is None else _lr(learning_rate, None)
    return optimizers_lib.Adafactor(params, lr=lr)


def _lamb(params, learning_rate=None):
    return optimizers_lib.Lamb(params, lr=_lr(learning_rate, 1e-3))


def _lion(params, learning_rate=None):
    return optimizers_lib.Lion(params, lr=_lr(learning_rate, 1e-4))


OPTIMIZERS = {
    "adam": _adam,
    "adamw": _adamw,
    "sgd": _sgd,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
    "adafactor": _adafactor,
    "lamb": _lamb,
    "lion": _lion,
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


def _copy_into(dst, src):
    """Copies the tensors of tree `src` into tree `dst` (None leaves
    skipped)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, t in zip(dst, src):
            _copy_into(d, t)
    elif dst is not None:
        dst.copy_(src)


class _CapturedStep:
    """One train step captured as a CUDA graph (the card's counterpart
    of JAX's one dispatch), replayed once per step of a group.

    Host-fed: the step reads static input buffers that `run` fills from
    the fed batch (a copy on the device). Resident: the step gathers its
    batch inside the graph from the resident dataset at a device
    position, `perm[pos * B + arange(B)]`, and advances the position, so
    a replay moves no byte across the wire; `start_epoch` sets the
    epoch's order and position. The schedule's rate is a device tensor
    the Trainer fills before each replay. Every kernel is built, every
    algorithm chosen and every lazy optimizer state made by the warm
    step before the capture; the flash kernels' tensor maps, encoded on
    the host at capture, hold the static buffers' addresses, which the
    graph's memory pool keeps for every replay.
    """

    def __init__(self, trainer, resident, example):
        self.trainer = trainer
        self.resident = resident
        device = trainer.device
        if resident is None:
            self.static = _tree_map(
                lambda t: None if t is None else t.detach().clone(),
                example)
        else:
            self.perm = torch.arange(resident.num_examples, device=device)
            self.pos = torch.zeros((), dtype=torch.int64, device=device)
            self.offsets = torch.arange(resident.batch_size, device=device)
        self.graph = None
        self.keys = None
        self.out = None

    def inputs(self):
        """(x, y, w) of one step: the static buffers, or the resident
        gather at the device position (which it advances)."""
        if self.resident is None:
            return Trainer._split(self.static, len(self.static) == 3)
        idx = self.perm.index_select(
            0, self.pos * self.resident.batch_size + self.offsets)
        self.pos.add_(1)
        batch = self.resident.gather(idx)
        kind = self.resident.kind
        if kind == "xyw":
            return batch
        if kind == "xy":
            return batch[0], batch[1], None
        return batch, None, None

    def capture(self):
        graph = torch.cuda.CUDAGraph()
        # thread_local: the metric reader and data threads may touch the
        # card while this thread captures.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            logs = self.trainer._step(*self.inputs(), count=False,
                                      captured=True)
            self.keys = list(logs)
            self.out = torch.stack([logs[k].float() for k in self.keys])
        self.graph = graph
        _captures[0] += 1

    @torch.no_grad()
    def rebind(self, resident):
        """Takes a new upload of the captured geometry: its tensors are
        copied into the storage the graph reads, which the new dataset
        then reads too (its own copy is released)."""
        _copy_into(self.resident.data, resident.data)
        resident.data = self.resident.data
        self.resident = resident

    def start_epoch(self, order, start_step):
        """The resident epoch's device order and first position."""
        self.perm.copy_(order)
        self.pos.fill_(int(start_step))

    def run(self, x=None, y=None, w=None):
        """One replay (the fed batch copied into the static buffers
        first); advances the host counters as the eager step does and
        returns the step's logs (device scalars, copied out of the
        graph's output)."""
        trainer = self.trainer
        if self.resident is None:
            _copy_into(self.static, (x, y) if w is None else (x, y, w))
        trainer._set_lr()
        self.graph.replay()
        trainer.state.updates += 1
        trainer.state.step += 1
        out = self.out.clone()
        return {k: out[i] for i, k in enumerate(self.keys)}


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
    """name -> the path string `trainable=` matches: for TransformerLM,
    LlamaLM and the image families the JAX package's parameter path
    (through the converters' name map, so a regex written for the JAX
    Trainer freezes the same weights); for any other module the dotted
    name."""
    from cloud_tpu_torch.models import convert
    from cloud_tpu_torch.models.llama import LlamaLM
    from cloud_tpu_torch.models.transformer import TransformerLM

    from cloud_tpu_torch.models.mnist import MLP, ConvNet
    from cloud_tpu_torch.models.resnet import ResNet
    from cloud_tpu_torch.models.vit import ViT

    if isinstance(model, TransformerLM):
        path_of = convert.transformer_param_path
    elif isinstance(model, LlamaLM):
        path_of = convert.llama_param_path
    elif isinstance(model, (MLP, ConvNet, ResNet, ViT)):
        path_of = lambda name: convert.image_param_path(model, name)
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
            remat: recompute the forward in the backward (`jax.checkpoint`
                of the loss in JAX; `torch.utils.checkpoint`, non-reentrant,
                here): activation memory for FLOPs. The recompute draws the
                step's dropout masks again from a generator seeded as the
                first forward's, and BatchNorm moves its running averages
                once (in the first forward).
            steps_per_execution: N optimizer steps per host round trip
                (Keras `steps_per_execution`): on the card a CUDA graph of
                the step replayed N times a group (module doc), on the
                CPU a loop; the history is the per-step mean, as JAX's.
                On the card, a step that cannot be captured raises (at
                `build`, or at the capture for a forward that draws
                dropout); an MoE step runs its groups as a loop.
        """
        unported = {"mesh": mesh is not None,
                    "param_sharding_rules": param_sharding_rules is not None,
                    "zero1": bool(zero1), "fsdp": bool(fsdp)}
        for name, used in unported.items():
            if used:
                raise NotImplementedError(
                    "Trainer({}) {} 6).".format(name, _NOT_PORTED))
        self.steps_per_execution = int(steps_per_execution)
        if self.steps_per_execution < 1:
            raise ValueError("steps_per_execution must be >= 1; got "
                             "{}.".format(steps_per_execution))
        self.remat = bool(remat)
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
        # The fit's input cast (None without one).
        self._policy = None
        # Captured step graphs by geometry, the schedule's device rate,
        # and the geometries already warmed.
        self._graphs = {}
        self._lr_tensor = None
        self._warmed = set()
        self._spe_route = None

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
        self._choose_spe_route()
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
        """A host batch as tensors on the model's device (a counted
        feed, `data.device_put`)."""
        return data_lib.device_put(tree, self.device)

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

    def _forward(self, x, step, captured, generator=None):
        """The training forward at train step `step`. The dropout
        generator is seeded from the step (none inside a captured graph:
        `_capture` refuses a forward that draws from it), or is
        `generator` when one is given (the capture's probe). Under remat
        the forward runs inside `torch.utils.checkpoint` (non-reentrant):
        the recompute makes the same generator afresh (checkpoint restores
        only the global RNGs) and raises the recompute flag, so BatchNorm
        leaves its running averages as the first forward moved them."""
        kwargs = dict(self.train_kwargs)
        if generator is not None:
            kwargs["generator"] = generator
        draw = self._takes_generator and not captured
        if not self.remat:
            if draw:
                kwargs["generator"] = self._step_generator(step)
            return self.model(x, **kwargs)
        calls = [0]

        def run(x):
            run_kwargs = dict(kwargs)
            if draw:
                run_kwargs["generator"] = self._step_generator(step)
            calls[0] += 1
            previous = _layers().set_recomputing(calls[0] > 1)
            try:
                return self.model(x, **run_kwargs)
            finally:
                _layers().set_recomputing(previous)

        from torch.utils import checkpoint as checkpoint_lib

        return checkpoint_lib.checkpoint(run, x, use_reentrant=False,
                                         preserve_rng_state=not captured)

    def _set_lr(self):
        """The schedule's rate for the next update into the optimizer:
        into the device tensor the captured graph reads (a fill, no
        copy from the host), else into each group as a float."""
        schedule = getattr(self.optimizer, "lr_schedule", None)
        if schedule is None:
            return
        lr = float(schedule(self.state.updates))
        if self._lr_tensor is not None:
            self._lr_tensor.fill_(lr)
            # A restored optimizer state dict brings its own rate back.
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr_tensor
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def _step(self, x, y, w, count=True, captured=False, generator=None):
        """One train step on device tensors (x possibly narrowed by the
        input cast): forward, loss, backward, the update (every k-th
        step), EMA; returns the step's logs (device scalars). count:
        advance the host step and update counters (a captured or warming
        step leaves them to its caller). generator: the forward's, in
        place of the step's own (`_forward`)."""
        if self._policy is not None:
            x = self._policy.widen(x)
        self.model.train()
        step = self.state.step
        outputs = self._forward(x, step, captured, generator)
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
        if (step + 1) % k == 0:
            if count:
                self._set_lr()
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            if self.state.ema is not None:
                self._update_ema()
            if count:
                self.state.updates += 1
        if count:
            self.state.step += 1
        with torch.no_grad():
            mask = w if w is not None else torch.ones(
                (_first_leaf(outputs).shape[0],), device=loss.device)
            logs = {"loss": loss.detach()}
            logs.update(self._metric_logs(_tree_map(torch.Tensor.detach,
                                                    outputs), y, mask,
                                          w is not None))
            if w is not None:
                logs["_batch_weight"] = w.sum()
        return logs

    def _train_step(self, batch, weighted):
        """Feeds one host batch ((x, y) or (x, y, w)) and runs one step
        on it (the eager single-step path)."""
        return self._run_fed(self._to_device(batch), weighted)

    @staticmethod
    def _split(batch, weighted):
        if weighted:
            return batch
        x, y = batch
        return x, y, None

    def _run_fed(self, batch, weighted):
        """One step on a fed (device) batch: the captured graph when one
        was captured for its geometry, else eagerly."""
        graph = self._graphs.get(self._geometry(batch, weighted))
        if graph is not None:
            return graph.run(*self._split(batch, weighted))
        return self._step(*self._split(batch, weighted))

    # -- steps_per_execution on the card: the captured step ---------------

    def _choose_spe_route(self):
        """How a group of `steps_per_execution` steps runs: "graph" (a
        captured CUDA graph of the step, replayed per step) or "loop"
        (eager steps: on the CPU, and for an MoE step on the card, with
        one warning). A step that no graph can replay raises here with
        the reason; whether the forward draws dropout is known only by
        running it, and `_capture` refuses that."""
        self._spe_route = "loop"
        if self.steps_per_execution == 1 or self.device.type != "cuda":
            return
        from cloud_tpu_torch.models.moe import MoEMLP, TopKMoEMLP

        if any(isinstance(m, (MoEMLP, TopKMoEMLP))
               for m in self.model.modules()):
            logger.warning(
                "steps_per_execution=%d: an MoE layer reads its expert "
                "group sizes on the host every step, so each group runs as "
                "a loop of eager steps (one host read per step), not as "
                "replays of a captured graph.", self.steps_per_execution)
            return
        reason = None
        if self.gradient_accumulation_steps > 1:
            reason = ("gradient accumulation alternates two step bodies, "
                      "and the graph holds one")
        elif (getattr(self.optimizer, "lr_schedule", None) is not None
              and isinstance(self.optimizer, torch.optim.SGD)):
            reason = ("torch.optim.SGD reads a tensor learning rate on the "
                      "host, so its schedule cannot live in the graph")
        if reason is not None:
            raise ValueError(
                "steps_per_execution={} on the card replays a captured CUDA "
                "graph of the train step, and this step cannot be captured: "
                "{}. Use steps_per_execution=1.".format(
                    self.steps_per_execution, reason))
        self._spe_route = "graph"
        for group in self.optimizer.param_groups:
            if "capturable" in group:
                group["capturable"] = True
        if getattr(self.optimizer, "lr_schedule", None) is not None:
            self._lr_tensor = torch.zeros((), device=self.device)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr_tensor

    def _geometry(self, batch, weighted, resident=None):
        """The key a captured graph is kept under: the leaf shapes and
        dtypes of the fed batch (or of the resident dataset, with its
        batch size and kind), weighting, and the input cast (its lo and
        scale are constants inside the graph)."""
        leaves = []
        _tree_map(lambda t: leaves.append(
            None if t is None else (tuple(t.shape), t.dtype)),
            batch if resident is None else resident.data)
        cast = None if self._policy is None else self._policy.cache_key
        if resident is not None:
            return ("resident", tuple(leaves), resident.batch_size,
                    resident.kind, cast)
        return ("fed", tuple(leaves), weighted, cast)

    def _snapshot(self):
        """The state a warm step may touch: parameters, buffers (the
        BatchNorm statistics), the optimizer's state tensors and the EMA
        shadow, cloned."""
        model = {k: v.detach().clone()
                 for k, v in self.model.state_dict().items()}
        opt = {id(p): {k: v.clone() for k, v in st.items()
                       if isinstance(v, torch.Tensor)}
               for p, st in self.optimizer.state.items()}
        ema = (None if self.state.ema is None else
               {k: v.clone() for k, v in self.state.ema.items()})
        return model, opt, ema

    @torch.no_grad()
    def _restore(self, snapshot):
        """Puts a `_snapshot` back in place (the tensors keep their
        storage, so a captured graph still reads them); optimizer state
        the warm step created is zeroed (the start value of the
        torch.optim optimizers' lazy state: a zero momentum buffer, zero
        moments, step 0)."""
        model, opt, ema = snapshot
        for k, v in self.model.state_dict().items():
            v.copy_(model[k])
        for p, st in self.optimizer.state.items():
            saved = opt.get(id(p), {})
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    if k in saved:
                        v.copy_(saved[k])
                    else:
                        v.zero_()
        if ema is not None:
            for k, v in self.state.ema.items():
                v.copy_(ema[k])
        for p in self.model.parameters():
            p.grad = None

    def _warm_step(self, run):
        """Runs `run()` (one step) to pay its one-off costs (nvcc builds,
        cuDNN's algorithm choice, lazy optimizer state, cuBLAS
        workspaces), then undoes its effects on the state. On a card it
        runs on a side stream, as a CUDA graph capture wants."""
        snapshot = self._snapshot()
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            run()
        self._restore(snapshot)

    def _capture(self, key, source, example):
        """Captures the step as a CUDA graph for geometry `key` (warmed
        first) and keeps it; `source` makes the step's (x, y, w) inside
        the graph, `example` is a fed batch of the geometry for the warm
        step."""
        graph = _CapturedStep(self, source, example)
        # The warm step's forward gets a generator: if it draws from it,
        # the forward has dropout, which a replay cannot re-seed per step.
        probe = (torch.Generator(device=self.device).manual_seed(0)
                 if self._takes_generator else None)
        seeded = None if probe is None else probe.get_state()
        self._warm_step(lambda: self._step(*graph.inputs(), count=False,
                                           captured=True, generator=probe))
        if probe is not None and not torch.equal(probe.get_state(), seeded):
            raise ValueError(
                "steps_per_execution={}: the forward of {} draws dropout "
                "from its generator, which a captured CUDA graph cannot "
                "re-seed for each step; use steps_per_execution=1 or a "
                "dropout rate of 0.".format(self.steps_per_execution,
                                            type(self.model).__name__))
        try:
            graph.capture()
        except Exception as e:
            raise RuntimeError(
                "steps_per_execution={}: the train step of {} cannot be "
                "captured as a CUDA graph ({}: {}); run it with "
                "steps_per_execution=1.".format(
                    self.steps_per_execution, type(self.model).__name__,
                    type(e).__name__, e)) from e
        # One captured step at a time: a new geometry's graph releases
        # the last one's memory pool.
        self._graphs = {key: graph}
        return graph

    def _ensure_graph(self, batch, weighted, resident=None):
        """The captured graph of this geometry (captured on first use),
        or None on the loop route."""
        if self._spe_route != "graph":
            return None
        key = self._geometry(batch, weighted, resident)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key, resident, batch)
        elif resident is not None and graph.resident is not resident:
            graph.rebind(resident)
        return graph

    # -- fit ------------------------------------------------------------

    def fit(self, x=None, y=None, epochs=1, batch_size=32, shuffle=True,
            validation_data=None, validation_split=0.0, initial_epoch=0,
            callbacks=(), steps_per_epoch=None, verbose=True,
            resume_from=None, prefetch=2, sample_weight=None,
            class_weight=None, cache=None, input_cast=None,
            async_logging=True, warm_start=False, resume=None,
            retries=None):
        """Trains the model; returns a history dict of per-epoch logs
        (the epoch means of loss and metrics, steps_per_sec, and val_*
        from `validation_data` / `validation_split`).

        As the JAX Trainer: array inputs (shuffled per epoch from `seed`,
        `data.epoch_permutation`, the tail batch dropped) or any dataset
        `data.as_dataset` takes (a list of batches, `GeneratorDataset`,
        `NpzShardDataset`, `ThreadedDataset`, re-iterated each epoch;
        a batch of another size than the first runs as a single eager
        step); `epochs` is the final epoch bound (`initial_epoch` the
        first); `steps_per_epoch` caps each epoch (a dataset's own
        applies when unset); `sample_weight` / `class_weight` weight the
        loss (mean(per_example * w)) and the metrics (weighted means);
        `validation_split` holds out the last fraction of the arrays
        before shuffling.

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
        prefetch: device read-ahead depth of the host feed
            (`data.prefetch_to_device`); 0 feeds synchronously.
        cache: "device" uploads the dataset to the device once per
            fit (`data.DeviceResidentDataset`) and gathers every batch
            there in the host path's order: no example bytes cross
            after the upload (`runtime.transfer_stats()`). Array inputs
            within the memory budget only; anything else streams from
            the host after one warning line.
        input_cast: "bfloat16" (float leaves cross as bf16, any input)
            or "uint8" (affine-quantized, array inputs): the features
            cross narrow (or stay narrow in the resident copy) and the
            step's first operation widens them to f32.
        warm_start: pay the one-off costs before the epoch loop (the
            kernels' nvcc builds, cuDNN's algorithm choice at the fit's
            shapes, the steps_per_execution graph's capture) by a warm
            step whose effects on the state are undone: step 1 moves
            none of `_build.build_count()` and `graph_captures()`.
        """
        kwargs = dict(
            x=x, y=y, epochs=epochs, batch_size=batch_size, shuffle=shuffle,
            validation_data=validation_data,
            validation_split=validation_split, initial_epoch=initial_epoch,
            callbacks=callbacks, steps_per_epoch=steps_per_epoch,
            verbose=verbose, sample_weight=sample_weight,
            class_weight=class_weight, resume_from=resume_from,
            prefetch=prefetch, cache=cache, input_cast=input_cast,
            async_logging=async_logging, warm_start=warm_start)
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
                  resume_from=None, prefetch=2, cache=None, input_cast=None,
                  async_logging=True, warm_start=False, data_seed=None,
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
        arrays = isinstance(dataset, data_lib.ArrayDataset)
        if sample_weight is not None and not arrays:
            raise ValueError(
                "sample_weight= needs array inputs (datasets carry their "
                "own weights by yielding (x, y, w) via "
                "ArrayDataset(sample_weight=...)).")
        weighted = arrays and dataset.sample_weight is not None
        if steps_per_epoch is None:
            steps_per_epoch = getattr(dataset, "steps_per_epoch", None)
        # The JAX Trainer peeks one batch to build (which draws epoch 0's
        # order): the training epochs then draw from epoch 1 on. The peek
        # is kept so the batches match the JAX package's.
        sample = next(iter(dataset))
        sample_x = sample[0] if isinstance(sample, tuple) else sample
        self.build(sample_x)
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

        policy = self._input_policy(input_cast, dataset, sample_x)
        self._policy = policy
        resident = None
        if cache not in (None, "none", False):
            if cache != "device":
                raise ValueError(
                    "Unknown cache={!r}; expected 'device'.".format(cache))
            # Uploaded on every fit, as JAX does: arrays changed in place
            # since the last fit are trained on as they are now. A graph
            # captured for the same geometry takes the new upload
            # (`_ensure_graph`).
            resident = data_lib.DeviceResidentDataset.build(
                dataset, input_cast=policy, device=self.device)
        if warm_start:
            self._warm(resident=resident, sample=sample, policy=policy,
                       weighted=weighted)

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
            if resident is not None:
                self._fit_epochs_resident(
                    resident, epochs, steps_per_epoch, validation_data,
                    batch_size, callbacks, history, verbose, initial_epoch,
                    start_step)
            else:
                self._fit_epochs(dataset, epochs, steps_per_epoch,
                                 validation_data, batch_size, callbacks,
                                 history, verbose, initial_epoch, weighted,
                                 start_step, prefetch, policy)
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

    @staticmethod
    def _input_policy(input_cast, dataset, sample_x):
        """The fit's `InputCast` (None without one): calibrated on the
        full arrays, or (bf16 on a stream) on the sample."""
        if input_cast in (None, "none"):
            return None
        if isinstance(dataset, data_lib.ArrayDataset):
            return data_lib.make_input_cast(input_cast, dataset.x)
        if (input_cast in ("bfloat16", "bf16")
                or isinstance(input_cast, data_lib.InputCast)):
            return data_lib.make_input_cast(input_cast, sample_x)
        raise ValueError(
            "input_cast='uint8' calibrates lo/scale from the full arrays "
            "and needs array inputs; streaming datasets support "
            "input_cast='bfloat16'.")

    @staticmethod
    def _host_cast(batch, policy):
        """A host batch with the input cast's narrowing on its features."""
        if policy is None:
            return batch
        if isinstance(batch, tuple) and len(batch) in (2, 3):
            return (policy.host_cast(batch[0]),) + tuple(batch[1:])
        return policy.host_cast(batch)

    def _warm(self, resident=None, sample=None, policy=None,
              weighted=False):
        """The one-off costs of the fit's step, paid before step 1 (once
        per geometry): the graph's capture on the graph route (after its
        own warm step; a new upload of a captured geometry is copied into
        the graph's storage), else a warm eager step whose effects are
        undone."""
        fed = (None if resident is not None
               else self._to_device(self._host_cast(sample, policy)))
        if self._spe_route == "graph":
            self._ensure_graph(fed, weighted, resident)
            return
        key = self._geometry(fed, weighted, resident)
        if key in self._warmed:
            return
        if resident is not None:
            idx = torch.arange(resident.batch_size, device=self.device)
            batch = resident.gather(idx)
            self._warm_step(lambda: self._step(
                *self._split(batch, resident.kind == "xyw"), count=False))
        else:
            self._warm_step(lambda: self._step(*self._split(fed, weighted),
                                               count=False))
        self._warmed.add(key)

    def warmup(self, x, y=None, batch_size=32, sample_weight=None,
               input_cast=None, include_eval=False, include_predict=False):
        """Pays a fit's one-off costs for a data geometry ahead of (and
        without) training: the standalone form of
        `fit(warm_start=True)`. Builds the model from a sample batch, runs
        a warm step whose effects on the state are undone (the nvcc
        builds of the path's kernels, cuDNN's algorithm choice, lazy
        optimizer state) and, with steps_per_execution > 1 on the card,
        captures the host-fed step's CUDA graph. A later host-fed fit over
        the same geometry (batch size, weighting, input_cast) starts with
        none of them; a fit with cache="device" pays its upload and
        capture in `fit(warm_start=True)`. include_eval / include_predict
        also run one evaluation / prediction forward.

        Returns {"builds": nvcc builds so far, "captures": graphs
        captured so far}."""
        from cloud_tpu_torch.ops import _build

        ds_kwargs = {}
        if sample_weight is not None:
            ds_kwargs["sample_weight"] = np.asarray(sample_weight,
                                                    np.float32)
        dataset = data_lib.as_dataset(x, y, batch_size=batch_size,
                                      shuffle=False, **ds_kwargs)
        weighted = (isinstance(dataset, data_lib.ArrayDataset)
                    and dataset.sample_weight is not None)
        sample = next(iter(dataset))
        if not isinstance(sample, tuple):
            raise ValueError("warmup() needs labels y: its warm step is a "
                             "train step on the sample batch.")
        sample_x = sample[0]
        self.build(sample_x)
        policy = self._input_policy(input_cast, dataset, sample_x)
        self._policy = policy
        self._warm(sample=sample, policy=policy, weighted=weighted)
        if include_eval:
            self.evaluate(sample[0], sample[1], batch_size=batch_size,
                          verbose=False)
        if include_predict:
            self.predict(sample_x, batch_size=batch_size)
        return {"builds": _build.build_count(),
                "captures": graph_captures()}

    def _fit_epochs(self, dataset, epochs, steps_per_epoch, validation_data,
                    batch_size, callbacks, history, verbose, initial_epoch,
                    weighted, start_step, prefetch=2, policy=None):
        # The global step at epoch entry; current_data_state subtracts
        # the epoch's base from the live step counter.
        host_base = self.state.step
        spe = self.steps_per_execution
        for epoch in range(initial_epoch, epochs):
            epoch_start = int(start_step) if epoch == initial_epoch else 0
            if steps_per_epoch is not None:
                epoch_start = min(epoch_start, steps_per_epoch)
            self._data_progress = {
                "epoch": epoch,
                "epoch_base": host_base - epoch_start,
                # Before iteration advances it: the value this epoch's
                # permutation draws from.
                "dataset_epoch": int(getattr(dataset, "_epoch", 0)),
                "steps_per_epoch": steps_per_epoch,
                "data_seed": getattr(dataset, "seed", None),
            }
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            step_logs = []
            count = 0
            t0 = time.time()
            runtime.set_phase("step")
            limit = (None if steps_per_epoch is None
                     else steps_per_epoch - epoch_start)
            host = self._epoch_batches(dataset, epoch_start)
            if policy is not None:
                host = (self._host_cast(b, policy) for b in host)
            feeder = data_lib.prefetch_to_device(
                host, size=prefetch, limit=limit, device=self.device)
            steady = None
            while not self._abort_epoch:
                # A group of up to steps_per_execution fed batches; a
                # batch of another size than the epoch's first (a ragged
                # tail) runs as a single eager step.
                group = list(itertools.islice(feeder, spe))
                if not group:
                    break
                if self._chaos is not None:
                    self._chaos.pre_dispatch(host_base + count, len(group))
                for batch in group:
                    if self._abort_epoch:
                        break
                    lead = _first_leaf(batch).shape[0]
                    if steady is None:
                        steady = lead
                    if spe > 1 and lead == steady:
                        self._ensure_graph(batch, weighted)
                    step_logs.append(self._run_fed(batch, weighted))
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

    @staticmethod
    def _epoch_batches(dataset, start_step):
        """One epoch of host batches from batch `start_step` on (an
        `ArrayDataset` slices its permutation; any other dataset drops
        the first batches)."""
        if isinstance(dataset, data_lib.ArrayDataset):
            return dataset.iter_from(start_step)
        it = iter(dataset)
        return itertools.islice(it, int(start_step), None) if start_step \
            else it

    def _fit_epochs_resident(self, resident, epochs, steps_per_epoch,
                             validation_data, batch_size, callbacks, history,
                             verbose, initial_epoch, start_step):
        """The device-resident epoch loop: each batch is gathered on the
        device from the uploaded dataset in the epoch's order
        (`resident.epoch_order`, the host path's permutation), so the
        loop moves no example bytes. steps_per_execution composes: a
        group is steps_per_execution steps (a graph replay each on the
        graph route), and a resumed position that is not on a group
        boundary replays its epoch from the start with a warning, as
        JAX's resident loop does."""
        weighted = resident.kind == "xyw"
        steps = resident.steps_per_epoch
        if steps_per_epoch is not None:
            steps = min(steps, int(steps_per_epoch))
        spe = min(self.steps_per_execution, steps)
        start = int(start_step)
        if start and (start % spe or start >= steps):
            logger.warning(
                "Resident resume position step_in_epoch=%d does not sit on "
                "a dispatch boundary (steps_per_execution=%d, "
                "steps_per_epoch=%d); replaying the epoch from its start "
                "instead.", start, spe, steps)
            start = 0
        graph = (self._ensure_graph(None, weighted, resident)
                 if self.steps_per_execution > 1 else None)
        src = resident.source
        host_base = self.state.step
        b = resident.batch_size
        for epoch in range(initial_epoch, epochs):
            epoch_start = start if epoch == initial_epoch else 0
            self._data_progress = {
                "epoch": epoch,
                "epoch_base": host_base - epoch_start,
                "dataset_epoch": int(src._epoch),
                "steps_per_epoch": steps,
                "data_seed": src.seed,
            }
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            order = resident.epoch_order(src._epoch)
            src._epoch += 1
            if graph is not None:
                graph.start_epoch(order, epoch_start)
            step_logs = []
            count = 0
            t0 = time.time()
            runtime.set_phase("step")
            position = epoch_start
            while position < steps and not self._abort_epoch:
                n = min(spe, steps - position)
                if self._chaos is not None:
                    self._chaos.pre_dispatch(host_base + count, n)
                for _ in range(n):
                    if graph is not None:
                        logs = graph.run()
                    else:
                        batch = resident.gather(
                            order[position * b:(position + 1) * b])
                        logs = self._step(*self._split(batch, weighted))
                    step_logs.append(logs)
                    position += 1
                    count += 1
                    probe, self._resume_probe = self._resume_probe, None
                    if probe is not None:
                        probe.first_step()
            host_base += count
            if not (self._abort_epoch and count == 0):
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
