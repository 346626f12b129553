"""graftchaos: deterministic fault injection for the resilient fit.

The training half of `cloud_tpu/analysis/chaos.py`. A chaos plan is a
comma-separated list of `kind@step[:arg]` events, usually given through
`CLOUD_TPU_CHAOS`; each fires exactly once at a configured global step
number, so a chaos run is reproducible: a rig for the recovery path
(`training/resilience.py`), not random monkey-testing. `Trainer.fit`
calls `pre_dispatch(step, n_steps)` before every step;
`checkpoint.save` calls `notify_checkpoint(path, step)` after every
write.

Kinds:

  `preempt@N`   Raise `resilience.Preemption` before step N.
  `fetch@N`     Raise `resilience.DataStall` before step N (a transient
                input-pipeline fetch error).
  `nan@N`       Raise `resilience.NaNLoss` before step N.
  `corrupt@N`   Truncate the largest file of the first checkpoint saved
                at step >= N: a torn write that restore must catch as
                `CheckpointCorrupt`.

`hang@N[:seconds]` waits for the watchdog that turns a hang into a typed
fault (ROADMAP §1 item 8) and raises NotImplementedError. The serving
kinds (`slot_hang`, `prefill_fail`, `slot_evict`, `pool_squeeze`) parse,
but nothing in the port consumes them yet.
"""

import logging
import os

from cloud_tpu_torch.training import resilience

logger = logging.getLogger("cloud_tpu_torch")

#: Serving kinds: tick-indexed; the training hook never fires them.
SERVE_KINDS = ("slot_hang", "prefill_fail", "slot_evict", "pool_squeeze")

KINDS = ("hang", "preempt", "fetch", "nan", "corrupt") + SERVE_KINDS


class ChaosEvent:
    """One `kind@step[:arg]` injection; fires at most once."""

    __slots__ = ("kind", "step", "arg", "fired")

    def __init__(self, kind, step, arg=None):
        self.kind = kind
        self.step = int(step)
        self.arg = arg
        self.fired = False

    def spec(self):
        return {"kind": self.kind, "step": self.step, "arg": self.arg,
                "fired": self.fired}

    def __repr__(self):
        return "ChaosEvent({}@{}{})".format(
            self.kind, self.step,
            ":{}".format(self.arg) if self.arg is not None else "")


def parse_spec(spec):
    """Parses a `kind@step[:arg],...` spec string into ChaosEvents."""
    events = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        kind, sep, rest = item.partition("@")
        kind = kind.strip()
        if not sep or kind not in KINDS:
            raise ValueError(
                "Malformed chaos event {!r}: expected kind@step[:arg] "
                "with kind in {}.".format(item, "/".join(KINDS)))
        if kind == "hang":
            raise NotImplementedError(
                "chaos event {!r}: hang@N needs the watchdog that turns a "
                "hang into a typed fault, which is not ported yet "
                "(ROADMAP §1 item 8, monitoring/watch).".format(item))
        step_text, _, arg_text = rest.partition(":")
        try:
            step = int(step_text)
            arg = float(arg_text) if arg_text else None
        except ValueError:
            raise ValueError(
                "Malformed chaos event {!r}: step must be an int and "
                "arg a float.".format(item))
        events.append(ChaosEvent(kind, step, arg))
    return events


def _log_event(event, extra=None):
    try:
        from cloud_tpu_torch.utils import events as events_lib

        payload = event.spec()
        if extra:
            payload.update(extra)
        events_lib.log_job_event("graftchaos", payload)
    except Exception:
        logger.debug("graftchaos: job event export failed", exc_info=True)


class ChaosPlan:
    """A set of one-shot injections, checked against the fit loop's step
    counter and against committed checkpoint writes."""

    def __init__(self, events):
        self.events = list(events)

    @classmethod
    def parse(cls, spec):
        return cls(parse_spec(spec))

    def remaining(self):
        """Specs of events that have not fired yet."""
        return [e.spec() for e in self.events if not e.fired]

    def pre_dispatch(self, step, n_steps=1):
        """Fires the step-triggered events in [step, step + n_steps), the
        window the next dispatch will run."""
        if step is None:
            return
        due = [e for e in self.events
               if not e.fired and e.kind not in ("corrupt",) + SERVE_KINDS
               and step <= e.step < step + n_steps]
        for event in sorted(due, key=lambda e: e.step):
            event.fired = True
            self._fire(event)

    @staticmethod
    def _fire(event):
        _log_event(event)
        message = "graftchaos: injected {} before step {}".format(
            event.kind, event.step)
        logger.warning("%s", message)
        if event.kind == "preempt":
            raise resilience.Preemption(message)
        if event.kind == "fetch":
            raise resilience.DataStall(message + " (transient fetch error)")
        if event.kind == "nan":
            raise resilience.NaNLoss(message)

    def notify_checkpoint(self, path, step):
        """Called by checkpoint.save after a write; fires any pending
        `corrupt` event whose threshold the save reached."""
        due = [e for e in self.events
               if not e.fired and e.kind == "corrupt" and step >= e.step]
        for event in due:
            if self._truncate(path):
                event.fired = True
                _log_event(event, extra={"path": str(path),
                                         "checkpoint_step": step})

    @staticmethod
    def _truncate(path):
        """Truncates the largest file under checkpoint `path` to half its
        size (a torn write). Returns False, and the event stays armed,
        when there is nothing to truncate yet (an async save still
        writing)."""
        candidates = []
        if os.path.isfile(path):
            candidates.append((os.path.getsize(path), path))
        elif os.path.isdir(path):
            for root, _, names in os.walk(path):
                for name in names:
                    target = os.path.join(root, name)
                    try:
                        candidates.append((os.path.getsize(target), target))
                    except OSError:
                        continue
        # Largest first, the path as a deterministic tie-break.
        candidates = [c for c in sorted(candidates,
                                        key=lambda c: (-c[0], c[1]))
                      if c[0] > 0]
        if not candidates:
            return False
        size, target = candidates[0]
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        logger.warning("graftchaos: truncated %s (%d -> %d bytes).",
                       target, size, size // 2)
        return True


# One plan per process, surviving in-process retries (a fired event
# stays fired across re-entries).
_plan = None
_env_checked = False


def install(spec):
    """Installs (or with a falsy spec, clears) the active plan. Replaces
    any existing plan and suppresses the one-time CLOUD_TPU_CHAOS
    auto-install."""
    global _plan, _env_checked
    _env_checked = True
    _plan = ChaosPlan.parse(spec) if spec else None
    return _plan


def uninstall():
    """Clears the active plan and re-arms the CLOUD_TPU_CHAOS
    auto-install."""
    global _plan, _env_checked
    _plan = None
    _env_checked = False


def active_plan():
    """The installed plan, auto-installed from CLOUD_TPU_CHAOS on the
    first ask (once: a consumed plan is not re-armed). None when chaos
    is off."""
    global _plan, _env_checked
    if _plan is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get("CLOUD_TPU_CHAOS")
        if spec:
            _plan = ChaosPlan.parse(spec)
            logger.warning("graftchaos: active plan %s.",
                           [e.spec() for e in _plan.events])
    return _plan


def notify_checkpoint(path, step):
    """checkpoint.save's hook: forwards to the active plan, if any."""
    plan = _plan
    if plan is not None:
        plan.notify_checkpoint(path, step)


__all__ = ["ChaosEvent", "ChaosPlan", "KINDS", "SERVE_KINDS", "active_plan",
           "install", "notify_checkpoint", "parse_spec", "uninstall"]
