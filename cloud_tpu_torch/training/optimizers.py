"""The optimizers of `cloud_tpu/training/trainer.py:203-212` that
`torch.optim` has no faithful counterpart for, at optax's defaults and
with optax's arithmetic: `RMSprop` (optax.rmsprop), `Adagrad`
(optax.adagrad), `Adafactor` (optax.adafactor), `Lamb` (optax.lamb) and
`Lion` (optax.lion).

`torch.optim`'s RMSprop puts eps outside the square root and decays at
0.99, its Adagrad starts the accumulator at 0 and adds eps outside the
root, and its Adafactor has another decay schedule, no update clipping
and no parameter scale; Lamb and Lion are not in `torch.optim`.

Each is a `torch.optim.Optimizer` whose state is made when it is built
(not at the first step), holds only tensors (so it goes through
`torch.save` / `weights_only=True` loads and a checkpoint restore), and
whose `step()` is tensor operations alone, with no read back to the
host: the step counter is a device tensor, and the learning rate may be
a float or a 0-d device tensor (what a captured CUDA graph of the train
step reads). Updates are applied as optax does, p <- p + (-lr * u).
"""

import numpy as np
import torch


def _apply(params, updates, lr):
    """p <- p - (lr * u) over the lists (the product rounded first, as
    optax's scale, then apply_updates), lr a float or a 0-d tensor:
    the two give the same bits."""
    torch._foreach_mul_(updates, lr)
    torch._foreach_sub_(params, updates)


class _Optimizer(torch.optim.Optimizer):
    """Shared shape: the state of every parameter is made at build time
    by `_init_state`; `step()` gathers each group's parameters that
    have a gradient and calls `_update(group, params, grads, states)`."""

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._init_state(p, group)

    def _init_state(self, p, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params, grads, states = [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                params.append(p)
                grads.append(p.grad)
                states.append(self.state[p])
            if params:
                self._update(group, params, grads, states)
        return loss


class RMSprop(_Optimizer):
    """optax.rmsprop: nu <- (1 - decay) g^2 + decay nu (nu_0 =
    initial_scale), u = g / sqrt(nu + eps), eps inside the root."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8,
                 initial_scale=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    def _init_state(self, p, group):
        return {"nu": torch.full_like(p, group["initial_scale"],
                                      memory_format=torch.preserve_format)}

    def _update(self, group, params, grads, states):
        decay = group["decay"]
        nus = [s["nu"] for s in states]
        torch._foreach_mul_(nus, decay)
        torch._foreach_add_(nus, torch._foreach_mul(grads, grads),
                            alpha=1.0 - decay)
        scale = torch._foreach_add(nus, group["eps"])
        torch._foreach_rsqrt_(scale)
        _apply(params, torch._foreach_mul(grads, scale), group["lr"])


class Adagrad(_Optimizer):
    """optax.adagrad: s <- s + g^2 (s_0 = initial_accumulator_value),
    u = g / sqrt(s + eps), eps inside the root."""

    def __init__(self, params, lr=1e-2, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(
            p, group["initial_accumulator_value"],
            memory_format=torch.preserve_format)}

    def _update(self, group, params, grads, states):
        sums = [s["sum_of_squares"] for s in states]
        torch._foreach_addcmul_(sums, grads, grads)
        scale = torch._foreach_add(sums, group["eps"])
        torch._foreach_rsqrt_(scale)
        # optax zeroes the scale where s == 0; s >= its positive start,
        # or (from a zero start) g == 0 there, so the update is 0 either
        # way.
        _apply(params, torch._foreach_mul(grads, scale), group["lr"])


class Lion(_Optimizer):
    """optax.lion: u = sign((1 - b1) g + b1 m) + weight_decay p, then
    m <- (1 - b2) g + b2 m."""

    def __init__(self, params, lr=1e-4, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p,
                                       memory_format=torch.preserve_format)}

    def _update(self, group, params, grads, states):
        b1, b2 = group["b1"], group["b2"]
        mus = [s["mu"] for s in states]
        updates = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(updates, torch._foreach_mul(mus, b1))
        torch._foreach_sign_(updates)
        torch._foreach_mul_(mus, b2)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b2))
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        _apply(params, updates, group["lr"])


class Lamb(_Optimizer):
    """optax.lamb: Adam's bias-corrected direction m_hat / (sqrt(v_hat)
    + eps) (eps 1e-6), plus weight_decay p, scaled per tensor by the
    trust ratio ||p|| / ||u|| (1 where either norm is 0)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group):
        zeros = lambda: torch.zeros_like(
            p, memory_format=torch.preserve_format)
        return {"count": torch.zeros((), dtype=torch.float32,
                                     device=p.device),
                "mu": zeros(), "nu": zeros()}

    def _update(self, group, params, grads, states):
        b1, b2 = group["b1"], group["b2"]
        mus = [s["mu"] for s in states]
        nus = [s["nu"] for s in states]
        counts = [s["count"] for s in states]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(grads, grads),
                            alpha=1.0 - b2)
        torch._foreach_add_(counts, 1.0)
        count = counts[0]
        mu_hat = torch._foreach_div(mus, 1.0 - torch.pow(b1, count))
        nu_hat = torch._foreach_div(nus, 1.0 - torch.pow(b2, count))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, group["eps"])
        updates = torch._foreach_div(mu_hat, nu_hat)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        p_norms = torch.stack(torch._foreach_norm(params))
        u_norms = torch.stack(torch._foreach_norm(updates))
        ratios = torch.where((p_norms == 0) | (u_norms == 0),
                             torch.ones_like(p_norms), p_norms / u_norms)
        for u, r in zip(updates, ratios.unbind()):
            u.mul_(r)
        _apply(params, updates, group["lr"])


def factored_dims(shape, min_dim_size_to_factor=128):
    """optax's `_factored_dims`: the two largest axes (d1, d0) to reduce
    over, or None when the tensor is 1-D or its second-largest axis is
    shorter than `min_dim_size_to_factor`."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Optimizer):
    """optax.adafactor at its defaults: second moments factored into row
    and column means for tensors whose two largest axes are >= 128
    (else a full one), decayed at 1 - (t + 1)^-0.8 at step t, on g^2 +
    1e-30; the update g / sqrt(v) clipped to block RMS 1; times the
    learning rate when one is given (`lr=None`, optax's default, applies
    none: the step is relative to the parameter's scale alone); times
    max(rms(p), 1e-3); then subtracted."""

    def __init__(self, params, lr=None, min_dim_size_to_factor=128,
                 decay_rate=0.8, clipping_threshold=1.0,
                 multiply_by_parameter_scale=True, eps=1e-30):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, clipping_threshold=clipping_threshold,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            eps=eps))

    def _init_state(self, p, group):
        state = {"count": torch.zeros((), dtype=torch.float32,
                                      device=p.device)}
        dims = factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return state

    def _update(self, group, params, grads, states):
        count = states[0]["count"]
        decay = 1.0 - (count + 1.0).pow(-group["decay_rate"])
        updates = []
        for p, g, s in zip(params, grads, states):
            grad_sqr = g * g + group["eps"]
            dims = factored_dims(tuple(p.shape),
                                 group["min_dim_size_to_factor"])
            if dims is None:
                s["v"].copy_(decay * s["v"] + (1.0 - decay) * grad_sqr)
                u = g * s["v"].pow(-0.5)
            else:
                d1, d0 = dims
                s["v_row"].copy_(decay * s["v_row"] + (1.0 - decay)
                                 * grad_sqr.mean(dim=d0))
                s["v_col"].copy_(decay * s["v_col"] + (1.0 - decay)
                                 * grad_sqr.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = s["v_row"].mean(dim=reduced_d1, keepdim=True)
                row_factor = (s["v_row"] / row_col_mean).pow(-0.5)
                col_factor = s["v_col"].pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            threshold = group["clipping_threshold"]
            if threshold is not None:
                rms = u.square().mean().sqrt()
                u = u / torch.clamp(rms / threshold, min=1.0)
            lr = group["lr"]
            if lr is not None:
                u = u * lr
            if group["multiply_by_parameter_scale"]:
                p_rms = p.square().mean().sqrt()
                u = u * torch.where(p_rms <= 1e-3,
                                    torch.full_like(p_rms, 1e-3), p_rms)
            updates.append(u)
        torch._foreach_add_([s["count"] for s in states], 1.0)
        torch._foreach_sub_(params, updates)


__all__ = ["Adafactor", "Adagrad", "Lamb", "Lion", "RMSprop",
           "factored_dims"]
