"""The trainer's optimizers as optax computes them: `optax.adam`, `adamw`,
`sgd` and `rmsprop` with optax's option names and defaults, on `_foreach`
ops, with no host read.

An update is `p += u * (-lr)`, `u` being optax's update before its
learning-rate scale, in optax's order of operations. A param group's "lr"
is a float or a 0-dim tensor on the parameters' device: the trainer looks
the schedule up on the device, so the count that drives it can be restored
with the rest of the state after a skipped update. Each optimizer creates
its state with itself, at optax's initial values, so the trainer's NaN-skip
restores every state tensor to a value it had.

Each parameter's state holds its own `step` (float32, on its device) where
optax keeps one count for the tree: all advance together.
"""

from __future__ import annotations

import torch


class _OptaxLike(torch.optim.Optimizer):
    """Shared skeleton: `init_state(p, group)` -> dict of tensors,
    `update(group, params, grads, states)` -> the list of updates `u`, and
    `after_lr(group, states, updates)` for what optax chains after the lr
    scale."""

    def __init__(self, params, lr, **defaults):
        super().__init__(params, {"lr": lr, **defaults})
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(self.init_state(p, group))

    def init_state(self, p, group) -> dict:
        raise NotImplementedError

    def update(self, group, params, grads, states) -> list:
        raise NotImplementedError

    def after_lr(self, group, states, updates) -> list:
        return updates

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            updates = self.update(group, params, grads, states)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, self.after_lr(group, states, updates))
        return loss


def _count(states) -> torch.Tensor:
    """Every parameter's `step` advanced by one; returns the first (they
    are all equal)."""
    steps = [s["step"] for s in states]
    torch._foreach_add_(steps, 1.0)
    return steps[0]


def _bias_correction(moments, decay: float, step: torch.Tensor) -> list:
    """moment / (1 - decay ** step), as optax's `bias_correction` (one
    0-dim divisor: one kernel for the list)."""
    return torch._foreach_div(moments, 1.0 - torch.pow(decay, step))


def _moment(moments, grads, decay: float, order: int) -> None:
    """moment = (1 - decay) * g**order + decay * moment, in place."""
    torch._foreach_mul_(moments, decay)
    if order == 1:
        torch._foreach_add_(moments, grads, alpha=1.0 - decay)
    else:
        torch._foreach_addcmul_(moments, grads, grads, value=1.0 - decay)


def _trace(traces, updates, decay: float, nesterov: bool) -> list:
    """optax's `trace`: t = u + decay * t; the update is t, or u + decay * t
    with `nesterov`."""
    torch._foreach_mul_(traces, decay)
    torch._foreach_add_(traces, updates)
    if nesterov:
        return torch._foreach_add(updates, traces, alpha=decay)
    return [t.clone() for t in traces]


def _zeros(p) -> torch.Tensor:
    return torch.zeros_like(p, memory_format=torch.preserve_format)


def _step(p) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=p.device)


class Adam(_OptaxLike):
    """`optax.adam` (and with `weight_decay`, `optax.adamw`): mu and nu
    moments, bias-corrected, u = mu_hat / (sqrt(nu_hat + eps_root) + eps)
    [+ weight_decay * p]."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay)

    def init_state(self, p, group) -> dict:
        return {"step": _step(p), "exp_avg": _zeros(p), "exp_avg_sq": _zeros(p)}

    def update(self, group, params, grads, states) -> list:
        mu = [s["exp_avg"] for s in states]
        nu = [s["exp_avg_sq"] for s in states]
        _moment(mu, grads, group["b1"], 1)
        _moment(nu, grads, group["b2"], 2)
        step = _count(states)
        mu_hat = _bias_correction(mu, group["b1"], step)
        nu_hat = _bias_correction(nu, group["b2"], step)
        if group["eps_root"]:
            torch._foreach_add_(nu_hat, group["eps_root"])
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, group["eps"])
        torch._foreach_div_(mu_hat, nu_hat)
        if group["weight_decay"]:
            torch._foreach_add_(mu_hat, params, alpha=group["weight_decay"])
        return mu_hat


class AdamW(Adam):
    """`optax.adamw`: Adam plus `weight_decay * p` before the lr (optax's
    default 1e-4)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
        super().__init__(params, lr, b1, b2, eps, eps_root, weight_decay)


class SGD(_OptaxLike):
    """`optax.sgd`: u = g, or optax's `trace` of g with `momentum`."""

    def __init__(self, params, lr, momentum=None, nesterov=False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def init_state(self, p, group) -> dict:
        return {"step": _step(p)} | ({} if group["momentum"] is None else {"trace": _zeros(p)})

    def update(self, group, params, grads, states) -> list:
        _count(states)
        if group["momentum"] is None:
            return [g.clone() for g in grads]
        return _trace([s["trace"] for s in states], grads, group["momentum"], group["nesterov"])


class RMSprop(_OptaxLike):
    """`optax.rmsprop`: nu = decay * nu + (1 - decay) g^2 from
    `initial_scale`, u = g / sqrt(nu + eps) (`eps_in_sqrt`, optax's default;
    else g / (sqrt(nu) + eps)); `centered` subtracts the squared mean
    gradient, `bias_correction` divides by 1 - decay^step; `momentum` traces
    the update after the lr, as optax chains it."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                 centered=False, momentum=None, nesterov=False, bias_correction=False):
        super().__init__(params, lr, decay=decay, eps=eps, initial_scale=initial_scale,
                         eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
                         nesterov=nesterov, bias_correction=bias_correction)

    def init_state(self, p, group) -> dict:
        state = {"step": _step(p), "square_avg": torch.full_like(p, group["initial_scale"])}
        if group["centered"]:
            state["grad_avg"] = _zeros(p)
        if group["momentum"] is not None:
            state["trace"] = _zeros(p)
        return state

    def update(self, group, params, grads, states) -> list:
        decay = group["decay"]
        nu = [s["square_avg"] for s in states]
        _moment(nu, grads, decay, 2)
        step = _count(states)
        nu_hat = _bias_correction(nu, decay, step) if group["bias_correction"] else nu
        if group["centered"]:
            mu = [s["grad_avg"] for s in states]
            _moment(mu, grads, decay, 1)
            mu_hat = _bias_correction(mu, decay, step) if group["bias_correction"] else mu
            denom = torch._foreach_sub(nu_hat, torch._foreach_mul(mu_hat, mu_hat))
        else:
            denom = [n.clone() for n in nu_hat]
        if group["eps_in_sqrt"]:
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_rsqrt_(denom)
            updates = torch._foreach_mul(grads, denom)
        else:
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(grads, denom)
        return updates

    def after_lr(self, group, states, updates) -> list:
        if group["momentum"] is None:
            return updates
        return _trace([s["trace"] for s in states], updates, group["momentum"], group["nesterov"])


OPTIMIZERS = {"adam": Adam, "adamw": AdamW, "sgd": SGD, "rmsprop": RMSprop}
