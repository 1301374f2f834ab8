"""AdamW and the warmup-cosine learning-rate schedule, as optax computes them.

Counterpart of the optimizer ``kubeflow_controller_tpu/dataplane/
entrypoints/lm.py:_make_optimizer`` builds: ``optax.adamw(sched, b1=0.9,
b2=0.95, weight_decay=0.1)`` under ``optax.warmup_cosine_decay_schedule(
0.0, lr, min(200, total // 10 + 1), total)``. The two packages take the
same steps from the same gradients, up to rounding:

* the schedule is read at the update count *before* it is incremented
  (the first update has the schedule's value at 0 — zero under warmup);
* the moments are ``mu = b1 * mu + (1 - b1) * g`` and ``nu = b2 * nu +
  (1 - b2) * g²``, bias-corrected with the incremented count;
* the update is ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``, with
  weight decay on every leaf (norms and embedding included).

PyTorch's own fused AdamW does the update; there is no TPU kernel here
to port. ``make_optimizer(..., opt8bit=True)`` returns the 8-bit-moment
AdamW of ``ops/optim8.py`` under the same schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from kubeflow_controller_tpu_torch.convert import tree_leaves
from kubeflow_controller_tpu_torch.ops.optim8 import AdamW8bit

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int,
    decay_steps: int, end_value: float = 0.0, exponent: float = 1.0,
) -> Schedule:
    """Linear warmup to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (counted from 0, warmup
    included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


class AdamW:
    """optax's ``adamw`` over a parameter tree (nested dicts of tensors):
    ``torch.optim.AdamW`` with one parameter group and ``fused=True`` (one
    pass over each leaf), its learning rate set by a ``LambdaLR`` from
    ``learning_rate``, a float or a schedule of the update count. The
    scheduler sets the rate for count ``n`` before update ``n + 1`` runs,
    as optax reads its count before incrementing it. ``torch.optim.AdamW``
    decays ``p`` by ``lr * wd * p`` and bias-corrects the moments as optax
    does, so the two take the same step up to rounding."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda count, v=learning_rate: v))
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.opt: Optional[torch.optim.AdamW] = None
        self.sched: Optional[torch.optim.lr_scheduler.LambdaLR] = None

    def init(self, params) -> None:
        self.opt = torch.optim.AdamW(
            tree_leaves(params), lr=1.0, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.wd, fused=True)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, self.lr)

    @torch.no_grad()
    def update(self, params, grads) -> float:
        """Apply one step in place (``grads`` in ``params``' tree shape);
        returns the learning rate it used."""
        lr = self.opt.param_groups[0]["lr"]
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.sched.step()
        return lr

    def state_dict(self) -> dict:
        """The moments and update count of every leaf, and the count the
        schedule is at."""
        return {"opt": self.opt.state_dict(), "count": self.sched.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        """Take ``state`` from :meth:`state_dict` (after :meth:`init` on
        parameters of the same shapes). The learning rate is read again
        from this optimizer's schedule at the restored count, as optax
        reads its schedule at the count in its state."""
        self.opt.load_state_dict(state["opt"])
        count = int(state["count"])
        self.sched.last_epoch = count
        lr = self.lr(count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.sched._last_lr = [lr]


def make_optimizer(learning_rate: float, total_steps: int,
                   opt8bit: bool = False) -> Union[AdamW, AdamW8bit]:
    """The LM entry point's optimizer (``lm._make_optimizer``): AdamW, or
    with ``opt8bit`` the 8-bit-moment ``AdamW8bit``, both ``b1=0.9,
    b2=0.95, weight_decay=0.1`` under the warmup-cosine schedule."""
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, min(200, total_steps // 10 + 1), total_steps)
    if opt8bit:
        return AdamW8bit(sched, b1=0.9, b2=0.95, weight_decay=0.1)
    return AdamW(sched, b1=0.9, b2=0.95, weight_decay=0.1)
