"""8-bit AdamW: the two moments stored in one byte per element.

Counterpart of ``kubeflow_controller_tpu/ops/optim8.py``: ``adamw8bit``
there is :class:`AdamW8bit` here, with the interface of ``optim.AdamW``: ``init(params)``, then
``update(params, grads)`` applies one step to ``params`` in place and
returns the learning rate it used. Per leaf:

- **m** is int8 with a per-row scale over the LAST axis (abs-max / 127,
  floored at 1e-30);
- **v** is uint8 in log space with a per-row ``(lo, rng)``: codes
  ``round((log(max(v, 1e-30)) - lo) / rng * 255)``, dequantized as
  ``exp(lo + q / 255 * rng)`` with values at or below 2e-30 read as 0;
- leaves of fewer than ``min_quantized_size`` elements keep fp32
  moments.

The learning rate is read at the update count before it is incremented
(a zero-warmup schedule's first step has lr 0) and the bias corrections
use the incremented count; the update is ``-lr * (mhat / (sqrt(vhat) +
eps) + wd * p)``. There is no TPU kernel here: plain PyTorch ops, the
parameters and the codes updated in place.

The JAX package runs this under ``jax.jit``; the port computes what the
jitted step computes, not the eager one (checked on XLA's CPU backend):

- a division by a constant (``/ 127.0``, ``/ 255.0``) is a
  multiplication by its fp32 reciprocal, and ``q / 255 * rng`` is
  ``q * (rng * (1/255))``;
- ``b1 * m + (1 - b1) * g`` is ``fma(1 - b1, g, b1 * m)``, ``b2 * v +
  (1 - b2) * g * g`` is ``fma((1 - b2) * g, g, b2 * v)`` and ``lo + q *
  s`` is ``fma(q, s, lo)``: one rounding each (:func:`_fma`).

So the int8 m codes and their scales agree with the jitted reference bit
for bit; the v codes pass through ``log`` and ``exp``, which round
differently in the two libraries.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Union

import numpy as np
import torch

from kubeflow_controller_tpu_torch.convert import tree_leaves
from kubeflow_controller_tpu_torch.ops.quant import INV_127

_V_FLOOR = 1e-30              # "effectively zero" clamp for the v log code
_INV_255 = float(np.float32(1) / np.float32(255))

Schedule = Callable[[int], float]


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float (a weakly typed constant
    in the JAX package meets its fp32 operands in fp32)."""
    return float(np.float32(x))


def _fma(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * x + y`` rounded once, as XLA's fused multiply-add: the
    product and the sum in float64 (exact product; the sum rounds twice
    only if it falls on an fp32 rounding tie), then fp32."""
    if isinstance(a, torch.Tensor):
        a = a.double()
    return (a * x.double() + y.double()).float()


def _quantize_m(m: torch.Tensor):
    """Signed per-row int8: ``m -> (q int8, scale fp32 [..., 1])``."""
    scale = (m.abs().amax(-1, keepdim=True) * INV_127).clamp_min(_V_FLOOR)
    q = torch.round(m / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_m(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _quantize_v(v: torch.Tensor):
    """Non-negative per-row log-space uint8: ``v -> (q, lo, rng)``."""
    lv = torch.log(v.clamp_min(_V_FLOOR))
    lo = lv.amin(-1, keepdim=True)
    rng = (lv.amax(-1, keepdim=True) - lo).clamp_min(1e-6)
    q = torch.round((lv - lo) / rng * 255.0).clamp_(0, 255).to(torch.uint8)
    return q, lo, rng


def _dequantize_v(q: torch.Tensor, lo: torch.Tensor, rng: torch.Tensor) -> torch.Tensor:
    out = torch.exp(_fma(q.float(), rng * _INV_255, lo))
    # values at (or dequantizing near) the floor are "exactly zero"
    return torch.where(out <= 2 * _V_FLOOR, 0.0, out)


@dataclass
class QLeafM:
    """Quantized first-moment leaf: int8 codes + per-row scale."""
    q: torch.Tensor
    scale: torch.Tensor


@dataclass
class QLeafV:
    """Quantized second-moment leaf: uint8 log-codes + per-row (lo, rng)."""
    q: torch.Tensor
    lo: torch.Tensor
    rng: torch.Tensor


class AdamW8bit:
    """AdamW with 8-bit moment states (1 byte per moment element, not 4)
    over a parameter tree. ``m`` and ``v`` hold one state per leaf in
    ``tree_leaves`` order: a ``QLeafM``/``QLeafV`` for leaves of at least
    ``min_quantized_size`` elements, an fp32 tensor otherwise."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, min_quantized_size: int = 4096):
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda count, v=learning_rate: v))
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.min_quantized_size = min_quantized_size
        self.count = 0
        self.m: List[Union[QLeafM, torch.Tensor]] = []
        self.v: List[Union[QLeafV, torch.Tensor]] = []

    @torch.no_grad()
    def init(self, params) -> None:
        self.count = 0
        self.m, self.v = [], []
        for p in tree_leaves(params):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if p.numel() >= self.min_quantized_size:
                self.m.append(QLeafM(*_quantize_m(zeros)))
                self.v.append(QLeafV(*_quantize_v(zeros)))
            else:
                self.m.append(zeros)
                self.v.append(zeros.clone())

    def state_dict(self) -> dict:
        """The update count and every leaf's moment state, as plain
        tensors (codes and scales of the quantized leaves)."""
        def leaf(x):
            return {"t": x} if isinstance(x, torch.Tensor) else dict(vars(x))

        return {"count": self.count, "m": [leaf(x) for x in self.m],
                "v": [leaf(x) for x in self.v]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Take ``state`` from :meth:`state_dict` (after :meth:`init` on
        parameters of the same shapes), copying into the current
        states."""
        self.count = int(state["count"])
        for mine, saved in itertools.chain(zip(self.m, state["m"]),
                                           zip(self.v, state["v"])):
            if isinstance(mine, torch.Tensor):
                mine.copy_(saved["t"])
            else:
                for name, t in vars(mine).items():
                    t.copy_(saved[name])

    @staticmethod
    def _store(state, new: torch.Tensor, quantize) -> None:
        if isinstance(state, torch.Tensor):
            state.copy_(new)
            return
        for old, fresh in zip(vars(state).values(), quantize(new)):
            old.copy_(fresh)

    @torch.no_grad()
    def update(self, params, grads) -> float:
        """Apply one step in place (``grads`` in ``params``' tree shape);
        returns the learning rate it used."""
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = _f32(self.b1), _f32(self.b2)
        c1 = 1 - float(np.float32(b1) ** np.float32(self.count))
        c2 = 1 - float(np.float32(b2) ** np.float32(self.count))
        for p, g, ms, vs in zip(tree_leaves(params), tree_leaves(grads),
                                self.m, self.v):
            g32 = g.float()
            m = ms if isinstance(ms, torch.Tensor) else _dequantize_m(ms.q, ms.scale)
            v = (vs if isinstance(vs, torch.Tensor)
                 else _dequantize_v(vs.q, vs.lo, vs.rng))
            m = _fma(_f32(1 - self.b1), g32, m * b1)
            v = _fma(g32 * (1 - self.b2), g32, v * b2)
            mhat, vhat = m / c1, v / c2
            u = -lr * (mhat / (torch.sqrt(vhat) + self.eps)
                       + self.wd * p.float())
            p.add_(u.to(p.dtype))
            self._store(ms, m, _quantize_m)
            self._store(vs, v, _quantize_v)
        return lr
