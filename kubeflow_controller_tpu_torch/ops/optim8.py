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

Over a mesh each rank updates its chunk of every leaf, and the per-row
statistics are the whole leaf's, as the JAX package's are under GSPMD:
:meth:`AdamW8bit.place` gives each leaf its whole size (which the
threshold is judged on) and the group that splits its last axis (a leaf
placed ``P(..., "tp")``, or ``w_down``'s ``P(lead, "tp", "fsdp")``), over
which the row statistics are all-reduced: m's abs-max with MAX, log v's
maximum with MAX and its minimum with MIN (one all-reduce a leaf). The
codes follow the parameter's chunk, the statistics its rows
(``parallel/sharding.py:moment_spec``).

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
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

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


def _quantize_m(m: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Signed per-row int8: ``m -> (q int8, scale fp32 [..., 1])``; the
    rows' abs-max is ``amax`` where given (the whole leaf's)."""
    amax = m.abs().amax(-1, keepdim=True) if amax is None else amax
    scale = (amax * INV_127).clamp_min(_V_FLOOR)
    q = torch.round(m / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_m(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _log_v(v: torch.Tensor) -> torch.Tensor:
    return torch.log(v.clamp_min(_V_FLOOR))


def _quantize_v(v: torch.Tensor, lv_range=None):
    """Non-negative per-row log-space uint8: ``v -> (q, lo, rng)``; the
    rows' ``(min, max)`` of ``log v`` are ``lv_range`` where given (the
    whole leaf's)."""
    lv = _log_v(v)
    lo, hi = ((lv.amin(-1, keepdim=True), lv.amax(-1, keepdim=True))
              if lv_range is None else lv_range)
    rng = (hi - lo).clamp_min(1e-6)
    q = torch.round((lv - lo) / rng * 255.0).clamp_(0, 255).to(torch.uint8)
    return q, lo, rng


def _whole_row_stats(m: torch.Tensor, v: torch.Tensor, group):
    """The rows' statistics of the whole leaf whose last axis ``group``
    splits: m's abs-max and ``log v``'s ``(min, max)``, reduced over the
    group in one MAX all-reduce (the minimum negated)."""
    lv = _log_v(v)
    st = torch.cat([m.abs().amax(-1, keepdim=True), lv.amax(-1, keepdim=True),
                    -lv.amin(-1, keepdim=True)], -1)
    dist.all_reduce(st, op=dist.ReduceOp.MAX, group=group)
    return st[..., :1], (-st[..., 2:], st[..., 1:2])


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
        self._sizes: Optional[List[int]] = None
        self._groups: List[object] = []

    def place(self, sizes: Sequence[int], groups: Sequence[object]) -> None:
        """Over a mesh, before :meth:`init` on the chunks: each leaf's
        whole element count (the threshold's size) and the process group
        that splits its last axis (``None`` where this rank holds it
        whole), over which its row statistics are reduced."""
        self._sizes, self._groups = list(sizes), list(groups)

    @torch.no_grad()
    def init(self, params) -> None:
        self.count = 0
        self.m, self.v = [], []
        leaves = tree_leaves(params)
        sizes = self._sizes or [p.numel() for p in leaves]
        for p, size in zip(leaves, sizes):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if size >= self.min_quantized_size:
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
    def _store(state, fresh) -> None:
        for old, new in zip(vars(state).values(), fresh):
            old.copy_(new)

    @torch.no_grad()
    def update(self, params, grads) -> float:
        """Apply one step in place (``grads`` in ``params``' tree shape);
        returns the learning rate it used."""
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = _f32(self.b1), _f32(self.b2)
        c1 = 1 - float(np.float32(b1) ** np.float32(self.count))
        c2 = 1 - float(np.float32(b2) ** np.float32(self.count))
        groups = self._groups or itertools.repeat(None)
        for p, g, ms, vs, group in zip(tree_leaves(params), tree_leaves(grads),
                                       self.m, self.v, groups):
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
            if isinstance(ms, torch.Tensor):
                ms.copy_(m)
                vs.copy_(v)
                continue
            amax, lv_range = (_whole_row_stats(m, v, group) if group is not None
                              else (None, None))
            self._store(ms, _quantize_m(m, amax))
            self._store(vs, _quantize_v(v, lv_range))
        return lr
