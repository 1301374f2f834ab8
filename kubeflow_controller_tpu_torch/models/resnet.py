"""ResNet-50 with the reference's BatchNorm, padding and layouts.

Counterpart of ``kubeflow_controller_tpu/models/resnet.py`` (flax). A
:class:`ResNet` has the flax module's two calls: ``init(seed, device)``
draws ``(params, batch_stats)`` and ``apply(params, batch_stats, x,
train)`` maps NHWC images ``[B, H, W, 3]`` (uint8 bytes, normalized in
fp32 on the device, or floats) to fp32 logits, with the new statistics
in train mode. Three choices follow flax, not PyTorch's modules:

* **SAME padding** is flax's: ``total = max((ceil(n/s) - 1) * s + k -
  n, 0)``, ``total // 2`` before and the rest after, so a stride-2 layer
  pads one more row after than before (explicit ``F.pad``; the max pool
  pads with ``-inf``). ``nn.Conv2d(padding=...)`` pads both sides alike.
* **BatchNorm** is flax's: statistics in fp32 whatever the compute dtype,
  the variance by the fast form ``max(E[x^2] - E[x]^2, 0)`` (biased), the
  output ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32, cast
  once; running statistics ``0.9 * ra + 0.1 * batch``, the biased
  variance too (``torch.nn.BatchNorm2d`` keeps the unbiased one).
* **Layouts**: the tree keeps flax's names (``stem``, ``stem_norm``,
  ``BottleneckBlock_<i>/{Conv_0..2, BatchNorm_0..2, proj, proj_norm}``,
  ``head``), with conv kernels OIHW (flax: HWIO;
  ``convert.resnet_params_from_flax`` transposes). Activations run
  NCHW-indexed in ``channels_last`` memory, which is the NHWC bytes.

uint8 images are normalized as the jitted reference normalizes them
(``models/mnist.py:_normalize``).

Convolutions are ``F.conv2d`` and the head a plain product: XLA computes
them in the JAX package, with no Pallas kernel behind them.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models.mnist import _normalize, lecun_normal

IMAGE_SIZE = 224
NUM_CLASSES = 1000
BN_MOMENTUM = 0.9
BN_EPS = 1e-5

Tree = Dict[str, Dict]


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's SAME padding of one spatial axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``x`` [B, C, H, W] by an OIHW kernel with flax's SAME padding;
    symmetric padding goes to the convolution itself, asymmetric through
    ``F.pad`` first."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], w.shape[2], stride),
                          same_pads(x.shape[3], w.shape[3], stride))
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: the pad
    cells hold ``-inf``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor], train: bool
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """flax ``nn.BatchNorm`` over the channel axis 1 (module docstring);
    returns the output in ``x``'s dtype and, in train mode, the new
    running statistics (detached)."""
    shape = (1, -1, 1, 1)
    if train:
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        new = {"mean": BN_MOMENTUM * stats["mean"]
               + (1 - BN_MOMENTUM) * mean.detach(),
               "var": BN_MOMENTUM * stats["var"]
               + (1 - BN_MOMENTUM) * var.detach()}
    else:
        mean, var, new = stats["mean"], stats["var"], None
    mul = torch.rsqrt(var + BN_EPS) * p["scale"]
    y = (x.float() - mean.view(shape)) * mul.view(shape) + p["bias"].view(shape)
    return y.to(x.dtype), new


class ResNet:
    """Bottleneck ResNet: stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool),
    ``stage_sizes`` blocks per stage (the first of each later stage at
    stride 2, a ``proj`` 1x1 conv where the residual changes shape), mean
    pool and a dense head in fp32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, num_classes: int = NUM_CLASSES,
                 dtype: torch.dtype = torch.bfloat16):
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.num_classes = num_classes
        self.dtype = dtype

    def blocks(self):
        """(name, filters, stride, has proj) of every block, in order."""
        out, cin, n = [], self.width, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                f = self.width * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                out.append((f"BottleneckBlock_{n}", f, stride,
                            stride != 1 or cin != 4 * f))
                cin = 4 * f
                n += 1
        return out

    def init(self, seed: int = 0, device: DeviceLike = None
             ) -> Tuple[Tree, Tree]:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def conv(cin, cout, k):
            return {"kernel": lecun_normal((cout, cin, k, k), cin * k * k,
                                           gen, dev)}

        def norm(c, zero=False):
            scale = (torch.zeros if zero else torch.ones)(c, device=dev)
            return ({"scale": scale, "bias": torch.zeros(c, device=dev)},
                    {"mean": torch.zeros(c, device=dev),
                     "var": torch.ones(c, device=dev)})

        params: Tree = {"stem": conv(3, self.width, 7)}
        stats: Tree = {}
        params["stem_norm"], stats["stem_norm"] = norm(self.width)
        cin = self.width
        for name, f, _, proj in self.blocks():
            bp, bs = {}, {}
            for idx, (ci, co, k) in enumerate(((cin, f, 1), (f, f, 3),
                                               (f, 4 * f, 1))):
                bp[f"Conv_{idx}"] = conv(ci, co, k)
                bp[f"BatchNorm_{idx}"], bs[f"BatchNorm_{idx}"] = norm(
                    co, zero=idx == 2)
            if proj:
                bp["proj"] = conv(cin, 4 * f, 1)
                bp["proj_norm"], bs["proj_norm"] = norm(4 * f)
            params[name], stats[name] = bp, bs
            cin = 4 * f
        params["head"] = {
            "kernel": lecun_normal((cin, self.num_classes), cin, gen, dev),
            "bias": torch.zeros(self.num_classes, device=dev)}
        return params, stats

    def apply(self, params: Tree, batch_stats: Tree, x: torch.Tensor,
              train: bool = True) -> Tuple[torch.Tensor, Optional[Tree]]:
        """NHWC images -> (fp32 logits ``[B, classes]``, the new batch
        statistics in train mode, else None)."""
        dt = self.dtype
        new: Tree = {}
        x = x.permute(0, 3, 1, 2)                 # NCHW view, NHWC bytes
        # Bytes are normalized in fp32 before the cast (bf16 would
        # quantize the pixel range), as the jitted reference does.
        x = _normalize(x).to(dt).contiguous(memory_format=torch.channels_last)

        def norm(name, y, p, s, out):
            y, upd = batch_norm(y, p[name], s[name], train)
            if upd is not None:
                out[name] = upd
            return y

        x = conv_same(x, params["stem"]["kernel"].to(dt), 2)
        x = F.relu(norm("stem_norm", x, params, batch_stats, new))
        x = max_pool_same(x)
        for name, _, stride, proj in self.blocks():
            bp, bs, bn = params[name], batch_stats[name], {}
            y = x
            for idx in range(3):
                y = conv_same(y, bp[f"Conv_{idx}"]["kernel"].to(dt),
                              stride if idx == 1 else 1)
                y = norm(f"BatchNorm_{idx}", y, bp, bs, bn)
                if idx < 2:
                    y = F.relu(y)
            residual = x
            if proj:
                residual = conv_same(x, bp["proj"]["kernel"].to(dt), stride)
                residual = norm("proj_norm", residual, bp, bs, bn)
            x = F.relu(residual + y)
            if bn:
                new[name] = bn
        x = x.mean((2, 3))
        logits = x.float() @ params["head"]["kernel"] + params["head"]["bias"]
        return logits, (new if train else None)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet_tiny(**kw) -> ResNet:
    """Test scale: one block per stage, 8 wide, fp32."""
    kw.setdefault("dtype", torch.float32)
    return ResNet(stage_sizes=(1, 1), width=8, num_classes=10, **kw)


def synthetic_imagenet(
    batch_size: int, image_size: int = IMAGE_SIZE,
    num_classes: int = NUM_CLASSES, seed: int = 0, uint8: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX package's ImageNet-shaped stream, draw for draw:
    ``[B, size, size, 3]`` images (bytes with ``uint8``, else standard
    normal fp32) and int32 labels."""
    rng = np.random.default_rng(seed)
    while True:
        if uint8:
            img = rng.integers(0, 256, (batch_size, image_size, image_size, 3),
                               dtype=np.uint8)
        else:
            img = rng.standard_normal(
                (batch_size, image_size, image_size, 3)).astype(np.float32)
        yield {"image": img,
               "label": rng.integers(0, num_classes, (batch_size,)).astype(np.int32)}


def make_init_fn(model: ResNet):
    """``init_fn(seed, device) -> (params, batch_stats)`` for a stateful
    ``TrainLoop``."""
    def init_fn(seed, device):
        return model.init(seed, device)

    return init_fn


def make_loss_fn(model: ResNet):
    """Stateful loss: ``(params, batch_stats, batch) -> (cross entropy,
    ({"accuracy"}, new batch_stats))``."""
    def loss_fn(params, model_state, batch):
        logits, updated = model.apply(params, model_state, batch["image"],
                                      train=True)
        labels = batch["label"].long()
        loss = -torch.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, ({"accuracy": acc}, updated)

    return loss_fn
