"""MNIST models and data: the softmax regression and the one-hidden-layer
MLP, the synthetic teacher stream and the idx files.

Counterpart of ``kubeflow_controller_tpu/models/mnist.py``. A model is a
small object with the flax module's two calls: ``init(seed, device)``
draws its parameter tree and ``apply(params, x)`` maps images ``[B,
784]`` (uint8 bytes, normalized on the device, or floats) to fp32
logits. The tree keeps flax's layout, ``{"hid": {"kernel": [784, H],
"bias": [H]}, "sm": {...}}`` with ``x @ kernel + bias``, so
``convert.mnist_params_from_flax`` carries the JAX package's weights
across unchanged. The data helpers are numpy, copied from the JAX
module, draw for draw and byte for byte.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

IMAGE_DIM = 784  # 28*28
NUM_CLASSES = 10
HIDDEN_UNITS = 128

Params = Dict[str, Dict[str, torch.Tensor]]


#: fp32(1 / 127.5). The JAX package trains under ``jit``, where XLA turns
#: its ``x / 127.5 - 1`` into ``x * fp32(1 / 127.5) - 1`` contracted into
#: one FMA.
_INV_127_5 = float(np.float32(1 / 127.5))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] fp32 on the device, bit for bit the jitted
    JAX package's FMA ``x * fp32(1/127.5) - 1``: in float64 the product
    of 8 and 24 significant bits and the subtraction are exact, so the
    one rounding is the cast to fp32, on either device. Floats pass
    through."""
    if x.dtype == torch.uint8:
        return (x.double() * _INV_127_5 - 1.0).float()
    return x


def lecun_normal(shape, fan_in: int, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """flax's default kernel init: a normal truncated to two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=gen).mul_(std)


def dense_init(d_in: int, d_out: int, gen: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    return {"kernel": lecun_normal((d_in, d_out), d_in, gen, device),
            "bias": torch.zeros(d_out, device=device)}


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _generator(seed: int, device: DeviceLike):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen, dev


class SoftmaxRegression:
    """One dense layer, ``softmax``: the reference's local example."""

    def init(self, seed: int = 0, device: DeviceLike = None) -> Params:
        gen, dev = _generator(seed, device)
        return {"softmax": dense_init(IMAGE_DIM, NUM_CLASSES, gen, dev)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return dense(params["softmax"], _normalize(x))


class MnistMLP:
    """Dense ``hid`` (``hidden`` units), tanh-approximated GELU (flax's
    ``nn.gelu``), dense ``sm`` to the ten classes."""

    def __init__(self, hidden: int = HIDDEN_UNITS):
        self.hidden = hidden

    def init(self, seed: int = 0, device: DeviceLike = None) -> Params:
        gen, dev = _generator(seed, device)
        return {"hid": dense_init(IMAGE_DIM, self.hidden, gen, dev),
                "sm": dense_init(self.hidden, NUM_CLASSES, gen, dev)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(params["hid"], _normalize(x)), approximate="tanh")
        return dense(params["sm"], h)


def synthetic_mnist(
    batch_size: int, seed: int = 0, teacher_seed: int = 1234,
    uint8: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX package's synthetic classification stream shaped like
    MNIST, draw for draw: a teacher drawn from ``teacher_seed`` labels
    samples drawn from ``seed`` (another seed is a held-out split of the
    same task). ``uint8=True`` emits byte images."""
    teacher = (
        np.random.default_rng(teacher_seed)
        .standard_normal((IMAGE_DIM, NUM_CLASSES))
        .astype(np.float32)
    )
    rng = np.random.default_rng(seed)
    while True:
        if uint8:
            xb = rng.integers(0, 256, (batch_size, IMAGE_DIM), dtype=np.uint8)
            x = xb.astype(np.float32) / 127.5 - 1.0
        else:
            x = rng.standard_normal((batch_size, IMAGE_DIM)).astype(np.float32)
            xb = x
        logits = x @ teacher + 0.5 * rng.standard_normal(
            (batch_size, NUM_CLASSES)
        ).astype(np.float32)
        y = logits.argmax(-1).astype(np.int32)
        yield {"image": xb, "label": y}


# -- idx files (the canonical MNIST wire format) -----------------------------

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}


def load_idx(path: str) -> np.ndarray:
    """Read one idx file (``.gz`` transparent): big-endian magic, dims,
    data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or data[0] != 0 or data[1] != 0:
        raise ValueError(f"{path}: not an idx file (bad magic)")
    dtype = _IDX_DTYPES.get(data[2])
    if dtype is None:
        raise ValueError(f"{path}: unknown idx dtype byte 0x{data[2]:02x}")
    ndim = data[3]
    header = 4 + 4 * ndim
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big")
            for i in range(ndim)]
    arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(">"),
                        offset=header)
    expect = int(np.prod(dims)) if dims else 0
    if arr.size != expect:
        raise ValueError(
            f"{path}: payload {arr.size} elements, header says {expect}")
    return arr.reshape(dims).astype(dtype)


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write an array as an idx file (``.gz`` transparent), the inverse
    of :func:`load_idx`."""
    code = {v: k for k, v in _IDX_DTYPES.items()}[np.dtype(arr.dtype).type]
    header = bytes([0, 0, code, arr.ndim])
    for dim in arr.shape:
        header += int(dim).to_bytes(4, "big")
    payload = header + np.ascontiguousarray(
        arr, dtype=np.dtype(arr.dtype).newbyteorder(">")).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


_IDX_NAMES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte",
                    "test-images-idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte",
                    "test-labels-idx1-ubyte"),
}


def _find_idx(data_dir: str, key: str) -> Optional[str]:
    """One logical idx file's path (its canonical names, plain or
    ``.gz``), or None."""
    for name in _IDX_NAMES[key]:
        for candidate in (name, name + ".gz"):
            path = os.path.join(data_dir, candidate)
            if os.path.exists(path):
                return path
    return None


def has_idx_data(data_dir: str) -> bool:
    """True if ``data_dir`` holds at least the two training idx files."""
    if not data_dir or not os.path.isdir(data_dir):
        return False
    return all(_find_idx(data_dir, key) is not None
               for key in ("train_images", "train_labels"))


def mnist_from_data_dir(data_dir: str) -> Dict[str, np.ndarray]:
    """The canonical MNIST idx files of ``data_dir``: images flattened to
    ``[N, 784]`` uint8, labels int32; the test split may be absent."""
    out: Dict[str, np.ndarray] = {}
    for key, names in _IDX_NAMES.items():
        path = _find_idx(data_dir, key)
        if path is None:
            if key.startswith("train"):
                raise FileNotFoundError(
                    f"{data_dir}: no {names[0]}[.gz] (canonical MNIST idx "
                    "layout)")
            continue
        arr = load_idx(path)
        if key.endswith("images"):
            arr = arr.reshape(arr.shape[0], -1).astype(np.uint8)
        else:
            arr = arr.astype(np.int32)
        out[key] = arr
    for split in ("train", "test"):
        imgs, labels = out.get(f"{split}_images"), out.get(f"{split}_labels")
        if imgs is not None and labels is not None and len(imgs) != len(labels):
            raise ValueError(
                f"{data_dir}: {split} images/labels length mismatch "
                f"({len(imgs)} vs {len(labels)})")
    return out


def idx_batches(
    images: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epochs over real data, uint8 images on the wire,
    reshuffled every epoch (the JAX package's order)."""
    n = len(images)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield {"image": images[idx],
                   "label": labels[idx].astype(np.int32)}


def _metrics(logits: torch.Tensor, labels: torch.Tensor):
    xent = -torch.log_softmax(logits, -1).gather(
        -1, labels.long()[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return xent, acc


def make_loss_fn(model):
    """``loss_fn(params, batch) -> (cross entropy, {"accuracy"})``."""
    def loss_fn(params, batch):
        xent, acc = _metrics(model.apply(params, batch["image"]), batch["label"])
        return xent, {"accuracy": acc}

    return loss_fn


def make_eval_fn(model):
    """``eval_fn(params, batch) -> {"cross_entropy", "accuracy"}``."""
    def eval_fn(params, batch):
        xent, acc = _metrics(model.apply(params, batch["image"]), batch["label"])
        return {"cross_entropy": xent, "accuracy": acc}

    return eval_fn


def make_init_fn(model):
    """``init_fn(seed, device) -> params`` for ``TrainLoop``."""
    def init_fn(seed, device):
        return model.init(seed, device)

    return init_fn
