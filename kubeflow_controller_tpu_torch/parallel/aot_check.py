"""The memory gate: trace the sharded train step at a target mesh on fake
tensors, without the cards.

Counterpart of ``kubeflow_controller_tpu/parallel/aot_check.py``, which
compiles the JAX train step for a mesh of virtual CPU devices and reads
XLA's per-device memory analysis. Here one process stands in for rank 0
of the mesh, and nothing is allocated on a card or in host memory:

* a process group on torch's fake backend (``FakeStore``: groups are
  made, no collective moves data) at world size = the mesh's product,
  and the port's mesh over it (``parallel/mesh.py``);
* under ``FakeTensorMode``, the decoder's parameters as rank 0's chunks
  (``TrainLoop`` shards a whole tree of empty fakes by ``param_specs``)
  and the AdamW moments of those chunks (``AdamW.init_state``);
* one ``TrainLoop.step`` on rank 0's rows of the global batch, as the
  JAX gate's ``train_step``: the loss (``next_token_loss`` through the
  sharded forward, each layer's weights gathered where it runs), the
  backward, the gradient reduction (``reduce_grad``) and the AdamW
  update, in place. Attention takes the flash kernels' operators
  (``attn_impl="flash"``), whose fakes allocate what the kernels'
  wrappers allocate (``ops/_library.py``), on either device.

A dispatch mode (:class:`LiveBytes`) counts the bytes of the live
storages: ``argument_bytes_per_device`` is the parameters and the
moments (the analytic plan's params + opt_state; AdamW's per-leaf step
counts, 4 bytes each, are left out), ``temp_bytes_per_device`` the peak
above them during the step, ``output_bytes_per_device`` what the step
leaves alive above them when it returns (its metrics: the update is in
place, where the JAX step returns new parameters and moments).
``kernel_ops`` counts the calls of each kernel operator (``kfc::*``),
the launches the step makes on the card. The step sees ``seq``
positions (``seq + 1`` tokens a row, as ``lm.train`` feeds it; the JAX
gate feeds ``seq`` tokens, so its model sees ``seq - 1``).

    python -m kubeflow_controller_tpu_torch.parallel.aot_check \\
        --config llama3_8b --mesh dp=2,fsdp=16,tp=4 --batch 32 --seq 8192

prints one JSON line. The fakes name the card by default (``--device
cuda``, which needs a PyTorch built with CUDA); ``--device cpu`` traces
the same operators' fakes on a machine without one.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import time
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves


def parse_mesh(spec: str) -> Dict[str, int]:
    """``"dp=2,fsdp=16,tp=4"`` -> ``{"dp": 2, "fsdp": 16, "tp": 4}``, as
    the JAX gate parses it."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return axes


class LiveBytes(TorchDispatchMode):
    """Inside the block, every operator's output storage is live until
    it is freed: ``now`` and ``peak`` are their bytes (with those of the
    tensors given to :meth:`add` before), ``ops`` counts the operators
    by name."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0
        self.ops: collections.Counter = collections.Counter()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = n = st.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.name()] += 1
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.add(t)
        return out


def aot_trace_train_step(config_name: str, mesh_axes: Dict[str, int],
                         global_batch: int, seq: int = 0,
                         device: str = "cuda") -> Dict:
    """Trace one AdamW train step of ``config_name`` at ``mesh_axes``
    (axis name -> size) on fake tensors as rank 0 of a fake process
    group; returns the trace's seconds and rank 0's memory (see the
    module's docstring). Raises rather than report no bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch import optim
    from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import model_config
    from kubeflow_controller_tpu_torch.dataplane.train import TrainLoop
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = model_config(config_name, attn_impl="flash")
    seq = seq or cfg.max_seq
    if dist.is_initialized():
        raise RuntimeError("the gate runs in a process without a process group "
                           "(it starts a fake one)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_axes.values()))
    try:
        mesh = make_mesh(MeshConfig(**mesh_axes), device_type=torch.device(device).type)
        shapes = tfm.param_shapes(cfg)
        live = LiveBytes()
        with FakeTensorMode():
            loop = TrainLoop(
                init_fn=lambda seed, dev: tree_unflatten(shapes, [
                    torch.empty(s, dtype=cfg.param_dtype, device=dev)
                    for s in tree_leaves(shapes)]),
                loss_fn=tfm.make_loss_fn(cfg), optimizer=optim.AdamW(1e-3),
                mesh=mesh, param_shardings=tfm.param_specs(cfg), device=device)
            # The moments AdamW makes at its first step, in this rank's
            # chunks' shapes.
            loop.tx.init_state()
            for t in tree_leaves(loop.state.params):
                live.add(t)
            for _, _, t in loop.optimizer_chunks():
                live.add(t)
            argument = live.now
            rows = len(loop.local_rows(global_batch))
            tokens = torch.zeros((rows, seq + 1), dtype=torch.int32, device=loop.device)
            t0 = time.perf_counter()
            with live:
                metrics = loop.step({"tokens": tokens})
                gc.collect()
            trace_s = time.perf_counter() - t0
            output = live.now - argument
            del metrics
    finally:
        dist.destroy_process_group()
    temp = live.peak - argument
    if argument <= 0 or temp <= 0:
        raise RuntimeError(
            f"the trace counted {argument} argument and {temp} temp bytes: "
            "the gate cannot report memory it did not see")
    return {
        "config": config_name,
        "mesh": dict(mesh_axes),
        "global_batch": global_batch,
        "seq": seq,
        "device": device,
        "trace_s": trace_s,
        "argument_bytes_per_device": argument,
        "temp_bytes_per_device": temp,
        "output_bytes_per_device": output,
        "kernel_ops": {k: v for k, v in sorted(live.ops.items())
                       if k.startswith("kfc::")},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama3_8b")
    ap.add_argument("--mesh", default="dp=2,fsdp=16,tp=4")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = aot_trace_train_step(args.config, parse_mesh(args.mesh), args.batch,
                               args.seq, args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
