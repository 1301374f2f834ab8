"""Distributed bootstrap from the controller's env.

Counterpart of ``kubeflow_controller_tpu/dataplane/dist.py``, the data
plane's half of the contract whose control-plane half is
``tpu/naming.py:coordinator_env``: each gang member reads its identity
(:class:`ProcessContext`) from the env, and :func:`initialize_from_env`
brings up ``torch.distributed`` over the coordinator's address for a
multi-process job (one process per GPU), as the JAX package calls
``jax.distributed.initialize``. A single-process job creates no
process group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist


@dataclass
class ProcessContext:
    """This process's identity within a job, parsed from env."""

    job_name: str = ""
    runtime_id: str = ""
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    slice_id: int = 0
    host_id: int = 0
    num_slices: int = 1
    accelerator_type: str = ""
    data_dir: str = ""
    model_dir: str = ""
    log_dir: str = ""
    export_dir: str = ""

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "ProcessContext":
        e = env if env is not None else os.environ
        return cls(
            job_name=e.get("TPUJOB_NAME", ""),
            runtime_id=e.get("TPUJOB_RUNTIME_ID", ""),
            coordinator_address=e.get("JAX_COORDINATOR_ADDRESS", ""),
            num_processes=int(e.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(e.get("JAX_PROCESS_ID", "0")),
            slice_id=int(e.get("TPU_SLICE_ID", "0")),
            host_id=int(e.get("TPU_HOST_ID", "0")),
            num_slices=int(e.get("MEGASCALE_NUM_SLICES", "1")),
            accelerator_type=e.get("TPU_ACCELERATOR_TYPE", ""),
            data_dir=e.get("TPUJOB_DATA_DIR", ""),
            model_dir=e.get("TPUJOB_MODEL_DIR", ""),
            log_dir=e.get("TPUJOB_LOG_DIR", ""),
            export_dir=e.get("TPUJOB_EXPORT_DIR", ""),
        )


def initialize_from_env(env: Optional[Dict[str, str]] = None,
                        backend: Optional[str] = None,
                        device: Optional[str] = None) -> ProcessContext:
    """Parse the identity env and, for a multi-process job, join the
    job's process group at ``tcp://$JAX_COORDINATOR_ADDRESS`` as rank
    ``JAX_PROCESS_ID`` of ``JAX_NUM_PROCESSES``. The backend is NCCL when
    the process drives a GPU and gloo on the CPU (``device="cpu"``);
    ``backend`` overrides it (gloo for several ranks on one card, which
    NCCL refuses). A process drives ``cuda:{process_id % device_count}``
    (:func:`local_device`). A single-process job, or one whose process
    group is up already, is left as it is."""
    ctx = ProcessContext.from_env(env)
    if ctx.num_processes <= 1 or dist.is_initialized():
        return ctx
    if not ctx.coordinator_address:
        raise ValueError(
            f"num_processes={ctx.num_processes} but JAX_COORDINATOR_ADDRESS "
            "is not set")
    on_gpu = device != "cpu" and torch.cuda.is_available()
    if on_gpu:
        torch.cuda.set_device(local_device(ctx))
    dist.init_process_group(
        backend=backend or ("nccl" if on_gpu else "gloo"),
        init_method=f"tcp://{ctx.coordinator_address}",
        world_size=ctx.num_processes, rank=ctx.process_id)
    return ctx


def local_device(ctx: ProcessContext) -> torch.device:
    """The GPU this process drives: one per process, round robin over
    the visible cards."""
    return torch.device("cuda", ctx.process_id % torch.cuda.device_count())


def require_process_group(ctx: ProcessContext) -> None:
    """Refuse a multi-process job whose process group is not up: training
    on without it would give each process a private replica."""
    if ctx.num_processes > 1 and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"num_processes={ctx.num_processes} but no torch.distributed "
            "process group is up: call dataplane.dist.initialize_from_env() "
            "first (each process would otherwise train a replica of its own)")
    if ctx.num_processes > 1 and dist.get_world_size() != ctx.num_processes:
        raise RuntimeError(
            f"num_processes={ctx.num_processes} but the process group has "
            f"{dist.get_world_size()} ranks")


def job_device(ctx: ProcessContext, device=None):
    """The device an entry point trains on: ``device`` when given, else
    this rank's GPU under a process group, else ``cuda``."""
    if device is not None:
        return device
    if ctx.num_processes > 1 and torch.cuda.is_available():
        return local_device(ctx)
    return None


def destroy() -> None:
    """Leave the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
