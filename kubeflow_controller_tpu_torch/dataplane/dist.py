"""This process's identity within a job, parsed from the controller's env.

Counterpart of ``kubeflow_controller_tpu/dataplane/dist.py``: the env
parsing only. Bringing up a multi-process runtime
(``torch.distributed``) belongs to a later slice of the port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


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
