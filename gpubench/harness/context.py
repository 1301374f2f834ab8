"""One run of a cell, as the drivers see it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from gpubench.harness.records import Records
from gpubench.harness.spec import Cell


@dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                       # torch.device
    dtype: Any                        # the compute dtype the config states
    t_start: float                    # process start, on the host clock
    control: str = ""                 # "" or the cell's control (check.control)

    @property
    def port(self) -> Dict[str, Any]:
        return self.cell.config["port"]


@dataclass
class Outcome:
    """What a driver hands back: its end-to-end values, the records the
    per-layer readers take, the work attempted and failed, the numbers
    compared against the cell's limits, and the device's peak memory."""

    e2e: Dict[str, float]
    records: Records
    attempted: int
    failed: int
    checks: Dict[str, float]
    memory_peak_bytes: int
    extra: Dict[str, Any] = field(default_factory=dict)
    setup_s: Optional[float] = None
