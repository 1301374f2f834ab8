"""Per-request sampling parameters.

Counterpart of ``kubeflow_controller_tpu/dataplane/sampling.py``'s
:class:`SamplingParams`. This slice of the port serves greedy decoding
only: the engine refuses ``temperature > 0`` with "not yet ported",
because reproducing the JAX engine's seeded streams needs its threefry
key chain (``fold_in(fold_in(key(seed), gen), position)``). Grammar
masks and ``n > 1`` forks are later slices too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` selects greedy decoding (argmax, first maximum
    on ties); ``top_k == 0`` and ``top_p >= 1`` disable the respective
    filters. ``n`` asks for that many generations of one prompt.
    ``max_tokens``, when set, overrides the request's
    ``max_new_tokens``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    n: int = 1
    seed: int = 0
    max_tokens: Optional[int] = None

    def validate(self) -> None:
        if not np.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0
