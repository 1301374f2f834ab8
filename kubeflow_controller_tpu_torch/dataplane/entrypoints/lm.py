"""Model configurations the port serves, by name.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/lm.py``'s
``CONFIGS`` table. The JAX table's other entries are refused by name in
``NOT_YET_PORTED`` until a later slice ports them.
"""

from __future__ import annotations

from kubeflow_controller_tpu_torch.models import transformer as tfm

CONFIGS = {
    "tiny": tfm.tiny_config,
    "llama3_8b": tfm.llama3_8b_config,
}

#: Configurations of the JAX package's table this port does not serve yet
#: (MoE configs need the routed FFN; llama3_70b needs tensor parallelism).
NOT_YET_PORTED = ("tiny_moe", "llama3_70b", "mixtral_8x7b")
