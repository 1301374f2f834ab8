"""Parallelism over ``torch.distributed`` ranks: the six-axis mesh
(``mesh.py``), parameter placement by the JAX package's rules
(``sharding.py``), the layers' collectives (``collectives.py``), ring
attention over sp (``ring.py``), the GPipe schedule over pp
(``pipeline.py``) and the per-rank memory plan (``memory.py``).
Counterpart of ``kubeflow_controller_tpu/parallel/`` without the AOT
check, which is not ported yet.
"""
