"""Parallelism over ``torch.distributed`` ranks: the six-axis mesh
(``mesh.py``), parameter placement by the JAX package's rules
(``sharding.py``), the layers' collectives (``collectives.py``) and the
per-rank memory plan (``memory.py``). Counterpart of
``kubeflow_controller_tpu/parallel/`` without ring attention, the
pipeline and the AOT check, which are not ported yet.
"""
