"""PyTorch and CUDA port of the data plane (LM serving; LM, MNIST,
ResNet-50 and BERT training), for NVIDIA Hopper.

This package stands beside the JAX package ``kubeflow_controller_tpu``
and mirrors its module paths (``models/transformer.py``,
``models/generate.py``, ``ops/paged_attention.py``,
``dataplane/serving_engine.py``, ...) so that each module's counterpart
is easy to find. It imports ``torch`` and never ``jax``, and nothing of
the JAX package: framework-neutral helpers are copied, not shared.

Entry points (:func:`~.dataplane.entrypoints.serve_lm.serve`,
:class:`~.dataplane.serving_engine.ServingEngine`,
:func:`~.models.transformer.init_params`) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise rather than
carry on quietly on the CPU. The kernels are written by hand in CUDA
C++ (``csrc/*.cu``), built with ``nvcc`` at first use and bound through
``ctypes``; on a CPU tensor each wrapper runs its plain PyTorch version
instead.

The control plane (``api``, ``cluster``, ``controller``, ``tpu``,
``checker``, ``updater``, ``runtime``) runs no tensor and imports no
``torch``; so this package's ``__init__`` does not import it either, and
``resolve_device`` is loaded on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from kubeflow_controller_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(name)
