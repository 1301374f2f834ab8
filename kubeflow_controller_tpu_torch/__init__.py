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
``checker``, ``updater``, ``native``, ``util``, ``runtime`` and ``cli``,
the ``tpujobctl`` CLI run as ``python -m kubeflow_controller_tpu_torch.cli``)
runs no tensor and imports no ``torch``; so this package's ``__init__`` does
not import it either, and ``resolve_device`` is loaded on first use.
``__version__`` and :func:`build_version` are the JAX package's.
"""

__all__ = ["resolve_device", "build_version"]

__version__ = "0.1.0"


def _git_sha() -> str:
    import os
    import subprocess

    env = os.environ.get("TPUJOB_GIT_SHA", "")
    if env:
        return env
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        top = subprocess.run(
            ["git", "-C", pkg_dir, "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip()
        # Only trust the sha when the package actually lives at the top
        # of that checkout — a site-packages install nested under some
        # unrelated repo must not report that repo's sha.
        if top != os.path.dirname(pkg_dir):
            return ""
        return subprocess.run(
            ["git", "-C", pkg_dir, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip()
    except Exception:
        return ""


_build_sha: list = []   # memo cell: the sha cannot change within a process


def build_version() -> str:
    """``<version>+<git sha>`` — the analog of the reference's ldflags-injected
    ``Version``/``GitSHA`` (the reference's ``Makefile:23-26``,
    ``version/version.go:3-6``). The sha comes from ``TPUJOB_GIT_SHA`` (build
    systems export it, the Makefile's ``stamp`` target does) or, in a git
    checkout of THIS repo, from ``git rev-parse``; plain ``__version__``
    otherwise. The git probe runs once per process."""
    if not _build_sha:
        _build_sha.append(_git_sha())
    sha = _build_sha[0]
    return f"{__version__}+{sha}" if sha else __version__



def __getattr__(name):
    if name == "resolve_device":
        from kubeflow_controller_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(name)
