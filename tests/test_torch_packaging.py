"""The port's package data ships every source its kernels and its native
core are built from at first use (C14).

``kubeflow_controller_tpu_torch/csrc/`` holds the CUDA sources, the header
they all include (``hopper.cuh``) and the controller's C++ core
(``tpujob_native.cc``). A wheel or a non-editable install carries only
what ``[tool.setuptools.package-data]`` names, so every file there must
match one of the port's globs; the JAX package's packaging stays as it
was. The slow case builds the wheel offline and reads its archive.
"""

import fnmatch
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "kubeflow_controller_tpu_torch"


def _pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _csrc_files():
    csrc = os.path.join(ROOT, PORT, "csrc")
    return sorted(f for f in os.listdir(csrc)
                  if os.path.isfile(os.path.join(csrc, f)))


def test_every_csrc_file_matches_the_port_package_data():
    globs = _pyproject()["tool"]["setuptools"]["package-data"][PORT]
    files = _csrc_files()
    assert {"hopper.cuh", "tpujob_native.cc"} <= set(files)
    for name in files:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), (name, globs)


def test_the_jax_package_packaging_is_unchanged():
    """Only the port's entry is package data, and the package search,
    the console script and the dependencies are the JAX package's."""
    tool = _pyproject()["tool"]["setuptools"]
    assert set(tool["package-data"]) == {PORT}
    assert tool["packages"]["find"] == {"include": ["kubeflow_controller_tpu*"]}
    project = _pyproject()["project"]
    assert project["scripts"] == {"tpujobctl": "kubeflow_controller_tpu.cli:main"}
    assert "jax>=0.9.0" in project["dependencies"]


@pytest.mark.slow
def test_an_offline_wheel_ships_the_kernel_and_native_sources(tmp_path):
    """``pip wheel --no-deps --no-build-isolation --no-index`` of the
    port's files and the project's ``pyproject.toml`` (a few seconds):
    the archive holds every file of ``csrc/``."""
    src = tmp_path / "src"
    shutil.copytree(os.path.join(ROOT, PORT), src / PORT,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(ROOT, name), src / name)
    out = tmp_path / "wheel"
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w", str(out),
                    str(src)], check=True, capture_output=True, timeout=300)
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    for name in _csrc_files():
        assert f"{PORT}/csrc/{name}" in names, name
