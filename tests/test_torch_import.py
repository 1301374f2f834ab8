"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to run quietly on the CPU, and on the
CPU its kernel wrappers run their plain versions (no launches)."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import kubeflow_controller_tpu_torch as port
from kubeflow_controller_tpu_torch.dataplane import train as ttrain
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm, serve_lm
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as gen
from kubeflow_controller_tpu_torch import optim
from kubeflow_controller_tpu_torch.models import transformer as tfm
from kubeflow_controller_tpu_torch.ops import paged_attention as pa
from kubeflow_controller_tpu_torch.ops import quant_fused as qf

# One intra-op thread for the port's CPU tests in this process. Every
# port test module that imports torch sets it at import (checked below),
# so that it holds for a file run alone too: under pytest-xdist six
# workers of torch's default one thread a core oversubscribe the host,
# and the small tensors of these tests then wait on each other's
# spinning thread pools (a 0.8 s test took 116 s in a loaded run).
# Results do not depend on it: the tests hold the port to tolerances,
# and the gang tests' workers already run one thread.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kubeflow_controller_tpu_torch")
BLOCKED = ("jax", "jaxlib", "kubeflow_controller_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "    'kubeflow_controller_tpu.')) for m in sys.modules\n"
        "    if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _blocked(module: str) -> bool:
    # Word boundary: kubeflow_controller_tpu_torch contains the old name.
    return module.split(".")[0] in BLOCKED


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax_import(path):
    """No import statement, ``importlib.import_module`` or ``__import__``
    in the port (or chip_smoke.py) names JAX or the JAX package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _blocked(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _blocked(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _blocked(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = tfm.tiny_config()
    for kw in (dict(), dict(turns=2), dict(turns=2, prefix_cache=True),
               dict(prefix_cache=True, host_kv_mb=1.0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_lm.serve(config="tiny", batch=1, prompt_len=4,
                           max_new_tokens=2, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_params(cfg)
    params = tfm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, n_slots=1, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, n_slots=1, max_seq=16,
                      prefill_mode="bucketed", prefix_cache=True,
                      host_kv_mb=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen.init_kv_cache(cfg, 1, 16)
    # device="cpu" is the one way onto the CPU.
    ServingEngine(cfg, params, n_slots=1, max_seq=16, device="cpu")


def test_train_entry_points_raise_without_cuda(no_cuda):
    cfg = tfm.tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.train(config="tiny", total_steps=2, seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.TrainLoop(init_fn=tfm.make_init_fn(cfg),
                         loss_fn=tfm.make_loss_fn(cfg),
                         optimizer=optim.make_optimizer(1e-3, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(ttrain.device_prefetch(iter([{"tokens": np.zeros((1, 2))}])))
    # device="cpu" is the one way onto the CPU.
    assert lm.train(config="tiny", total_steps=2, per_data_shard_batch=1,
                    seq_len=32, device="cpu")["final_step"] == 2


#: The MNIST, ResNet and BERT slice: each of these is imported with JAX
#: blocked by test_every_module_imports_with_jax_blocked.
MODEL_MODULES = [
    "kubeflow_controller_tpu_torch.models.mnist",
    "kubeflow_controller_tpu_torch.models.resnet",
    "kubeflow_controller_tpu_torch.models.bert",
    "kubeflow_controller_tpu_torch.dataplane.entrypoints.mnist",
    "kubeflow_controller_tpu_torch.dataplane.entrypoints.resnet",
    "kubeflow_controller_tpu_torch.dataplane.entrypoints.bert",
]


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_model_modules_stand_alone_and_entry_points_need_cuda(module, no_cuda):
    """Each new module is among those imported with JAX blocked, and each
    entry point (a ``train`` with no ``device``) raises without a card."""
    assert module in _port_modules()
    mod = importlib.import_module(module)
    if module.endswith(".bert") and "entrypoints" in module:
        from kubeflow_controller_tpu_torch.models import bert
        kw = dict(cfg=bert.bert_tiny_config(), seq_len=16, per_data_shard_batch=1)
    elif module.endswith(".resnet") and "entrypoints" in module:
        from kubeflow_controller_tpu_torch.models import resnet
        kw = dict(model=resnet.resnet_tiny(), image_size=16, per_chip_batch=1)
    elif "entrypoints" in module:
        kw = dict(batch_size=2)
    else:
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.train(total_steps=2, **kw)


def test_kernel_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A non-CPU tensor must launch the kernel or raise — never fall back
    to the plain version."""
    q = torch.zeros((1, 2, 2, 16), device="meta")
    pool = torch.zeros((3, 8, 2, 16), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA kernel on cuda tensors"):
        pa.paged_attention_decode(q, pool, pool, tables, pos)
    a = torch.zeros((128, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA kernel on cuda tensors"):
        qf.fused_int8_matmul_2d(a, a)


def test_launch_counters_stay_zero_on_cpu():
    cfg = tfm.tiny_config()
    params = tfm.init_params(cfg, seed=3, device="cpu")
    pa.reset_launches()
    eng = ServingEngine(cfg, params, n_slots=2, max_seq=32, block_size=8,
                        device="cpu")
    rng = np.random.default_rng(0)
    out = eng.run([Request(rid=i, prompt=rng.integers(0, 256, 9),
                           max_new_tokens=3) for i in range(3)])
    assert sorted(len(c.tokens) for c in out) == [3, 3, 3]
    assert pa.LAUNCHES == {"paged_decode": 0, "paged_chunk": 0}
    # An int8_fused decoder at a width the fused route takes (d_model 128,
    # 128 rows): the wrapper runs its plain version, and counts nothing.
    qf.reset_launches()
    cfg = tfm.tiny_config(d_model=128, d_ff=256, quant="int8_fused")
    params = tfm.init_params(cfg, device="cpu")
    loss, _ = tfm.next_token_loss(cfg, params, {"tokens": torch.zeros((2, 65), dtype=torch.int64)})
    assert torch.isfinite(loss)
    assert qf.LAUNCHES == {"int8_quantize_rows": 0, "int8_matmul": 0,
                           "int8_quantize_rows_scaled": 0, "int8_matmul_f32": 0}


_SERVE_KW = [
    dict(prefill_mode="exact"), dict(temperature=0.7), dict(quant="int8"),
    dict(prefix_cache=True), dict(speculative=True), dict(tp=2),
    dict(n=2), dict(model_dir="/nonexistent"), dict(config="tiny_moe"),
    dict(trace="<tmp>/trace.json"), dict(disagg=True),
    dict(fault_plan="<tmp>/plan.json"), dict(fault_seed=1),
    dict(watchdog_stale_s=1.0, disagg=True),
]
#: Refused until exact prefill, speculative decoding, checkpoints,
#: sampling, the prefix cache, weight-only int8, the MoE decoder
#: (``config="tiny_moe"``) and the fleet (``trace``, ``disagg``,
#: ``fault_plan``, ``fault_seed``, ``watchdog_stale_s``) were ported:
#: these now serve. ``tp=2`` (tensor parallelism, ported too) needs a
#: gang of two processes.
_SERVE_PORTED = ("prefill_mode", "speculative", "model_dir", "temperature",
                 "n", "prefix_cache", "quant", "config", "trace", "disagg",
                 "fault_plan", "fault_seed", "watchdog_stale_s")


@pytest.mark.parametrize("kwargs", _SERVE_KW,
                         ids=[next(iter(kw)) for kw in _SERVE_KW])
def test_serve_refuses_what_is_not_ported(kwargs, tmp_path):
    base = dict(config="tiny", batch=1, prompt_len=4, max_new_tokens=2,
                device="cpu")
    (tmp_path / "plan.json").write_text(
        '{"specs": [{"kind": "slow", "site": "engine.step", "factor": 2}]}')
    base.update({k: v.replace("<tmp>", str(tmp_path)) if isinstance(v, str)
                 else v for k, v in kwargs.items()})
    if next(iter(kwargs)) == "tp":
        # Tensor-parallel serving is ported: one process is no gang of two
        # ranks, and the serving mesh says so.
        with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
            serve_lm.serve(**base)
        return
    if next(iter(kwargs)) in _SERVE_PORTED:
        out = serve_lm.serve(**base)
        n = kwargs.get("n", 1)                 # n generations a prompt
        assert out["requests"] == n and out["tokens_out"] == 2 * n
        assert out["restored_step"] == -1      # no checkpoint: a fresh init
        if "trace" in kwargs:
            assert (tmp_path / "trace.json").exists()
            assert out["spans_recorded"] > 0 and out["spans_dropped"] == 0
        if "fault_plan" in kwargs:
            assert out["faults_total"] > 0     # the slow quanta fired
        if kwargs.get("disagg"):
            assert out["migrations"] == 1
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve_lm.serve(**base)


def test_inference_params_refuses_int8_weights():
    """Weight-only int8 is ported (``(q, scale)`` pairs, held bit for bit
    to the JAX package in test_torch_serving.py); a scheme other than
    ``""`` and ``"int8"`` is refused."""
    cfg = tfm.tiny_config()
    params = gen.inference_params(cfg, tfm.init_params(cfg, device="cpu"),
                                  quant="int8")
    assert isinstance(params["layers"]["wq"], tuple)
    with pytest.raises(ValueError, match="quant must be"):
        gen.inference_params(cfg, {}, quant="fp8")


def test_build_module_needs_no_nvcc_at_import():
    """The CPU tests import every module on a machine without nvcc: the
    loader may only look for the compiler when a kernel is launched. It
    builds every kernel source of the package into one library."""
    mod = importlib.import_module("kubeflow_controller_tpu_torch.ops._build")
    names = [os.path.relpath(s, PKG) for s in mod.SOURCES]
    assert names == [os.path.join("csrc", "flash_attention.cu"),
                     os.path.join("csrc", "int8_matmul.cu"),
                     os.path.join("csrc", "paged_attention.cu")]
    assert all(os.path.exists(s) for s in mod.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in mod.NVCC_FLAGS


def test_library_name_is_keyed_by_every_source(tmp_path, monkeypatch):
    """Editing any one source names a new library, so a stale build is
    never loaded."""
    from kubeflow_controller_tpu_torch.ops import _build

    copies = []
    for src in _build.SOURCES:
        dst = tmp_path / os.path.basename(src)
        dst.write_bytes(open(src, "rb").read())
        copies.append(str(dst))
    monkeypatch.setattr(_build, "SOURCES", tuple(copies))
    before = _build.library_path()
    with open(copies[0], "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before


def test_dist_and_parallel_modules_are_checked():
    """The multi-process layer (``dataplane/dist.py``, ``parallel/mesh.py``,
    ``sharding.py``, ``memory.py``, ``collectives.py``) is among the
    modules and sources the two checks above hold to importing neither
    JAX nor the JAX package."""
    names = {"kubeflow_controller_tpu_torch.dataplane.dist"} | {
        f"kubeflow_controller_tpu_torch.parallel.{m}"
        for m in ("mesh", "sharding", "memory", "collectives")}
    assert names <= set(_port_modules())
    srcs = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"dataplane/dist.py", "parallel/mesh.py", "parallel/sharding.py",
            "parallel/memory.py", "parallel/collectives.py"} <= srcs


def test_every_port_test_module_runs_one_intra_op_thread():
    """Each ``tests/test_torch_*.py`` that imports torch at module level
    sets one intra-op thread there (see the top of this file)."""
    here = os.path.dirname(os.path.abspath(__file__))
    missing = []
    for name in sorted(os.listdir(here)):
        if not (name.startswith("test_torch_") and name.endswith(".py")):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        imports_torch = any(isinstance(n, ast.Import) and any(a.name == "torch" for a in n.names)
                            for n in tree.body)
        sets_one = any(isinstance(n, ast.Expr) and ast.unparse(n) == "torch.set_num_threads(1)"
                       for n in tree.body)
        if imports_torch and not sets_one:
            missing.append(name)
    assert not missing, missing


#: The in-process control plane: it runs no tensor, so it imports no
#: torch, and it imports PyYAML only inside the two YAML functions.
CONTROL_PACKAGES = ("api", "cluster", "controller", "tpu", "checker",
                    "updater")


def test_control_plane_modules_are_in_the_walk():
    names = set(_port_modules())
    for pkg in CONTROL_PACKAGES:
        assert f"kubeflow_controller_tpu_torch.{pkg}" in names
    assert "kubeflow_controller_tpu_torch.runtime" in names
    assert {"kubeflow_controller_tpu_torch.controller.controller",
            "kubeflow_controller_tpu_torch.cluster.cluster",
            "kubeflow_controller_tpu_torch.tpu.plan",
            "kubeflow_controller_tpu_torch.api.serialization"} <= names


def test_control_plane_imports_no_torch_and_no_yaml_and_runs_a_job():
    """With JAX, the JAX package, torch and PyYAML all blocked, the control
    plane imports, and a Local job built from the dataclasses runs to
    Succeeded through the port's LocalRuntime."""
    mods = [f"kubeflow_controller_tpu_torch.{p}" for p in CONTROL_PACKAGES]
    mods += [m for m in _port_modules() if m.split(".")[1] in
             CONTROL_PACKAGES] + ["kubeflow_controller_tpu_torch.runtime"]
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED + ('torch', 'yaml')!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "from kubeflow_controller_tpu_torch.api import (Container, ObjectMeta,\n"
        "    PodSpec, PodTemplateSpec, ReplicaSpec, ReplicaType, TPUJob,\n"
        "    TPUJobSpec, job_from_dict, job_to_dict)\n"
        "from kubeflow_controller_tpu_torch.api.types import JobPhase\n"
        "from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy\n"
        "from kubeflow_controller_tpu_torch.runtime import LocalRuntime\n"
        "rt = LocalRuntime(PodRunPolicy(start_delay=1, run_duration=2))\n"
        "job = TPUJob(metadata=ObjectMeta(name='j', namespace='default'),\n"
        "    spec=TPUJobSpec(replica_specs=[ReplicaSpec(\n"
        "        replica_type=ReplicaType.LOCAL, template=PodTemplateSpec(\n"
        "            spec=PodSpec(containers=[Container(name='t', image='i')])))]))\n"
        "assert job_to_dict(job_from_dict(job_to_dict(job))) == job_to_dict(job)\n"
        "rt.submit(job)\n"
        "assert rt.wait_for_phase('default', 'j', JobPhase.SUCCEEDED, max_steps=20)\n"
        "rt.stop()\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('torch', 'yaml', 'jax', 'jaxlib',\n"
        "                           'kubeflow_controller_tpu', 'numpy')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_router_uses_the_workqueue_backoff():
    """The fleet router's retry curve is the workqueue's function, not a
    copy of it."""
    from kubeflow_controller_tpu_torch.controller import workqueue
    from kubeflow_controller_tpu_torch.dataplane import router

    assert router.backoff_delay is workqueue.backoff_delay
