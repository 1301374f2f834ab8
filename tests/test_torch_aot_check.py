"""The port's memory gate (``parallel/aot_check.py``), the kernels'
operators it traces through (``torch.ops.kfc.*``), llama3_70b's config
and the memory plan at the JAX package's meshes and on the 80 GB card.

The gate traces a train step on fake tensors under torch's fake process
group; here it names the CPU (``device="cpu"``), whose operators' fakes
are the card's. The JAX side of each comparison runs on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from kubeflow_controller_tpu.models import transformer as jtf
from kubeflow_controller_tpu.parallel import aot_check as jaot
from kubeflow_controller_tpu.parallel import memory as jmemory
from kubeflow_controller_tpu_torch.models import transformer as ttf
from kubeflow_controller_tpu_torch.ops import flash_attention as tfa
from kubeflow_controller_tpu_torch.ops import quant_fused as tqf
from kubeflow_controller_tpu_torch.parallel import aot_check as taot
from kubeflow_controller_tpu_torch.parallel import collectives
from kubeflow_controller_tpu_torch.parallel import memory as tmemory

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 1024 ** 3
CARD_GB = 80           # one H100's memory, as the plan's budget in GiB


# -- the gate ------------------------------------------------------------------

def _plan_state(name, axes, batch, seq):
    plan = tmemory.transformer_memory_plan(getattr(ttf, f"{name}_config")(), axes, batch, seq)
    return plan.params + plan.opt_state


def test_gate_traces_tiny_at_dp2_fsdp2_tp2_through_the_kernel_operators():
    """Rank 0's parameters and moments are the plan's params + opt_state
    to the byte; the step's peak above them is counted (never zero); the
    attention ran through the flash kernels' operators; the fake process
    group is gone afterwards."""
    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    out = taot.aot_trace_train_step("tiny", axes, 8, seq=256, device="cpu")
    assert out["argument_bytes_per_device"] == _plan_state("tiny", axes, 8, 256)
    assert out["temp_bytes_per_device"] > 0
    assert out["output_bytes_per_device"] >= 0
    assert out["mesh"] == axes and out["seq"] == 256 and out["trace_s"] > 0
    # tiny's head_dim 16 takes the forward and the fused dk/dv kernel,
    # once a layer each (no remat).
    assert out["kernel_ops"] == {"kfc::flash_bwd_kv": 2, "kfc::flash_fwd": 2}
    assert not dist.is_initialized()


def test_gate_cli_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_controller_tpu_torch.parallel.aot_check",
         "--config", "tiny", "--mesh", "dp=2,fsdp=2,tp=2", "--batch", "8",
         "--seq", "128", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    assert out["argument_bytes_per_device"] == _plan_state("tiny", axes, 8, 128)


def test_gate_refuses_to_run_inside_a_process_group():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="without a process group"):
            taot.aot_trace_train_step("tiny", {"fsdp": 2}, 2, 64, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ["dp=2,fsdp=16,tp=4", "fsdp=16,tp=8", "tp=2",
                                  " dp=1, fsdp = 8 ", "pp=2,dp=2,fsdp=2,ep=2,sp=2,tp=2"])
def test_parse_mesh_matches_jax(spec):
    assert taot.parse_mesh(spec) == jaot.parse_mesh(spec)
    assert list(taot.parse_mesh(spec)) == list(jaot.parse_mesh(spec))


def test_nothing_is_staged_through_host_memory_under_the_fake_backend():
    """``collectives._staged`` keys on gloo: a card's tensor under the
    fake backend (the gate's) is not copied through pinned host memory."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with FakeTensorMode():
            x = torch.empty((4,), device="cuda")
        assert x.is_cuda and not collectives._staged(x, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
@pytest.mark.parametrize("name,axes,batch", [
    ("llama3_8b", {"dp": 2, "fsdp": 16, "tp": 4}, 32),
    ("llama3_70b", {"fsdp": 16, "tp": 8}, 16),
], ids=["llama3_8b-dp2-fsdp16-tp4", "llama3_70b-fsdp16-tp8"])
def test_full_size_gate_fits_the_card(name, axes, batch):
    """The JAX gate's TestAOTCompile at the port's meshes: the whole
    80-layer step traced at S 8192, its per-rank bytes above 1 GiB and
    under one card's 80 GB."""
    out = taot.aot_trace_train_step(name, axes, batch, seq=8192, device="cpu")
    per_rank = out["argument_bytes_per_device"] + out["temp_bytes_per_device"]
    assert out["argument_bytes_per_device"] == _plan_state(name, axes, batch, 8192)
    assert GiB < per_rank < CARD_GB * 1e9, out


# -- the operators' fakes --------------------------------------------------------

def _flash_args(d=128, s=256, h=4, kvh=2, b=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g)
    k = torch.randn((b, s, kvh, d), generator=g)
    v = torch.randn((b, s, kvh, d), generator=g)
    do = torch.randn((b, s, h, d), generator=g)
    c, st = tfa.rope_full_tables(torch.arange(s).expand(b, s), d, 10000.0)
    lse = torch.randn((b, h, s), generator=g)
    return q, k, v, do, lse, c, st


def _op_cases():
    q, k, v, do, lse, c, st = _flash_args()
    q16, k16, v16, do16, lse16, c16, st16 = _flash_args(d=16)
    seg = torch.ones((1, 256), dtype=torch.int32)
    acc = torch.zeros(q.shape)
    a = torch.randn((128, 256), generator=torch.Generator().manual_seed(1)).bfloat16()
    qa, sa = tqf.quantize_rows_plain(a)
    qbt, sb = tqf.rhs_codes(torch.randn((256, 128)))
    return {
        "rope_rotate": (q, k, c, st),
        "flash_fwd": (q16, k16, v16, seg, c16, st16, True),
        "flash_bwd_prep": (q, do, True),
        "flash_bwd_prep_no_scratch": (q, do, False),
        "flash_bwd_post": (acc, c, st, torch.bfloat16),
        "flash_bwd_fused": (q, k, v, do, lse, lse, None, c, st, acc.clone(), True),
        "flash_bwd_kv": (q16, k16, v16, do16, lse16, lse16, seg, c16, st16, None, False),
        "flash_bwd_dq": (q, k, v, do, lse, lse, None, c, st, True),
        "int8_quantize_rows": (a,),
        "int8_quantize_rows_scaled": (a, sa),
        "int8_matmul": (qa, qbt, sa, sb),
        "int8_matmul_f32": (qa, qbt, sa, sb),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_each_operator_fake_allocates_its_cpu_outputs(case):
    """Under ``FakeTensorMode`` each ``kfc`` operator's fake returns the
    shapes, dtypes and device its CPU implementation returns on real
    CPU tensors; the CPU implementation launches nothing."""
    args = _op_cases()[case]
    op = getattr(torch.ops.kfc, case.replace("_no_scratch", "")).default
    tfa.reset_launches()
    tqf.reset_launches()
    want = op(*args)
    assert not any(tfa.LAUNCHES.values()) and not any(tqf.LAUNCHES.values())
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake_args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype, g.device) == (w.shape, w.dtype, w.device), case


# -- llama3_70b and the plan ------------------------------------------------------

def test_llama3_70b_config_fields_equal_jax():
    want, got = jtf.llama3_70b_config(), ttf.llama3_70b_config()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq", "rope_theta", "norm_eps", "remat", "quant",
                  "attn_impl", "tie_embeddings", "moe_experts"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim == 128
    assert got.n_heads // got.n_kv_heads == 8


#: tests/test_llama_fits.py's four plans.
JAX_PLANS = [("llama3_8b", {"dp": 2, "fsdp": 16, "tp": 4}, 32),
             ("llama3_8b", {"fsdp": 16, "tp": 4}, 16),
             ("llama3_8b", {"fsdp": 2, "tp": 4}, 8),
             ("llama3_70b", {"dp": 2, "fsdp": 16, "tp": 4}, 32)]


@pytest.mark.parametrize("name,axes,batch", JAX_PLANS, ids=[
    f"{n}-" + "-".join(f"{k}{v}" for k, v in a.items()) for n, a, _ in JAX_PLANS])
def test_memory_plan_equals_jax_term_by_term(name, axes, batch):
    want = jmemory.transformer_memory_plan(getattr(jtf, f"{name}_config")(), axes, batch, 8192)
    got = tmemory.transformer_memory_plan(getattr(ttf, f"{name}_config")(), axes, batch, 8192)
    for term in ("params", "grads", "opt_state", "activations", "logits"):
        assert getattr(got, term) == getattr(want, term), term


def test_memory_plan_on_the_80gb_card():
    """70B's state alone (70.6e9 x 16 bytes / 8 = 141 GB a card) rules out
    one 8-card node at fsdp=8; fsdp=16 x tp=8 (tp inside an NVLink
    domain of 8) fits at global batch 16, S 8192: ~8.8 GB of state,
    ~11.7 GB of activations and ~8.4 GB of logits a card."""
    cfg = ttf.llama3_70b_config()
    node = tmemory.transformer_memory_plan(cfg, {"fsdp": 8}, 16, 8192)
    assert not node.fits(CARD_GB)
    assert node.params + node.grads + node.opt_state > 140e9
    two_d = tmemory.transformer_memory_plan(cfg, {"fsdp": 16, "tp": 8}, 16, 8192)
    assert two_d.fits(CARD_GB)
    np.testing.assert_allclose(two_d.params + two_d.grads + two_d.opt_state, 8.8e9, rtol=0.01)
    np.testing.assert_allclose(two_d.activations, 11.7e9, rtol=0.02)
    np.testing.assert_allclose(two_d.logits, 8.4e9, rtol=0.01)
