"""``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the card this process is
started on, and its result as the last line of standard output.

Three more options serve whoever sizes a cell. ``--control`` runs the
cell's control (``check.control`` in its workload file) in place of the
configured precision: ``program_int8`` is the program's own int8 path
(int8 weights and KV pool in serving, int8 projections in training),
``reference_fp8`` judges the tokens that the reference computed with
fp8 operands puts first, at the positions the program served.
``--fault half_batch`` plants a training fault. Both are read against
the limits of ``correct``. ``--sweep r1,r2,...`` offers an open-loop
cell each rate in turn and prints its tails without the check, to find
the knee; a cell's own rate is only ever the one in its file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List

from gpubench.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_controller_tpu")


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux: its
    age from ``/proc``), so that set-up counts the interpreter's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


def set_environment() -> None:
    """Every build or kernel cache at a fixed path inside the checkout
    (the port builds its kernels into its own ``_build/`` there), and one
    host thread for the CPU math libraries: the load comes from one
    process whose host loop is the engine's, and idle pool threads
    spinning beside it on a shared host only add jitter."""
    base = os.path.join(spec.ROOT, ".gpubench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process holds), each compared whole: the port's
    ``kubeflow_controller_tpu_torch`` is not the JAX package."""
    tops = {m.split(".")[0] for m in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def judge(cell: spec.Cell, checks: Dict[str, float], failed: int):
    limits = cell.workload["check"]["limits"]
    out, ok = {}, failed == 0
    for name, limit in limits.items():
        v = checks.get(name, float("inf"))
        out[name] = {"value": v if math.isfinite(v) else None, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, out


def result(cell: spec.Cell, oc, trace: bool, device_name: str, card: str) -> Dict:
    from gpubench.counts.peaks import peaks_for

    rec = oc.records
    if trace:
        rec.peaks = peaks_for(device_name)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = oc.setup_s if m.name == "setup_s" else oc.e2e.get(m.name)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m.name)(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    correct, checks = judge(cell, oc.checks, oc.failed)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": oc.memory_peak_bytes}
    out = {"correct": correct, "attempted": oc.attempted, "failed": oc.failed,
           "metrics": metrics, "device": device, "card": card, "run": oc.extra}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["run"]["check_readings"] = dict(oc.checks)
    out["checks"] = checks
    return out


def plant_half_batch() -> None:
    """The fault "half of the batch left out, the mean taken over the
    rest", planted in the program's loss."""
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    real = tfm.next_token_loss

    def half(cfg, params, batch, *a, **kw):
        n = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:n] for k, v in batch.items()}, *a, **kw)

    tfm.next_token_loss = half


def parse(argv):
    p = argparse.ArgumentParser(prog="gpubench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the cell's control (check.control in its workload file)")
    p.add_argument("--sweep", default="", help="open-loop rates to offer")
    p.add_argument("--fault", default="", choices=("", "half_batch"),
                   help="plant a fault in the program (training: the loss over "
                        "half of each batch's rows), to read it against the limits")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_environment()
    import torch

    torch.set_num_threads(1)
    from gpubench.drivers import serve_closed, serve_open, train
    from gpubench.harness.context import Ctx

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = power_limit()
    drivers = {"serve_open": serve_open, "serve_closed": serve_closed, "train": train}
    driver = drivers[cell.workload["driver"]]
    if args.fault == "half_batch":
        plant_half_batch()
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, dtype=torch.bfloat16, t_start=t_start,
              control=cell.workload["check"]["control"] if args.control else "")
    if args.sweep:
        for rate in [float(r) for r in args.sweep.split(",")]:
            oc = driver.run(ctx, rate=rate, check=False)
            print(json.dumps({"rate_per_s": rate, **oc.e2e, "failed": oc.failed,
                              **oc.extra}), flush=True)
        return 0
    oc = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    out = result(cell, oc, bool(args.trace), name, card)
    out["run"]["seed"] = args.seed
    out["run"]["control"] = ctx.control
    for cname, c in out["checks"].items():
        print(f"check {cname} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
