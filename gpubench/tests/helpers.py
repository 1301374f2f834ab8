"""Cells cut to CPU size for the tests: the same files, with the
configuration's ``port`` sizes, the traffic's lengths and the engine's
span made tiny, driven on the CPU in fp32."""

from __future__ import annotations

import copy
import time

import torch

from gpubench.harness import spec
from gpubench.harness.context import Ctx

TINY = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
        "vocab_size": 256, "max_seq": 256}
TINY_MOE = dict(TINY, moe_experts=4, moe_top_k=2, d_ff=64)


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell = copy.deepcopy(cell)
    port = cell.config["port"]
    moe = bool(port.get("moe_experts"))
    cell.config["port"] = dict(port, **(TINY_MOE if moe else TINY))
    t = cell.traffic
    if "prompt" in t:
        t["prompt"] = dict(t["prompt"], median=24, min=8, max=48)
        t["output"] = dict(t["output"], median=6, min=2, max=12)
        cell.workload["engine"] = dict(cell.workload["engine"], n_slots=4, max_seq=64)
        cell.workload["check"] = dict(cell.workload["check"], sample_tokens=24)
        if "rate_per_s" in cell.workload.get("load", {}):
            cell.workload["load"] = {"rate_per_s": 4.0}
        else:
            cell.workload["load"] = {"clients": 4}
        cell.workload["drain_limit_s"] = 30
    else:
        t["doc"] = dict(t["doc"], median=16, min=4, max=64)
        cell.workload["batch"] = {"rows": 2, "seq_len": 32}
        cell.workload["model"] = {"remat": True, "attn_impl": "auto"}
    return cell


def tiny_ctx(cell: spec.Cell, seed: int = 7, seconds: float = 1.0,
             control: str = "", trace: bool = False) -> Ctx:
    return Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device=torch.device("cpu"), dtype=torch.float32,
               t_start=time.perf_counter(), control=control)
