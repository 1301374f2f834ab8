#!/usr/bin/env python3
"""Time one tree of the port on the card, for an A/B of two commits.

    python3 chip_ab.py ROOT TAG [SECTION ...]

Imports ``chip_smoke`` and the port from ROOT (a checkout, for example a
``git archive`` of the parent unpacked under ``build/``) and prints one
line ``AB {json}``. Sections (all by default):

* ``flash``: the flash kernels at llama3_8b's and the flagship's
  attention shapes (``FlashCase.run``, timed: whole call by CUDA events,
  device time by kernel, SDPA, bound);
* ``train``: the llama3_8b train step at 2 layers, B2 S2048, in bf16 (8
  steps) and under ``quant="int8_fused"`` (4), and the flagship's
  (bench.py: 16 layers, B16 S1024) in bf16 (8), with exact launch counts
  (``train_run``);
* ``dispatch``: the host time of one kernel call through the port's
  wrapper (``rope_rotate`` and B7's ``quantize_rows`` at a few rows,
  where the launch, not the kernel, is the cost), and on a tree whose
  kernels are ``torch.ops.kfc`` operators, of the bare ``ctypes``
  launch, of the operator's CUDA implementation called as a function,
  and of the same launch registered through ``torch.library.custom_op``;
* ``paged``: the paged decode at the serving shapes (bf16 and int8
  pools) and at 2048 columns, and the serving prefill chunk
  (``Case.run``, timed and by kernel);
* ``serve``: ``profile_phase``'s decode micro-step and prefill chunk on
  llama3_8b (wall, device time by kernel bucket, idle share), then 16
  llama3_8b requests through ``serve`` with bucketed prefill (TTFT,
  TPOT, tokens/s, launches).

Compare two trees only inside one call on one card, in turns: parent,
change, change, parent. Needs one card; runs nothing on the CPU.
"""

import json
import os
import re
import sys

SECTIONS = ("flash", "train", "paged", "serve", "dispatch")
SERVE_POS = [256, 263, 270, 277, 284, 287, 259, 266]
LONG_POS = [2047, 0, 15, 16, 1000, 1535, 777, 2040]


def flash_section(c, smi, out):
    import torch

    fails = []
    for shape in ("llama3_8b", "flagship"):
        case = c.FlashCase(shape, segments=False, seed=20, **c.FLASH_SHAPES[shape])
        for k, r in case.run(smi, True, fails).items():
            out[f"{shape}/{k}"] = {x: r.get(x) for x in (
                "ms", "library_ms", "bound_ms", "max_abs_err", "device_ms_by_kernel",
                "two_pass_route_ms", "fused_route_ms")}
        del case
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(fails)


def train_section(c, smi, out):
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa

    llama = tfm.llama3_8b_config(n_layers=2, max_seq=2048, attn_impl="flash")
    n = llama.n_layers
    # A tree with the two-pass route of flash_bwd_two_pass shares one rope
    # prepass between the passes and takes delta from the prepass kernel.
    if hasattr(fa, "flash_bwd_two_pass"):
        want = {"rope_rotate": 3 * n, "flash_bwd_prep": n}
    else:
        want = {"rope_rotate": 2 * n}
    want.update(flash_fwd=2 * n, flash_bwd_dkdv=n, flash_bwd_dq=n)
    int8 = {"int8_quantize_rows": 16 * n, "int8_matmul": 16 * n}
    flag = tfm.flagship_config()
    m = flag.n_layers
    flag_want = {"rope_rotate": 3 * m, "flash_fwd": 2 * m, "flash_bwd_prep": m,
                 "flash_bwd_fused": m, "flash_bwd_post": m}
    for label, cfg, seq, batch, steps, expect in (
            ("llama3_8b", llama, 2048, 2, 8, want),
            ("llama3_8b.int8_fused", llama.replace(quant="int8_fused"), 2048, 2, 4,
             {**want, **int8}),
            ("flagship", flag, 1024, 16, 8, flag_want)):
        r = c.train_run(label, cfg, seq, batch, steps, expect, smi)
        out["train/" + label] = {x: r[x] for x in (
            "step_ms", "step_ms_all", "profiled_step_device_ms", "mfu", "tokens_per_s",
            "idle_share", "device_ms_by_kernel", "peak_gb")}


DISPATCH_CALLS = 1000
DISPATCH_ROUNDS = 9


def _host_us(fns, n=DISPATCH_CALLS, rounds=DISPATCH_ROUNDS):
    """Per name of ``fns``, the least and the median over ``rounds`` of
    the host microseconds a call takes, ``n`` calls queued and one
    synchronize after them (each call launches a kernel of a few
    microseconds); the variants take turns within each round, so that a
    change of the host's load falls on all of them."""
    import time

    import torch

    for fn in fns.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t = time.perf_counter()
            for _ in range(n):
                fn()
            got[name].append((time.perf_counter() - t) * 1e6 / n)
            torch.cuda.synchronize()
    return {name: {"min": min(v), "median": sorted(v)[len(v) // 2]}
            for name, v in got.items()}


def dispatch_section(c, smi, out):
    import torch

    from kubeflow_controller_tpu_torch.ops import _build
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    dev = torch.device("cuda")
    q = torch.randn((1, 16, 1, 64), device=dev, dtype=torch.bfloat16)
    k = torch.randn((1, 16, 1, 64), device=dev, dtype=torch.bfloat16)
    tables = fa.rope_full_tables(torch.arange(16, device=dev)[None], 64, 1e4)
    a = torch.randn((16, 128), device=dev, dtype=torch.bfloat16)
    fns = {"rope_rotate": lambda: fa.rope_rotate(q, k, tables),
           "quantize_rows": lambda: qf.quantize_rows(a)}
    if hasattr(fa, "_rope_rotate_cuda"):
        lib = _build.load()
        qo, ko = torch.empty_like(q), torch.empty_like(k)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
                qo.data_ptr(), ko.data_ptr(), 16, 1, 1, 64, stream)

        def bare():
            if lib.kfc_rope_rotate(*ptrs):
                raise RuntimeError("kfc_rope_rotate failed")

        @torch.library.custom_op("kfc_ab::rope_rotate", mutates_args=(), device_types="cuda")
        def custom(q: torch.Tensor, k: torch.Tensor, c_: torch.Tensor,
                   s_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            return fa._rope_rotate_cuda(q, k, c_, s_)

        fns.update(
            rope_rotate_ctypes=bare,
            rope_rotate_impl=lambda: fa._rope_rotate_cuda(q, k, *tables),
            rope_rotate_op=lambda: torch.ops.kfc.rope_rotate.default(q, k, *tables),
            rope_rotate_custom_op=lambda: custom(q, k, *tables))
    out["dispatch_host_us"] = _host_us(fns)


def _timed_cases():
    import torch

    bf = torch.bfloat16
    return (("decode.bf16.serve", ("decode", bf, False, 8, 1, 18, 288, SERVE_POS, 1)),
            ("decode.int8.serve", ("decode", bf, True, 8, 1, 18, 288, SERVE_POS, 14)),
            ("decode.bf16.2048", ("decode", bf, False, 8, 1, 128, 2048, LONG_POS, 3)),
            ("decode.int8.2048", ("decode", bf, True, 8, 1, 128, 2048, LONG_POS, 4)))


def _host_ms(case, n=200):
    """Host time to enqueue one call: a host clock around ``n`` calls
    that are not waited for (fewer than the launch queue holds)."""
    import time

    import torch

    case.call(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        case.call(False, i)
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


def paged_section(c, out):
    import torch

    bf = torch.bfloat16
    for name, args in _timed_cases() + (
            ("prefill.bf16.serve", ("prefill", bf, False, 1, 16, 18, 288, [240], 2)),):
        case = c.Case(*args)
        r = case.run(name, profiled=True)
        out["paged/" + name] = {x: r.get(x) for x in (
            "ms", "library_ms", "bound_ms", "plain_ms", "max_abs_err",
            "device_ms_by_kernel", "parts")}
        out["paged/" + name]["host_ms"] = _host_ms(case)
        del case
        torch.cuda.empty_cache()


_PROFILE = re.compile(r"profile\[([^\]]*)\] .*: wall (\S+) ms, device (\S+) ms in (\d+) kernels, "
                      r"idle share (\S+), by kernel: (.*)$")


def serve_section(c, smi, out):
    """``profile_phase`` logs its readings: they are read back from the
    log lines, so both trees are measured by their own code."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.ops import paged_attention as pa

    lines, log = [], c.log
    c.log = lambda msg: (lines.append(msg), log(msg))
    try:
        cfg = tfm.llama3_8b_config()
        params = tfm.init_params(cfg, seed=1, device="cuda", dtype=cfg.dtype)
        c.profile_phase(cfg, params)
    finally:
        c.log = log
    del params
    torch.cuda.empty_cache()
    for ln in lines:
        m = _PROFILE.match(ln)
        if m:
            out[f"profile/{m.group(1)}"] = dict(
                wall_ms=float(m.group(2)), device_ms=float(m.group(3)),
                launches=int(m.group(4)), idle_share=float(m.group(5)),
                by_kernel=json.loads(m.group(6)))
    torch.cuda.synchronize()
    pa.reset_launches()
    # Bucketed prefill named: the default before exact prefill was ported,
    # so that trees from before and after compare the same path.
    res = serve(config="llama3_8b", batch=16, slots=8, prompt_len=256, max_new_tokens=32,
                block_size=16, prefill_mode="bucketed",
                output_file=os.path.join(c.OUT_DIR, "ab_serve.jsonl"))
    torch.cuda.synchronize()
    out["serve/fp"] = {**{k: res[k] for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                                              "tokens_per_sec", "wall_s")},
                       "launches": dict(pa.LAUNCHES)}


def main(root: str, tag: str, *sections: str) -> int:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sections = sections or SECTIONS
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        print(f"chip_ab: unknown sections {sorted(unknown)}; take {SECTIONS}", file=sys.stderr)
        return 2
    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = c.device_phase()
    out = {}
    if "flash" in sections:
        flash_section(c, smi, out)
    if "train" in sections:
        train_section(c, smi, out)
    if "paged" in sections:
        paged_section(c, out)
    if "serve" in sections:
        serve_section(c, smi, out)
    if "dispatch" in sections:
        dispatch_section(c, smi, out)
    print("AB " + json.dumps({"tag": tag, "smi": smi, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
