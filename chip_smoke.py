#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit, and the kernels' build
   (``nvcc`` from ``kubeflow_controller_tpu_torch/csrc``) with its time;
2. kernels vs plain: every paged-attention entry (decode, chunk prefill,
   verify) in bf16, int8-pool and fp32 forms, at the serving path's own
   shapes and at llama3_8b attention shapes up to 2048 columns, held
   against its plain PyTorch version on the same inputs on the card;
   each kernel's time beside the plain version's, a PyTorch library call
   on the gathered view (``scaled_dot_product_attention``, a yardstick
   only) and the least time the card could take;
3. serve: ``serve(config="llama3_8b", batch=16, slots=8, prompt_len=256,
   max_new_tokens=32, block_size=16)`` at full width and depth with the
   kernels' launch counts zeroed just before and read just after; then 4
   requests with an int8 KV pool; then, on one set of llama3_8b weights,
   a profile of one decode micro-step and one prefill chunk (wall time,
   device time by kernel, idle share) and one request's first-token and
   next-token logits under ``attn_impl="kernel"`` and ``"gather"``;
4. a ``kernels`` JSON line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and writes only under
``kubeflow_controller_tpu_torch/_build/`` beside itself (the kernels'
library, the compiler log and the served completions).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "kubeflow_controller_tpu_torch", "_build",
                       "chip_smoke")

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the operation rate of each input type the kernels take.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "int8": 989e12, "float32": 67e12}

# Kernel vs plain tolerances, with their reasons:
# * bf16 (and bf16 queries over int8 pools): both sides compute in fp32
#   and round the output to bf16 once; the online softmax sums in another
#   order (~1e-6 relative), which can put the two fp32 results on either
#   side of a bf16 rounding boundary: one bf16 ulp, <= 2^-7 relative.
# * fp32: only the summation order differs.
TOL = {"bfloat16": dict(rtol=1.6e-2, atol=1e-3),
       "float32": dict(rtol=1e-4, atol=1e-4)}
# kernel vs gather logits on the served model (bf16, 32 layers): the two
# paths round attention at different points (the kernel once at its
# output, the gather path its softmax probabilities before a bf16
# matmul), and the difference carries through every layer.
LOGITS_REL_L2_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Case:
    """One kernel call at fixed shapes: random inputs on the card, the
    kernel, its plain version, and SDPA over the gathered view. Pools
    are replicated (``copies``) and rotated between timed launches so
    the working set exceeds the 50 MB L2, as a 32-layer model's would."""

    def __init__(self, kind, dtype, quant, B, W, mb, width, pos, seed,
                 G=8, rep=4, D=128, bs=16):
        import torch

        self.kind, self.dtype, self.quant = kind, dtype, quant
        self.B, self.W, self.mb, self.width = B, W, mb, width
        self.G, self.rep, self.D, self.bs = G, rep, D, bs
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_pages = B * mb
        kv_dt = torch.int8 if quant else dtype
        page_bytes = bs * G * D * (1 if quant else dtype.itemsize) * 2
        self.copies = max(2, math.ceil(120e6 / (n_pages * page_bytes)))

        def pool():
            if quant:
                return torch.randint(-127, 128, (self.copies, n_pages, bs, G, D),
                                     generator=gen, device=dev, dtype=torch.int8)
            return torch.randn((self.copies, n_pages, bs, G, D),
                               generator=gen, device=dev, dtype=kv_dt)

        def scale():
            return (torch.rand((self.copies, n_pages, bs, G), generator=gen,
                               device=dev) * 0.19 + 0.01)

        self.k_pool, self.v_pool = pool(), pool()
        self.k_scale = scale() if quant else None
        self.v_scale = scale() if quant else None
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        tables = perm.to(torch.int32).reshape(B, mb)
        self.pos_list = list(pos)
        self.pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        # Entries past each row's last visible page are sentinels (id ==
        # n_pages, "unallocated"): the kernels must clamp and mask them.
        for b, p in enumerate(pos):
            last_col = p if kind == "decode" else p + W - 1
            tables[b, last_col // bs + 1:] = n_pages
        self.tables = tables
        shape_q = ((B, G, rep, D) if kind == "decode" else (B, W, G, rep, D))
        self.q = torch.randn(shape_q, generator=gen, device=dev, dtype=dtype)
        self.k_new = self.v_new = None
        if kind != "decode":
            self.k_new = torch.randn((B, W, G, D), generator=gen, device=dev,
                                     dtype=dtype)
            self.v_new = torch.randn((B, W, G, D), generator=gen, device=dev,
                                     dtype=dtype)
        self._i = 0

    def _layer(self, i):
        c = i % self.copies
        return (self.k_pool[c], self.v_pool[c],
                None if self.k_scale is None else self.k_scale[c],
                None if self.v_scale is None else self.v_scale[c])

    def call(self, plain: bool, i: int = 0):
        from kubeflow_controller_tpu_torch.ops import paged_attention as pa

        kp, vp, ks, vs = self._layer(i)
        kw = dict(k_scale=ks, v_scale=vs, width=self.width)
        if self.kind == "decode":
            fn = pa.paged_attention_decode_plain if plain else pa.paged_attention_decode
            return fn(self.q, kp, vp, self.tables, self.pos, **kw)
        if self.kind == "prefill" and not plain:
            return pa.paged_attention_prefill(
                self.q[0], self.k_new[0], self.v_new[0], kp, vp,
                self.tables[0], self.pos_list[0], **kw)[None]
        fn = pa.paged_chunk_attention_plain if plain else pa.paged_attention_verify
        return fn(self.q, self.k_new, self.v_new, kp, vp, self.tables,
                  self.pos, **kw)

    def _rotating(self, fn):
        def run():
            self._i += 1
            return fn(self._i)
        return run

    def sdpa_inputs(self):
        """Dense [B, H, S(+W), D] operands and the boolean mask, gathered
        once per pool copy outside the timed region."""
        import torch
        from kubeflow_controller_tpu_torch.ops.attention import paged_kv_view

        H = self.G * self.rep
        out = []
        cols = torch.arange(self.width, device=self.q.device)
        for c in range(self.copies):
            kp, vp, ks, vs = self._layer(c)
            k = paged_kv_view(kp, self.tables, self.width, ks, self.dtype)
            v = paged_kv_view(vp, self.tables, self.width, vs, self.dtype)
            k = k.transpose(1, 2).repeat_interleave(self.rep, dim=1)
            v = v.transpose(1, 2).repeat_interleave(self.rep, dim=1)
            if self.kind == "decode":
                q = self.q.reshape(self.B, H, 1, self.D)
                mask = (cols[None, :] <= self.pos[:, None])[:, None, None, :]
            else:
                q = self.q.permute(0, 2, 3, 1, 4).reshape(self.B, H, self.W, self.D)
                kn = self.k_new.transpose(1, 2).repeat_interleave(self.rep, dim=1)
                vn = self.v_new.transpose(1, 2).repeat_interleave(self.rep, dim=1)
                k, v = torch.cat([k, kn], 2), torch.cat([v, vn], 2)
                cached = (cols[None, :] < self.pos[:, None])[:, None, :]
                cached = cached.expand(self.B, self.W, self.width)
                causal = torch.ones(self.W, self.W, dtype=torch.bool,
                                    device=q.device).tril()
                mask = torch.cat(
                    [cached, causal[None].expand(self.B, -1, -1)], -1)[:, None]
            out.append((q.contiguous(), k.contiguous(), v.contiguous(), mask))
        return out

    def cost(self):
        """(bytes, operations) this call needs for THIS data: only the
        pool pages holding visible columns, each input read once and the
        output written once."""
        kv_item = 1 if self.quant else self.dtype.itemsize
        row_bytes = self.G * self.D * kv_item * 2 + (self.G * 4 * 2 if self.quant else 0)
        qo = self.q.numel() * self.dtype.itemsize * 2
        byts, ops = qo, 0
        for p in self.pos_list:
            if self.kind == "decode":
                cols = p + 1
                ops += 4 * cols * self.G * self.rep * self.D
            else:
                cols = p
                ops += 4 * self.G * self.rep * self.D * (
                    self.W * p + self.W * (self.W + 1) // 2)
            pages = -(-cols // self.bs)
            byts += pages * self.bs * row_bytes + pages * 4
        if self.kind != "decode":
            byts += 2 * self.k_new.numel() * self.dtype.itemsize
        return byts, ops

    def run(self, name: str):
        import torch
        import torch.nn.functional as F

        got = self.call(plain=False)
        want = self.call(plain=True)
        torch.cuda.synchronize()
        key = "float32" if self.dtype == torch.float32 else "bfloat16"
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        bad = err > TOL[key]["atol"] + TOL[key]["rtol"] * want.float().abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max |err| {max_abs}, {int(bad.sum())} elements past "
                f"rtol={TOL[key]['rtol']} atol={TOL[key]['atol']})")
        ms = _time_ms(self._rotating(lambda i: self.call(False, i)))
        plain_ms = _time_ms(self._rotating(lambda i: self.call(True, i)), iters=5)
        dense = self.sdpa_inputs()
        library_ms = _time_ms(self._rotating(
            lambda i: F.scaled_dot_product_attention(
                dense[i % self.copies][0], dense[i % self.copies][1],
                dense[i % self.copies][2], attn_mask=dense[i % self.copies][3])))
        del dense
        byts, ops = self.cost()
        type_key = "int8" if self.quant else key
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[type_key] * 1e3
        rec = dict(case=name, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=byts, operations=ops)
        log("kernel-case " + json.dumps(rec))
        return rec


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    from kubeflow_controller_tpu_torch.ops import _build

    path, seconds, build_log = _build.build()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as f:
        f.write(build_log)
    usage = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log(f"build: {os.path.basename(path)} in {seconds:.1f} s (nvcc, sm_90a)")
    for ln in usage:
        log(f"  ptxas: {ln}")
    _build.load()
    return smi


def kernel_phase():
    """Every entry, held against its plain version. Returns the records
    of the serving path's own shapes (slots 8, pages of 16 rows, 288
    columns) for the kernels line, and all records for the log."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    # The serving path's own shapes: 8 slots of a 288-column span (256
    # prompt + 32 new), decode past the prompt; the last full prefill
    # chunk at offset 240.
    serve_pos = [256, 263, 270, 277, 284, 287, 259, 266]
    long_pos = [2047, 0, 15, 16, 1000, 1535, 777, 2040]
    cases = [
        ("decode.bf16.serve", Case("decode", bf, False, 8, 1, 18, 288, serve_pos, 1)),
        ("prefill.bf16.serve", Case("prefill", bf, False, 1, 16, 18, 288, [240], 2)),
        ("decode.bf16.2048", Case("decode", bf, False, 8, 1, 128, 2048, long_pos, 3)),
        ("decode.int8.2048", Case("decode", bf, True, 8, 1, 128, 2048, long_pos, 4)),
        ("decode.fp32.2048", Case("decode", f32, False, 8, 1, 128, 2048, long_pos, 5)),
        ("prefill.bf16.1024", Case("prefill", bf, False, 1, 16, 128, 2048, [1024], 6)),
        ("prefill.int8.1024", Case("prefill", bf, True, 1, 16, 128, 2048, [1024], 7)),
        ("verify.bf16.2048", Case("verify", bf, False, 8, 5, 128, 2048,
                                  [2043, 0, 15, 16, 1000, 1535, 777, 2040], 8)),
        ("verify.int8.2048", Case("verify", bf, True, 8, 5, 128, 2048,
                                  [2043, 0, 15, 16, 1000, 1535, 777, 2040], 9)),
        ("verify.fp32.2048", Case("verify", f32, False, 8, 5, 128, 2048,
                                  [2043, 0, 15, 16, 1000, 1535, 777, 2040], 10)),
    ]
    recs = {}
    for name, case in cases:
        recs[name] = case.run(name)
        del case
        torch.cuda.empty_cache()
    return recs


def _read_completions(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def serve_phase(smi):
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.ops import paged_attention as pa

    vocab = tfm.llama3_8b_config().vocab_size
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = {}
    for label, batch, kv_quant in (("fp", 16, ""), ("int8", 4, "int8")):
        out_file = os.path.join(OUT_DIR, f"serve_{label}.jsonl")
        torch.cuda.synchronize()
        pa.reset_launches()
        res = serve(config="llama3_8b", batch=batch, slots=8, prompt_len=256,
                    max_new_tokens=32, block_size=16, kv_quant=kv_quant,
                    output_file=out_file)
        torch.cuda.synchronize()
        launches = dict(pa.LAUNCHES)
        comps = _read_completions(out_file)
        if len(comps) != batch:
            raise AssertionError(f"serve[{label}]: {len(comps)} of {batch} completions")
        for c in comps:
            toks = c["completion"]
            if len(toks) != 32 or not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"serve[{label}]: bad completion {c['rid']}: {toks}")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"serve[{label}]: kernel {k} never launched")
        log(f"serve[{label}] llama3_8b (d_model 4096, 32 layers, kv {kv_quant or 'bf16'}) "
            f"on {smi}: {batch} requests x 32 tokens, ttft_p50 {res['ttft_p50_ms']} ms, "
            f"ttft_p95 {res['ttft_p95_ms']} ms, tpot_p50 {res['tpot_p50_ms']} ms, "
            f"tokens/s {res['tokens_per_sec']}, wall {res['wall_s']} s, "
            f"prefill chunks {res['prefill_chunks']}, launches {launches}")
        runs[label] = (res, launches)

    # The repo's own reference on a small input: the tiny config in fp32
    # served with the kernels on the card and with their plain versions on
    # the CPU must commit the same greedy streams (TF32 is off, so the
    # two differ only in summation order, far below any argmax margin).
    # One weight set drawn on the CPU serves both: a CUDA generator draws
    # other numbers than a CPU one from the same seed.
    import numpy as np

    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )

    cfg = tfm.tiny_config()
    cpu_params = tfm.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 20))
    streams = {}
    for device in ("cuda", "cpu"):
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in cpu_params.items()}
        eng = ServingEngine(cfg, params, n_slots=3, max_seq=32, block_size=8,
                            device=device)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                       for i, p in enumerate(prompts)])
        streams[device] = [c.tokens for c in sorted(out, key=lambda c: c.rid)]
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"serve[tiny]: cuda streams {streams['cuda']} "
                             f"!= cpu streams {streams['cpu']}")
    log(f"serve[tiny] fp32: cuda kernels and cpu plain versions commit the "
        f"same {len(streams['cuda'])} greedy streams")
    return runs


def _kernel_bucket(name: str) -> str:
    for kernel in ("paged_decode", "paged_chunk"):
        if kernel + "_kernel" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas")):
        return "matmul"
    return "other"


def profile_phase(cfg, params):
    """Where a served step's time goes, at the serving path's shapes: one
    decode micro-step over 8 live slots of a 288-column span, and one
    16-row prefill chunk at offset 240. Wall time is a host clock around
    synchronised steps without the profiler; device time by kernel comes
    from ``torch.profiler``; idle share = 1 - device time / wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_controller_tpu_torch.models import generate as gen

    slots, mb, bs = 8, 18, 16
    cache = gen.init_paged_cache(cfg, slots, mb, slots * mb, bs, device="cuda")
    cache.tables = torch.arange(slots * mb, dtype=torch.int32,
                                device="cuda").reshape(slots, mb)
    cache.length.fill_(262)
    cache.active.fill_(True)
    gen_t = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (slots, 1), generator=gen_t).cuda()
    chunk = torch.randint(0, cfg.vocab_size, (1, bs), generator=gen_t).cuda()

    steps = {
        "decode micro-step (8 slots)": lambda: gen.decode_step_paged(
            cfg, params, toks, cache, view_width=mb * bs),
        "prefill chunk (16 rows)": lambda: gen.prefill_chunk_paged(
            cfg, params, chunk, cache, 0, 240, bs, view_width=mb * bs),
    }
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 3
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        buckets, launches = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue                      # host ops; kernels follow
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            if us > 0:
                b = _kernel_bucket(evt.key)
                buckets[b] = buckets.get(b, 0.0) + us / 1e3
                launches += evt.count
        device_ms = sum(buckets.values())
        idle = "not measured" if device_ms == 0 else 1 - device_ms / wall_ms
        log(f"profile[{name}] llama3_8b bf16: wall {wall_ms} ms, device "
            f"{device_ms} ms in {launches} kernels, idle share {idle}, by "
            f"kernel: " + json.dumps(
                {k: v for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])}))


def logits_phase():
    """One request's first-token logits (after 16 prefill chunks) and
    next-token logits (one decode step) under both attention impls, on
    the same llama3_8b weights."""
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.llama3_8b_config()
    params = tfm.init_params(cfg, seed=1, device="cuda", dtype=cfg.dtype)
    profile_phase(cfg, params)
    gen_t = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen_t).cuda()
    bs, mb = 16, 18
    out = {}
    for impl in ("kernel", "gather"):
        cache = gen.init_paged_cache(cfg, 1, mb, mb, bs, device="cuda")
        cache.tables[0] = torch.arange(mb, dtype=torch.int32, device="cuda")
        for off in range(0, 256, bs):
            first, cache = gen.prefill_chunk_paged(
                cfg, params, prompt[:, off:off + bs], cache, 0, off, bs,
                view_width=mb * bs, attn_impl=impl)
        cache.active[0] = True
        nxt, cache = gen.decode_step_paged(
            cfg, params, first.argmax(-1).to(torch.int32)[:, None], cache,
            view_width=mb * bs, attn_impl=impl)
        out[impl] = (first.float(), nxt.float())
    del params
    for i, name in enumerate(("first-token", "next-token")):
        a, b = out["kernel"][i], out["gather"][i]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} logits not finite")
        rel = float((a - b).norm() / b.norm())
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        if rel > LOGITS_REL_L2_TOL:
            raise AssertionError(
                f"{name} logits: kernel vs gather rel L2 {rel} > {LOGITS_REL_L2_TOL}")
        log(f"logits[{name}] kernel vs gather: rel L2 {rel} (tol {LOGITS_REL_L2_TOL}), "
            f"max |diff| {float((a - b).abs().max())}, argmax equal {same}")


KERNELS = (
    ("paged_decode", "decode.bf16.serve", "ops/paged_attention_pallas.py:72"),
    ("paged_chunk", "prefill.bf16.serve", "ops/paged_attention_pallas.py:223"),
)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "kubeflow_controller_tpu_torch")):
        print("chip_smoke: the port's package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = device_phase()
    recs = kernel_phase()
    runs = serve_phase(smi)
    logits_phase()
    launches = runs["fp"][1]
    line = {"kernels": []}
    for name, case, replaces in KERNELS:
        r = recs[case]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "kubeflow_controller_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"kubeflow_controller_tpu/{replaces}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": case,
        })
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
