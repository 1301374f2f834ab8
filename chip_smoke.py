#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit, and the kernels' build
   (one ``nvcc`` per ``kubeflow_controller_tpu_torch/csrc/*.cu``, all
   started together) with its time and ``ptxas``'s registers and spills
   per kernel;
2. kernels vs plain: every paged-attention entry (decode, chunk prefill,
   verify) in bf16, int8-pool and fp32 forms, at the serving path's own
   shapes and at llama3_8b attention shapes up to 2048 columns, held
   against its plain PyTorch version on the same inputs on the card;
   each kernel's time beside the plain version's, a PyTorch library call
   on the gathered view (``scaled_dot_product_attention``, a yardstick
   only) and the least time the card could take; the serving prefill
   chunk also by kernel on the device; checked, not timed, a prefill at
   offset 0, a tail chunk of 8 rows and an int8 verify at pos 0;
3. flash kernels vs plain: the forward and the three backward kernels at
   the flagship's attention shape (B16 H8 S1024 D128) and llama3_8b's
   (B2 H32/8 S2048 D128), bf16 with rope tables, with and without
   segment ids; the same four numbers each, SDPA (forward, or forward
   and backward) as the yardstick, the fused kernel's dq run to run and
   the two-pass dq kernel's bit for bit run to run. At head_dim 64 and
   128 the two-pass kernels are held against plain versions on the q
   and k the rope prepass rotates, and the whole two-pass backward and
   the fused route at llama3_8b's shape are timed as yardsticks.
   The fused backward is timed as the whole call (rope prepass, delta
   prepass, kernel, dq postprocess) and by kernel; its prepass and
   postprocess are held against their plain versions and timed alone;
   The forward is timed as the whole call (rope prepass and forward
   kernel) and by kernel on the device; its prepass is held bit for bit
   against its plain version and timed alone; ragged sequences at
   head_dim 64 and 128 and head_dim 256 (the first forward kernel's
   route) are checked, not timed;
4. int8 kernel vs plain: the fused dynamic-int8 matmul (B7: row-quantize
   prepass and int8 GEMM) at the seven projection shapes of the int8
   train runs and at 256x128x384, bit for bit against its plain version,
   on rows with an outlier, all zeros and exact .5 ties, and the prepass
   alone bit for bit; the whole call's time (with the re-layout of the
   rhs codes) and its parts beside the plain version's,
   ``torch._int_mm`` on the same codes and a bf16 ``torch.mm``; a shape
   it does not tile must raise;
5. serve: ``serve(config="llama3_8b", batch=16, slots=8, prompt_len=256,
   max_new_tokens=32, block_size=16)`` at full width and depth with the
   kernels' launch counts zeroed just before and read just after; then 4
   requests with an int8 KV pool; then, on one set of llama3_8b weights,
   a profile of one decode micro-step and one prefill chunk (wall time,
   device time by kernel, idle share) and one request's first-token and
   next-token logits under ``attn_impl="kernel"`` and ``"gather"``;
6. train: bench.py's flagship decoder (B16 S1024, 16 layers, remat) and
   llama3_8b at full width and 2 layers (B2 S2048), 8 steps each through
   ``TrainLoop``; the flagship with int8 projections, ``"int8_fused"``
   (8 steps) and ``"int8"`` (4), and llama3_8b with ``"int8_fused"`` (4);
   each with the flash and B7 launch counts zeroed just before and
   checked exactly just after, a falling finite loss, step time,
   tokens/s, MFU, a profiled step's idle share and peak memory; the
   flagship through the entry point ``lm.train`` (``attn="auto"``), 4
   steps in bf16 and 4 with ``quant="int8_fused", opt8bit=True`` (exact
   counts, every step's metrics); then one flagship batch's loss and
   gradients under the flash kernels vs the plain attention and under
   ``"int8_fused"`` vs ``"int8"``, and the tiny config trained on the
   card vs the CPU;
7. a ``kernels`` JSON line (each kernel's whole-call time over its
   library call's, ``vs_library``, from this run), the ``nvidia-smi``
   line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and writes only under
``kubeflow_controller_tpu_torch/_build/`` beside itself (the kernels'
library, the compiler log, every line it prints as ``log.txt`` and the
served completions).
"""

from __future__ import annotations

import itertools
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
# the operation rate of each input type the kernels take (int8: 1,979
# TOPS on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}

# Kernel vs plain tolerances, with their reasons:
# * bf16 (and bf16 queries over int8 pools): both sides compute in fp32
#   and round the output to bf16 once; the online softmax sums in another
#   order (~1e-6 relative), which can put the two fp32 results on either
#   side of a bf16 rounding boundary: one bf16 ulp, <= 2^-7 relative.
# * fp32: only the summation order differs.
TOL = {"bfloat16": dict(rtol=1.6e-2, atol=1e-3),
       "float32": dict(rtol=1e-4, atol=1e-4)}
# Flash kernels vs their plain versions (bf16 in, fp32 scores, softmax
# and accumulators on both sides), with their reasons:
# * o: the kernel rounds p to bf16 against the running max of its
#   k-tile (128 columns; 64 or 32 off head_dim 64 and 128), the plain
#   version against the row's final max, so
#   each p may differ by 2^-8 relative and o = sum(p v) / l by up to 2^-8
#   of the largest |v| (atol_of_vmax); the output's own rounding adds one
#   bf16 ulp (<= 2^-7 relative, rtol).
# * lse: fp32 sums of the same p in another order (~1e-6 relative of
#   values below ~20).
# * dq, dk, dv: p and ds are rounded to bf16 before their products on
#   both sides; a ds that straddles a rounding boundary moves a sum by
#   one ulp of one term, far below 2e-3 of the largest gradient element,
#   and the output rounding adds one ulp (rtol).
# * dq of the fused kernel: its fp32 tile sums meet through atomicAdd in
#   a launch-dependent order, so two launches on the same inputs may
#   differ by one bf16 ulp (2^-7 relative) plus the fp32 order's
#   1e-5 of the largest element: DQ_RUN_TO_RUN.
FLASH_TOL = {"o": dict(rtol=1.6e-2, atol_of_vmax=2 ** -8),
             "lse": dict(rtol=0.0, atol=1e-4),
             "grad": dict(rtol=1.6e-2, atol_of_max=2e-3)}
DQ_RUN_TO_RUN = dict(rtol=2 ** -7, atol_of_max=1e-5)
# Train step, flash kernels vs the plain "xla" attention on the card, one
# flagship batch and one set of weights: both run bf16 activations with
# fp32 softmax but round attention at different points (the kernel p per
# tile and o once; the plain path its probabilities against the row max
# and its value product's output), and the difference carries through 16
# layers forward and back. Each limit is about twice the reading of the
# H100 run that set it: the loss read 1.7e-6 relative (at init it sits
# near ln(vocab) whatever the attention, so this limit alone would not
# catch a wrong attention; the gradients do), the gradient as a whole
# 2.48e-2 relative L2, the worst leaf 2.9e-2.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_REL_L2_TOL = 5e-2
TRAIN_GRAD_LEAF_REL_L2_TOL = 6e-2
# One flagship batch under quant="int8_fused" and "int8" with the plain
# attention: in bf16 the two compute one function (the fused path's bf16
# lhs and output are the roundings a bf16 model makes anyway), the int8
# sums are exact in both, and every other operation is the same code on
# the same inputs, so the loss and the gradients should agree bit for
# bit; a difference would come from a reduction whose order varies from
# run to run (none is expected on this path). Limits: the loss within
# 1e-6 relative, the worst leaf within 1e-4 relative L2.
INT8_LOSS_REL_TOL = 1e-6
INT8_GRAD_LEAF_REL_L2_TOL = 1e-4
# The tiny config (fp32, head_dim 16: the plain attention on both
# devices) trained 3 steps on the card and on the CPU from one CPU-drawn
# init: the two differ only in summation order (TF32 off).
TINY_LOSS_REL_TOL = 1e-4

# kernel vs gather logits on the served model (bf16, 32 layers): the two
# paths round attention at different points (the kernel once at its
# output, the gather path its softmax probabilities before a bf16
# matmul), and the difference carries through every layer.
LOGITS_REL_L2_TOL = 5e-2


def log(msg: str) -> None:
    """Print a line and keep it in ``OUT_DIR/log.txt`` (the whole run's
    lines, for a caller that sees only the end of the output)."""
    print(msg, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "log.txt"), "a") as f:
        f.write(msg + "\n")


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


def _kernels_ms(fn, iters: int = 10):
    """Device time of one call of ``fn`` by kernel (``torch.profiler``,
    the mean over ``iters`` calls), largest first: what the card spends
    on the call when the host keeps its queue full, as a train step
    does. The event-timed ``ms`` of a short call also holds the host's
    time to enqueue it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            if us > 0:
                out[evt.key[:60]] = us / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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

    def parts(self):
        """The kernel this call launches (``kfc_paged_chunk``'s rule)."""
        import torch

        from kubeflow_controller_tpu_torch.ops import paged_attention as pa

        if self.kind == "decode":
            return ["paged_decode_kernel"]
        if self.dtype == torch.bfloat16 and self.D in pa.MMA_HEAD_DIMS:
            return ["paged_chunk_mma_kernel"]
        return ["paged_chunk_kernel"]

    def run(self, name: str, timed: bool = True, profiled: bool = False):
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
        if not timed:
            rec = dict(case=name, max_abs_err=max_abs, parts=self.parts())
            log("kernel-case " + json.dumps(rec))
            return rec
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
                   bytes=byts, operations=ops, parts=self.parts())
        if profiled:
            rec["device_ms_by_kernel"] = _kernels_ms(
                self._rotating(lambda i: self.call(False, i)))
        log("kernel-case " + json.dumps(rec))
        return rec


def _close(got, want, rtol, atol):
    """(ok, max |err|) for got vs want, elementwise
    |got - want| <= atol + rtol * |want|."""
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    ok = not bool(bad.any()) and bool(torch.isfinite(got.float()).all())
    return ok, float(err.max())


class FlashCase:
    """The four flash kernels at one attention shape of the train path:
    bf16 q/k/v/do drawn on the card, rope tables at per-row position
    offsets, optionally packed segment ids (with a padding tail of id
    0). The backward kernels take the plain forward's o and lse, so each
    kernel and its plain version see the same inputs."""

    def __init__(self, label, B, H, KVH, S, D, segments, seed, causal=True):
        import torch

        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        self.label, self.B, self.H, self.KVH, self.S, self.D = label, B, H, KVH, S, D
        self.causal = causal
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        self.q, self.do = randn(B, S, H, D), randn(B, S, H, D)
        self.k, self.v = randn(B, S, KVH, D), randn(B, S, KVH, D)
        pos = (torch.arange(S, device=dev)[None, :]
               + torch.arange(B, device=dev)[:, None] * 17)
        self.rope = fa.rope_full_tables(pos, D, 500000.0)
        self.seg = None
        if segments:
            # Documents of S/8 .. S/2 tokens, the last ~S/16 rows padding.
            cut = torch.randint(S // 8, S // 2, (B, 8), generator=gen, device=dev)
            starts = cut.cumsum(1)
            idx = torch.arange(S, device=dev)
            seg = 1 + (idx[None, :, None] >= starts[:, None, :]).sum(-1)
            seg[:, S - S // 16:] = 0
            self.seg = seg.to(torch.int32)
        self.o, self.lse = fa.flash_fwd_plain(self.q, self.k, self.v, self.seg,
                                              self.rope, causal)
        self.delta = fa.attention_delta(self.o, self.do)
        mask = fa._visible(S, self.seg, causal, dev)
        self.pairs = (B * S * S if mask is None                 # visible (q, k) pairs
                      else int(mask.expand(B, 1, S, S).sum()))

    def calls(self):
        """kernel name -> (kernel call, plain call, output names)."""
        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        q, k, v, do, o, lse, delta = (self.q, self.k, self.v, self.do, self.o,
                                      self.lse, self.delta)
        a = (self.seg, self.rope, self.causal)
        dkdv_plain, dq_plain = fa.flash_bwd_dkdv_plain, fa.flash_bwd_dq_plain
        qp, kp = q, k
        if self.D in fa.WGMMA_HEAD_DIMS:
            # The two-pass kernels at head_dim 64 and 128 run on q and k
            # rotated by the prepass (bit for bit _rope_rot): their plain
            # versions take the same rotated tiles.
            dkdv_plain = fa.flash_bwd_dkdv_rotated_plain
            dq_plain = fa.flash_bwd_dq_rotated_plain
            qp, kp = fa._rotated(q, k, self.rope)
        return {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *a),
                          lambda: fa.flash_fwd_plain(q, k, v, *a), ("o", "lse")),
            "flash_bwd_fused": (
                lambda: fa.flash_bwd_fused(q, k, v, o, lse, do, *a),
                lambda: fa.flash_bwd_fused_plain(q, k, v, o, lse, do, *a),
                ("dq", "dk", "dv")),
            "flash_bwd_dkdv": (
                lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, *a),
                lambda: dkdv_plain(qp, kp, v, do, lse, delta, *a),
                ("dk", "dv")),
            "flash_bwd_dq": (
                lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, *a),),
                lambda: (dq_plain(qp, kp, v, do, lse, delta, *a),),
                ("dq",)),
        }

    def cost(self, kernel):
        """(bytes, operations) of one call on these inputs: each input read
        once, each output written once; two operations per multiply-add
        over the visible (q, k) pairs only."""
        B, S, H, KVH, D = self.B, self.S, self.H, self.KVH, self.D
        qo = B * S * H * D * 2                  # one bf16 [B, S, H, D]
        kv = B * S * KVH * D * 2
        stat = B * H * S * 4                    # one fp32 [B, H, S]
        side = 2 * B * S * D * 4 + (B * S * 4 if self.seg is not None else 0)
        products = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dkdv": 4,
                    "flash_bwd_dq": 3}[kernel]
        ops = 2 * products * H * D * self.pairs
        byts = {
            "flash_fwd": 2 * qo + 2 * kv + stat,                  # q,k,v in; o, lse out
            "flash_bwd_fused": 3 * qo + 2 * kv + stat + qo + 2 * kv,  # q,k,v,o,do,lse; dq,dk,dv
            "flash_bwd_dkdv": 2 * qo + 2 * kv + 2 * stat + 2 * kv,    # q,k,v,do,lse,delta; dk,dv
            "flash_bwd_dq": 2 * qo + 2 * kv + 2 * stat + qo,          # ...; dq
        }[kernel] + side
        return byts, ops

    def library(self, kernel):
        """One SDPA call on the same q/k/v (rope applied, KV heads
        repeated, mask built beforehand): forward for the forward kernel,
        forward and backward for the backward kernels."""
        import torch
        import torch.nn.functional as F

        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        rep = self.H // self.KVH
        qr, kr = fa._rotated(self.q, self.k, self.rope)
        qh = qr.transpose(1, 2).contiguous()
        kh = kr.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        vh = self.v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        doh = self.do.transpose(1, 2).contiguous()
        kw = dict(is_causal=self.causal)
        if self.seg is not None:
            kw = dict(attn_mask=fa._visible(self.S, self.seg, self.causal, qh.device))
        if kernel == "flash_fwd":
            return lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)
        leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]

        def fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, **kw)
            return torch.autograd.grad(out, leaves, doh)

        return fwd_bwd

    def _tol(self, name, want):
        if name == "o":
            t = FLASH_TOL["o"]
            return dict(rtol=t["rtol"], atol=t["atol_of_vmax"]
                        * float(self.v.float().abs().max()))
        if name == "lse":
            return FLASH_TOL["lse"]
        t = FLASH_TOL["grad"]
        return dict(rtol=t["rtol"],
                    atol=t["atol_of_max"] * float(want.float().abs().max()))

    def check_bwd_parts(self, timed, bad):
        """The fused backward's prepass and postprocess against their plain
        versions (head_dim 64 and 128 only; other head dims run one kernel):
        delta within D * 2^-24 of each row's sum of |dO * O| (fp32 sums of
        the same products in another order), the dq scratch exactly zero,
        and the postprocess bit for bit (both round two fp32 products,
        their sum and one cast) on random fp32 rows. Returns the record's
        additions; disagreements go to ``bad``."""
        import torch

        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        if self.D not in fa.WGMMA_HEAD_DIMS:
            return {"parts": ["flash_bwd_kv_kernel<true>"]}
        delta, acc = fa.flash_bwd_prep(self.o, self.do)
        prod = self.do.float() * self.o.float()
        want = prod.sum(-1).transpose(1, 2)
        tol = self.D * 2.0 ** -24 * prod.abs().sum(-1).transpose(1, 2)
        delta_err = float((delta - want).abs().max())
        if bool(((delta - want).abs() > tol).any()) or bool(acc.any()):
            bad.append(f"flash_bwd_prep[{self.label}]: delta max |err| {delta_err} "
                       f"past D * 2^-24 * sum|dO O|, or the dq scratch is not zero")
        gen = torch.Generator(device="cuda").manual_seed(40)
        dq_acc = torch.randn(self.q.shape, generator=gen, device="cuda")
        rope = self.rope
        n_post = int((fa.flash_bwd_post(dq_acc, rope)
                      != fa.flash_bwd_post_plain(dq_acc, rope)).sum())
        if n_post:
            bad.append(f"flash_bwd_post[{self.label}]: {n_post} elements differ "
                       "from the plain version")
        out = dict(parts=["rope_rotate_kernel", "flash_bwd_prep_kernel",
                          "flash_bwd_wgmma_kernel", "flash_bwd_post_kernel"],
                   prep_delta_max_abs_err=delta_err, post_mismatches=n_post)
        if timed:
            out.update(
                prep_ms=_time_ms(lambda: fa.flash_bwd_prep(self.o, self.do)),
                prep_plain_ms=_time_ms(lambda: (fa.attention_delta(self.o, self.do),
                                                torch.zeros_like(dq_acc))),
                post_ms=_time_ms(lambda: fa.flash_bwd_post(dq_acc, rope)),
                post_plain_ms=_time_ms(lambda: fa.flash_bwd_post_plain(dq_acc, rope)))
        del delta, acc, prod, want, tol, dq_acc
        return out

    def check_two_pass_parts(self, kernel, timed, bad):
        """The two-pass kernels' parts: at head_dim 64 and 128 the rope
        prepass and the warpgroup kernel (the delta prepass, which the
        backward runs before both passes, without its dq scratch: delta
        within D * 2^-24 of each row's sum of |dO * O|, as the fused
        backward's); the first kernels elsewhere. Returns the record's
        additions; disagreements go to ``bad``."""
        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        if self.D not in fa.WGMMA_HEAD_DIMS:
            return {"parts": [{"flash_bwd_dkdv": "flash_bwd_kv_kernel<false>",
                               "flash_bwd_dq": "flash_bwd_dq_kernel"}[kernel]]}
        out = {"parts": ["rope_rotate_kernel",
                         {"flash_bwd_dkdv": "flash_bwd_wgmma_kernel<D, false>",
                          "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel"}[kernel]]}
        if kernel == "flash_bwd_dkdv":
            delta, scratch = fa.flash_bwd_prep(self.o, self.do, scratch=False)
            prod = self.do.float() * self.o.float()
            err = (delta - prod.sum(-1).transpose(1, 2)).abs()
            tol = self.D * 2.0 ** -24 * prod.abs().sum(-1).transpose(1, 2)
            if scratch is not None or bool((err > tol).any()):
                bad.append(f"flash_bwd_prep[{self.label}, no scratch]: delta max "
                           f"|err| {float(err.max())} past D * 2^-24 * sum|dO O|")
            out["prep_delta_max_abs_err"] = float(err.max())
            if timed:
                out["prep_ms"] = _time_ms(
                    lambda: fa.flash_bwd_prep(self.o, self.do, scratch=False))
            del delta, prod, err, tol
        return out

    def run(self, smi, timed, failures):
        """Check (and time) every kernel; a disagreement is appended to
        ``failures``."""
        import torch

        from kubeflow_controller_tpu_torch.ops import flash_attention as fa

        recs = {}
        a_all = (self.seg, self.rope, self.causal)
        for kernel, (call, plain, names) in self.calls().items():
            got, want = call(), plain()
            torch.cuda.synchronize()
            errs, bad = {}, []
            for n, g, w in zip(names, got, want):
                tol = self._tol(n, w)
                ok, errs[n] = _close(g, w, **tol)
                if not ok:
                    bad.append(f"{kernel}[{self.label}]: {n} disagrees with the "
                               f"plain version (max |err| {errs[n]}, tol {tol})")
            if kernel == "flash_bwd_dq" and self.D in fa.WGMMA_HEAD_DIMS:
                # No atomics: the same bits on every run.
                n_diff = int((call()[0] != got[0]).sum())
                if n_diff:
                    bad.append(f"{kernel}[{self.label}]: dq differs run to run "
                               f"in {n_diff} elements")
                errs["dq_run_to_run"] = n_diff
            if kernel == "flash_bwd_fused":
                again = call()[0]
                t = DQ_RUN_TO_RUN
                ok, e = _close(again, got[0], rtol=t["rtol"],
                               atol=t["atol_of_max"] * float(got[0].float().abs().max()))
                if not ok:
                    bad.append(f"{kernel}[{self.label}]: dq run to run max "
                               f"|diff| {e} past {t}")
                errs["dq_run_to_run"] = e
            extra = {}
            if kernel == "flash_bwd_fused":
                extra = self.check_bwd_parts(timed, bad)
            elif kernel in ("flash_bwd_dkdv", "flash_bwd_dq"):
                extra = self.check_two_pass_parts(kernel, timed, bad)
            if kernel != "flash_fwd" and timed and self.seg is None:
                extra["device_ms_by_kernel"] = _kernels_ms(call)
            if kernel == "flash_bwd_dq" and timed and self.seg is None:
                # Yardsticks, timed once: the whole two-pass backward as
                # the train step runs it (one rope prepass, the delta
                # prepass, both passes), and the fused route on the same
                # inputs, which the block rule does not take at S > 1024.
                args = (self.q, self.k, self.v, self.o, self.lse, self.do, *a_all)
                extra["two_pass_route_ms"] = _time_ms(
                    lambda: fa.flash_bwd_two_pass(*args))
                extra["fused_route_ms"] = _time_ms(lambda: fa.flash_bwd_fused(*args))
            rec = dict(kernel=kernel, case=self.label,
                       max_abs_err=max(v for k, v in errs.items()
                                       if k != "dq_run_to_run"),
                       errors=errs, **extra)
            if kernel == "flash_fwd":
                # The forward's prepass alone, bit for bit: both round
                # two fp32 products, their sum and the bf16 cast.
                rot = fa.rope_rotate(self.q, self.k, self.rope)
                n_bad = sum(int((r != fa._rope_rot(x, *self.rope)).sum())
                            for r, x in zip(rot, (self.q, self.k)))
                if n_bad:
                    bad.append(f"rope_rotate[{self.label}]: {n_bad} elements "
                               "differ from the plain version")
                wgmma = self.D in fa.WGMMA_HEAD_DIMS
                rec.update(rope_rotate_mismatches=n_bad,
                           parts=(["rope_rotate_kernel", "flash_fwd_wgmma_kernel"]
                                  if wgmma else ["flash_fwd_kernel"]))
                if timed:
                    rec["prepass_ms"] = _time_ms(
                        lambda: fa.rope_rotate(self.q, self.k, self.rope))
                    if self.seg is None:
                        rec["device_ms_by_kernel"] = _kernels_ms(call)
                        rec["library_device_ms_by_kernel"] = _kernels_ms(
                            self.library(kernel))
                del rot
            for msg in bad:
                log("FAIL " + msg)
            failures += bad
            del got, want
            if timed:
                byts, ops = self.cost(kernel)
                t_bytes = byts / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
                lib = self.library(kernel)
                rec.update(ms=_time_ms(call), plain_ms=_time_ms(plain, iters=3),
                           library_ms=_time_ms(lib, iters=10),
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=byts, operations=ops)
                del lib
            torch.cuda.empty_cache()
            log(f"flash-case {json.dumps(rec)} | {smi}")
            recs[kernel] = rec
        return recs


#: The flash kernels' shapes on the train path: the flagship's attention
#: (one tile per sequence: the fused backward) and llama3_8b's (two
#: passes); each with and without packed segment ids.
FLASH_SHAPES = {
    "flagship": dict(B=16, H=8, KVH=8, S=1024, D=128),
    "llama3_8b": dict(B=2, H=32, KVH=8, S=2048, D=128),
}
#: Checked, not timed: what the train path does not reach — a ragged
#: sequence (200 rows: a partial tile) at head_dim 64, causal and not; a
#: ragged one at head_dim 128 (1000 rows: 104 live rows in the last
#: 128-row tile); and head_dim 256, which the forward's first kernel
#: serves (32-row tiles, rope rotated on load).
FLASH_EXTRA = {
    "ragged.d64": dict(B=2, H=4, KVH=2, S=200, D=64),
    "ragged.d64.noncausal": dict(B=2, H=4, KVH=2, S=200, D=64, causal=False),
    "ragged.d128": dict(B=1, H=4, KVH=2, S=1000, D=128),
    "d256": dict(B=1, H=2, KVH=1, S=160, D=256),
}


def flash_kernel_phase(smi, timed=True):
    """Every flash kernel against its plain version at both shapes of the
    train path (timed) and the extra shapes (checked only), with and
    without segment ids; fails after all of them ran if any disagreed.
    Returns records by (kernel, case)."""
    import torch

    recs, failures = {}, []
    seed = 20
    for shapes, timed_here in ((FLASH_SHAPES, timed), (FLASH_EXTRA, False)):
        for shape, dims in shapes.items():
            for segments in (False, True):
                label = f"{shape}{'.seg' if segments else ''}"
                case = FlashCase(label, segments=segments, seed=seed, **dims)
                seed += 1
                for kernel, rec in case.run(smi, timed_here, failures).items():
                    recs[(kernel, label)] = rec
                del case
                torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{len(failures)} flash kernel checks failed; "
                             f"first: {failures[0]}")
    return recs


#: B7's shapes on the train path, (m, k, n): the flagship's projections at
#: B16 S1024 (q/k/v/o, gate/up and down forward; the same three shapes
#: are their dx) and llama3_8b's at B2 S2048 (wq/wo forward and dx, wk/wv
#: forward, wk/wv dx, gate/up forward).
INT8_SHAPES = {
    "flagship.qkvo": (16384, 1024, 1024),
    "flagship.gate_up": (16384, 1024, 4096),
    "flagship.down": (16384, 4096, 1024),
    "llama3_8b.wq_wo": (4096, 4096, 4096),
    "llama3_8b.wk_wv": (4096, 4096, 1024),
    "llama3_8b.wk_wv_dx": (4096, 1024, 4096),
    "llama3_8b.gate_up": (4096, 4096, 14336),
}


#: The shapes whose call is also split into device time by kernel.
INT8_PROFILED = ("flagship.gate_up", "flagship.down", "llama3_8b.gate_up")
#: Checked, not timed: N is not a multiple of 256 and K is a single 128
#: step, fewer than the GEMM's ring has stages.
INT8_EXTRA = {"edge.256x128x384": (256, 128, 384)}


def _int8_rows(m, k, gen):
    """bf16 rows with an outlier row, an all-zero row and a row of exact
    .5 ties (abs-max 127: scale 1)."""
    import torch

    a = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
    a[0] *= 1000
    a[1] = 0
    a[2] = torch.arange(k, device="cuda") % 254 - 126.5
    a[2, 0] = 127
    return a


def int8_kernel_phase(smi):
    """B7 against its plain version at every main-path shape and one edge
    shape, bit for bit (both quantize with an IEEE division, sum exactly
    in int32 and dequantize with two fp32 products in one order), on bf16
    rows that include an outlier row, an all-zero row and a row of exact
    .5 ties; the row-quantize prepass alone against its plain version,
    bit for bit too. Each main-path shape is timed as the whole call
    (the re-layout of the rhs codes to [n, k] that the forward's wrapper
    makes, the prepass and the GEMM), with its parts, beside the plain
    version, ``torch._int_mm`` on the same int8 codes (the product
    alone, a yardstick; with the rhs column-major, as the composed path
    passes it, and row-major) and a bf16 ``torch.mm`` of the same shape.
    A shape ``fusable`` refuses must raise. Returns records by shape."""
    import torch

    from kubeflow_controller_tpu_torch.ops import quant as q
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    recs, failures = {}, []
    gen = torch.Generator(device="cuda").manual_seed(30)
    for label, (m, k, n) in {**INT8_SHAPES, **INT8_EXTRA}.items():
        a = _int8_rows(m, k, gen)
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        qb, sb = q._quantize(w, axis=0)
        qb = qb.contiguous()
        qbt = qb.t().contiguous()                # the same codes as [n, k]
        got, want = qf._launch(a, qbt, sb), qf._fused_plain(a, qbt, sb)
        (qa, sa), (qa_p, sa_p) = qf.quantize_rows(a), qf.quantize_rows_plain(a)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        pre_mismatches = int((qa != qa_p).sum()) + int((sa != sa_p).sum())
        max_abs = float((got.float() - want.float()).abs().max())
        if mismatches or not bool(torch.isfinite(got).all()):
            failures.append(f"int8_matmul[{label}]: {mismatches} outputs differ "
                            f"from the plain version (max |err| {max_abs})")
        if pre_mismatches:
            failures.append(f"int8_quantize_rows[{label}]: {pre_mismatches} codes "
                            "or scales differ from the plain version")
        rec = dict(case=label, m=m, k=k, n=n, mismatches=mismatches,
                   prepass_mismatches=pre_mismatches, max_abs_err=max_abs)
        if label in INT8_SHAPES:
            qb_cm = qb.t().contiguous().t()      # the same codes, column-major
            wb = w.to(torch.bfloat16)
            byts = m * k * 2 + k * n + n * 4 + m * n * 2   # a, qb, sb in; out
            ops = 2 * m * k * n
            t_bytes = byts / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS["int8"] * 1e3
            rec.update(
                ms=_time_ms(lambda: qf._launch(a, qb.t().contiguous(), sb)),
                kernels_ms=_time_ms(lambda: qf._launch(a, qbt, sb)),
                device_ms_by_kernel=(_kernels_ms(
                    lambda: qf._launch(a, qb.t().contiguous(), sb))
                    if label in INT8_PROFILED else None),
                prepass_ms=_time_ms(lambda: qf.quantize_rows(a)),
                relayout_ms=_time_ms(lambda: qb.t().contiguous()),
                parts=["quantize_rows_kernel", "int8_gemm_kernel"],
                plain_ms=_time_ms(lambda: qf._fused_plain(a, qbt, sb), iters=5),
                library_ms=_time_ms(lambda: torch._int_mm(qa_p, qb_cm)),
                library="torch._int_mm on the same int8 codes, rhs column-major "
                        "(the product alone)",
                library_rhs_row_major_ms=_time_ms(lambda: torch._int_mm(qa_p, qb)),
                bf16_mm_ms=_time_ms(lambda: torch.mm(a, wb)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=byts, operations=ops)
            del qb_cm, wb
        log(f"int8-case {json.dumps(rec)} | {smi}")
        recs[label] = rec
        del a, w, qb, qbt, sb, got, want, qa, sa, qa_p, sa_p
        torch.cuda.empty_cache()
    a = torch.zeros((256, 100), device="cuda", dtype=torch.bfloat16)
    try:
        qf.fused_int8_matmul_2d(a, torch.zeros((100, 256), device="cuda"))
        failures.append("int8_matmul: the refused shape 256x100x256 did not raise")
    except ValueError as e:
        log(f"int8_matmul: 256x100x256 refused as it should be ({e})")
    if failures:
        for msg in failures:
            log("FAIL " + msg)
        raise AssertionError(f"{len(failures)} int8 kernel checks failed; "
                             f"first: {failures[0]}")
    return recs


def _ptxas_report(build_log):
    """One line per kernel from ``ptxas -v``: its (mangled) name, its
    registers and shared memory, and its stack frame and spills."""
    out, name, spills = [], "?", ""
    for ln in build_log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], ""
        elif "spill" in ln:
            spills = ln
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spills}")
    return out


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
    log(f"build: {os.path.basename(path)} in {seconds:.1f} s (nvcc, sm_90a)")
    for ln in _ptxas_report(build_log):
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
    # Checked, not timed: a prefill at offset 0 (no pool page live: the
    # intra-chunk tile alone), a tail chunk of 8 rows at offset 8, and an
    # int8 verify of one slot at pos 0.
    edge = [
        ("prefill.bf16.off0", Case("prefill", bf, False, 1, 16, 18, 288, [0], 11)),
        ("prefill.bf16.tail8", Case("prefill", bf, False, 1, 8, 18, 288, [8], 12)),
        ("verify.int8.pos0", Case("verify", bf, True, 1, 5, 18, 288, [0], 13)),
    ]
    recs = {}
    for name, case in cases + edge:
        recs[name] = case.run(name, timed=name not in dict(edge),
                              profiled=name == "prefill.bf16.serve")
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
    if "flash_bwd_wgmma" in name and ("false>" in name or "Lb0E" in name):
        return "flash_bwd_kv"          # the warpgroup kernel without dQ: B3
    for piece, kernel in (("paged_decode", "paged_decode"),
                          ("flash_bwd_prep", "flash_bwd_prep"),
                          ("flash_bwd_post", "flash_bwd_post"),
                          ("flash_bwd_wgmma", "flash_bwd_fused"),
                          ("paged_chunk", "paged_chunk"),
                          ("rope_rotate", "rope_rotate"),
                          ("flash_fwd", "flash_fwd"),
                          ("flash_bwd_kv", "flash_bwd_kv"),
                          ("flash_bwd_dq", "flash_bwd_dq"),
                          ("quantize_rows", "int8_quantize_rows"),
                          ("int8_gemm", "int8_matmul")):
        if piece in name and "_kernel" in name:
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
        buckets, launches, _ = _device_time(prof)
        device_ms = sum(buckets.values())
        idle = "not measured" if device_ms == 0 else 1 - device_ms / wall_ms
        log(f"profile[{name}] llama3_8b bf16: wall {wall_ms} ms, device "
            f"{device_ms} ms in {launches} kernels, idle share {idle}, by "
            f"kernel: " + json.dumps(buckets))


def _device_time(prof):
    """Device time of a ``torch.profiler`` run: (ms by kernel bucket,
    largest first; kernel launches; the ten kernels of most time as
    (name, ms, calls)). Annotated ranges (``record_function``, such as
    ``Optimizer.step#AdamW.step``) show on the device timeline too but
    span kernels already counted, so they are left out."""
    from torch.autograd import DeviceType

    buckets, launches, top = {}, 0, []
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue                          # host ops; annotated ranges
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us > 0:
            b = _kernel_bucket(evt.key)
            buckets[b] = buckets.get(b, 0.0) + us / 1e3
            launches += evt.count
            top.append((evt.key[:80], us / 1e3, evt.count))
    return (dict(sorted(buckets.items(), key=lambda kv: -kv[1])), launches,
            sorted(top, key=lambda t: -t[1])[:10])


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


def _step_profile(step, batch):
    """One train step (``step(batch)``) under ``torch.profiler``, timed on
    a host clock around the synchronised step: (wall ms, device ms, idle
    share = 1 - device / wall of that same step, device ms by kernel
    bucket, the ten kernels of most device time as (name, ms, calls))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch)["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    buckets, _, top = _device_time(prof)
    device_ms = sum(buckets.values())
    idle = "not measured" if device_ms == 0 else 1 - device_ms / wall_ms
    return wall_ms, device_ms, idle, buckets, top


def _reset_launches():
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    fa.reset_launches()
    qf.reset_launches()


def _launches():
    """The train path's kernel launches since :func:`_reset_launches`:
    the flash kernels' and B7's."""
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    return {**fa.LAUNCHES, **qf.LAUNCHES}


def train_run(label, cfg, seq, batch, steps, expect, smi):
    """Train ``cfg`` for ``steps`` steps through the port's ``TrainLoop``
    with the LM entry point's optimizer, on one batch of its synthetic
    stream fed every step (as bench.py feeds one fixed batch, so that
    the loss falls within a few steps), with the flash kernels' and B7's
    launch counts zeroed just before and read just after; the counts must
    equal ``expect`` (per step) exactly and the loss must be finite and
    fall. Returns the run's record (peak memory from the run's start)."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import synthetic_lm
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.optim import make_optimizer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(
        init_fn=tfm.make_init_fn(cfg), loss_fn=tfm.make_loss_fn(cfg),
        optimizer=make_optimizer(3e-4, steps),
        config=TrainLoopConfig(total_steps=steps, log_every=1), device="cuda")
    data = device_prefetch(
        itertools.repeat(next(synthetic_lm(cfg.vocab_size, batch, seq))), "cuda")
    records = []
    torch.cuda.synchronize()
    _reset_launches()
    loop.run(data, on_metrics=records.append)
    torch.cuda.synchronize()
    launches = _launches()
    want = {k: expect.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"train[{label}]: launches {launches} != {want}")
    losses = [m.loss for m in records]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train[{label}]: losses {losses} not finite and falling")
    # Steps 1 and 2 carry the allocator's warm-up; the rest are steady.
    step_s = sorted(1 / m.steps_per_sec for m in records[2:])
    med = step_s[len(step_s) // 2]
    tokens = batch * seq
    wall_ms, device_ms, idle, by_kernel, top = _step_profile(loop.step, next(data))
    rec = dict(
        run=label, steps=steps, losses=losses, step_ms=med * 1e3,
        step_ms_all=[1e3 / m.steps_per_sec for m in records],
        tokens_per_s=tokens / med,
        mfu=tfm.train_flops_per_token(cfg, seq) * tokens / med / PEAK_OPS["bfloat16"],
        profiled_step_wall_ms=wall_ms, profiled_step_device_ms=device_ms,
        idle_share=idle, device_ms_by_kernel=by_kernel, top_kernels=top,
        launches=launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        params=tfm.count_params(loop.state.params))
    log(f"train[{label}] {json.dumps(rec)} | {smi}")
    del loop, data
    torch.cuda.empty_cache()
    return rec


def lm_train_run(smi, steps=4, quant="", opt8bit=False):
    """The LM entry point a TPUJob runs, ``lm.train``, on the named bf16
    config ``"flagship"`` at S=1024, B=16 with its default ``attn="auto"``
    (and ``quant``, ``opt8bit``): the auto dispatch must choose the flash
    kernels (bf16 CUDA tensors under the JAX shape rule). The launch
    counts are zeroed just before and must be exact just after (B7: 21
    per layer and step under ``"int8_fused"``); the metrics stream the
    entry point writes must hold every step with a finite loss, the last
    below the first (a new batch every step, so not every step falls). The last
    step runs under ``torch.profiler`` for its idle share. Returns the
    run's record."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane import train as dtrain
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    label = "+".join(["flagship"] + [x for x in (quant, "opt8bit" * opt8bit) if x])
    log_dir = os.path.join(OUT_DIR, f"lm_train_{label}")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "metrics-p0.jsonl")
    if os.path.exists(path):
        os.remove(path)
    cfg = lm.model_config("flagship")
    layers = cfg.n_layers
    profiled = {}
    step_fn = dtrain.TrainLoop.step

    def step_profiling_the_last(loop, batch):
        if loop.state.step != steps - 1:
            return step_fn(loop, batch)
        metrics = {}

        def one(b):
            metrics.update(step_fn(loop, b))
            return metrics

        profiled["wall_ms"], profiled["device_ms"], profiled["idle"], _, _ = \
            _step_profile(one, batch)
        return metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    dtrain.TrainLoop.step = step_profiling_the_last
    try:
        out = lm.train(ProcessContext(log_dir=log_dir), config="flagship",
                       total_steps=steps, per_data_shard_batch=16, seq_len=1024,
                       quant=quant, opt8bit=opt8bit)
    finally:
        dtrain.TrainLoop.step = step_fn
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    b7 = 21 * layers * steps if quant == "int8_fused" else 0
    want = {"rope_rotate": 3 * layers * steps, "flash_fwd": 2 * layers * steps,
            "flash_bwd_prep": layers * steps, "flash_bwd_fused": layers * steps,
            "flash_bwd_post": layers * steps, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0, "int8_quantize_rows": b7, "int8_matmul": b7}
    if launches != want:
        raise AssertionError(f"lm.train[{label}]: launches {launches} != {want}")
    rows = _read_completions(path)
    losses = [r["loss"] for r in rows]
    if ([r["step"] for r in rows] != list(range(1, steps + 1))
            or out["final_step"] != steps
            or not all(isinstance(x, float) and math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"lm.train[{label}]: metrics {rows}, result {out}")
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]
    steady = step_ms[1:-1]                 # not the first, not the profiled
    med = sum(steady) / len(steady)
    tokens = 16 * 1024
    rec = dict(run=f"lm.train[{label}]", steps=steps, losses=losses,
               step_ms=med, step_ms_all=step_ms, tokens_per_s=tokens / med * 1e3,
               mfu=tfm.train_flops_per_token(cfg, 1024) * tokens / (med / 1e3)
               / PEAK_OPS["bfloat16"],
               profiled_step_wall_ms=profiled["wall_ms"],
               profiled_step_device_ms=profiled["device_ms"],
               idle_share=profiled["idle"], launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall_s)
    log(f"lm.train[{label}] attn=auto {json.dumps(rec)} | {smi}")
    return rec


def flash_vs_plain(smi):
    """Loss and every gradient of one flagship batch under the flash
    kernels and under the plain attention, on one set of weights."""
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import synthetic_lm
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.flagship_config()
    params = tfm.init_params(cfg, seed=7, device="cuda")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tokens = torch.from_numpy(next(synthetic_lm(cfg.vocab_size, 16, 1024, seed=3))["tokens"])
    batch = {"tokens": tokens.cuda()}
    out = {}
    for impl in ("flash", "xla"):
        loss, _ = tfm.next_token_loss(cfg.replace(attn_impl=impl), params, batch)
        out[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    (lf, gf), (lx, gx) = out["flash"], out["xla"]
    loss_rel = abs(lf - lx) / abs(lx)
    num = sum(float((a.float() - b.float()).norm() ** 2) for a, b in zip(gf, gx))
    den = sum(float(b.float().norm() ** 2) for b in gx)
    grad_rel = math.sqrt(num / den)
    worst = max(float((a - b).norm() / b.norm()) for a, b in zip(gf, gx))
    log(f"train-check flagship flash vs plain: loss {lf} vs {lx} (rel {loss_rel}, "
        f"tol {TRAIN_LOSS_REL_TOL}), gradient rel L2 {grad_rel} (tol "
        f"{TRAIN_GRAD_REL_L2_TOL}), worst leaf {worst} (tol "
        f"{TRAIN_GRAD_LEAF_REL_L2_TOL}) | {smi}")
    if not (math.isfinite(lf) and loss_rel <= TRAIN_LOSS_REL_TOL
            and grad_rel <= TRAIN_GRAD_REL_L2_TOL
            and worst <= TRAIN_GRAD_LEAF_REL_L2_TOL):
        raise AssertionError("flash vs plain train step disagree")
    del params, leaves, out, gf, gx
    torch.cuda.empty_cache()


def tiny_train_check():
    """The tiny config (fp32) trained 3 steps on the card and on the CPU
    from one CPU-drawn init and one batch stream: the losses agree."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import synthetic_lm
    from kubeflow_controller_tpu_torch.dataplane.train import TrainLoop, TrainLoopConfig
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.optim import make_optimizer

    cfg = tfm.tiny_config()
    init = tfm.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cuda", "cpu"):
        loop = TrainLoop(
            init_fn=lambda seed, dev: {k: ({n: t.clone().to(dev) for n, t in v.items()}
                                          if isinstance(v, dict) else v.clone().to(dev))
                                       for k, v in init.items()},
            loss_fn=tfm.make_loss_fn(cfg), optimizer=make_optimizer(1e-2, 3),
            config=TrainLoopConfig(total_steps=3, log_every=1), device=device)
        stream = synthetic_lm(cfg.vocab_size, 4, 64, seed=1)
        recs = []
        loop.run(({k: torch.from_numpy(v).to(device) for k, v in b.items()}
                  for b in stream), on_metrics=recs.append)
        losses[device] = [m.loss for m in recs]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"train[tiny] fp32 cuda vs cpu losses {losses['cuda']} vs {losses['cpu']} "
        f"(max rel {rel}, tol {TINY_LOSS_REL_TOL})")
    if not rel <= TINY_LOSS_REL_TOL:
        raise AssertionError("tiny train: cuda and cpu losses disagree")


def int8_fused_vs_int8(smi):
    """Loss and every gradient of one flagship batch under
    ``quant="int8_fused"`` and ``"int8"``, on one set of weights, with the
    plain attention (the fused backward's dq atomics stay out). In bf16
    the two are one function: the fused kernel's bf16 lhs and bf16 output
    are the roundings a bf16 model makes anyway."""
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import synthetic_lm
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.flagship_config(attn_impl="xla")
    params = tfm.init_params(cfg, seed=9, device="cuda")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tokens = torch.from_numpy(next(synthetic_lm(cfg.vocab_size, 16, 1024, seed=4))["tokens"])
    batch = {"tokens": tokens.cuda()}
    out = {}
    for quant in ("int8_fused", "int8"):
        loss, _ = tfm.next_token_loss(cfg.replace(quant=quant), params, batch)
        out[quant] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    (lf, gf), (lc, gc) = out["int8_fused"], out["int8"]
    loss_rel = abs(lf - lc) / abs(lc)
    rels = [float((a.float() - b.float()).norm() / b.float().norm()) for a, b in zip(gf, gc)]
    equal = sum(bool(torch.equal(a, b)) for a, b in zip(gf, gc))
    log(f"train-check flagship int8_fused vs int8 (attn xla): loss {lf} vs {lc} "
        f"(rel {loss_rel}, tol {INT8_LOSS_REL_TOL}), worst leaf rel L2 {max(rels)} "
        f"(tol {INT8_GRAD_LEAF_REL_L2_TOL}), {equal} of {len(rels)} leaves bit-equal "
        f"| {smi}")
    if not (math.isfinite(lf) and loss_rel <= INT8_LOSS_REL_TOL
            and max(rels) <= INT8_GRAD_LEAF_REL_L2_TOL):
        raise AssertionError("int8_fused vs int8 train step disagree")
    del params, leaves, out, gf, gc
    torch.cuda.empty_cache()


def train_phase(smi):
    """The flagship (bench.py) and llama3_8b at full width and 2 layers,
    each for a few steps with exact launch counts, in bf16 and with int8
    projections (the flagship under ``"int8_fused"`` and ``"int8"``,
    llama3_8b under ``"int8_fused"``); the flagship again through
    ``lm.train``, in bf16 and with int8_fused projections and 8-bit Adam;
    then flash vs plain and int8_fused vs int8 on one flagship batch, and
    the tiny config on card and CPU."""
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    flag = tfm.flagship_config()
    # The flagship's fused backward rotates q and k once more (its own
    # rope prepass) and has a prepass and a postprocess of its own.
    flag_flash = {"rope_rotate": 3 * flag.n_layers, "flash_fwd": 2 * flag.n_layers,
                  "flash_bwd_prep": flag.n_layers, "flash_bwd_fused": flag.n_layers,
                  "flash_bwd_post": flag.n_layers}
    runs = {
        "flagship": train_run("flagship", flag, 1024, 16, TRAIN_STEPS, flag_flash, smi),
    }
    llama = tfm.llama3_8b_config(n_layers=2, max_seq=2048, attn_impl="flash")
    # S=2048 takes the two-pass backward: one rope prepass shared by its
    # two passes (a third beside the forward's and remat's) and the delta
    # prepass.
    llama_flash = {"rope_rotate": 3 * llama.n_layers, "flash_fwd": 2 * llama.n_layers,
                   "flash_bwd_prep": llama.n_layers, "flash_bwd_dkdv": llama.n_layers,
                   "flash_bwd_dq": llama.n_layers}
    runs["llama3_8b"] = train_run("llama3_8b", llama, 2048, 2, TRAIN_STEPS,
                                  llama_flash, smi)
    # B7 per layer and step: the flagship's seven projections and their
    # seven dx are all fusable at M = 16384, and remat re-runs the seven
    # forwards: 21. llama3_8b at M = 4096: w_down's forward (k = 14336)
    # is composed, and so is its dx (a composed forward's backward is
    # composed, as in the JAX package), and the dx of w_gate and w_up
    # (contraction 14336): 6 + 6 + 4 = 16.
    runs["flagship.int8_fused"] = train_run(
        "flagship.int8_fused", flag.replace(quant="int8_fused"), 1024, 16,
        TRAIN_STEPS, {**flag_flash, "int8_quantize_rows": 21 * flag.n_layers,
                      "int8_matmul": 21 * flag.n_layers}, smi)
    runs["flagship.int8"] = train_run(
        "flagship.int8", flag.replace(quant="int8"), 1024, 16, INT8_STEPS,
        flag_flash, smi)
    runs["llama3_8b.int8_fused"] = train_run(
        "llama3_8b.int8_fused", llama.replace(quant="int8_fused"), 2048, 2,
        INT8_STEPS, {**llama_flash, "int8_quantize_rows": 16 * llama.n_layers,
                     "int8_matmul": 16 * llama.n_layers}, smi)
    runs["lm.train"] = lm_train_run(smi)
    runs["lm.train.int8_fused.opt8bit"] = lm_train_run(
        smi, INT8_STEPS, quant="int8_fused", opt8bit=True)
    flash_vs_plain(smi)
    int8_fused_vs_int8(smi)
    tiny_train_check()
    return runs


TRAIN_STEPS = 8
INT8_STEPS = 4

KERNELS = (
    ("paged_decode", "decode.bf16.serve", "ops/paged_attention_pallas.py:72"),
    ("paged_chunk", "prefill.bf16.serve", "ops/paged_attention_pallas.py:223"),
)
#: B7's record in the kernels line: the flagship's FFN gate/up shape; its
#: launches come from the flagship int8_fused run.
INT8_KERNEL_SHAPE = "flagship.gate_up"
#: (kernel, kernel-phase case of its main-path shape, TPU kernel, train run
#: whose launches it reports)
FLASH_KERNELS = (
    ("flash_fwd", "flagship", "ops/flash_attention.py:203", "flagship"),
    ("flash_bwd_fused", "flagship", "ops/flash_attention.py:766", "flagship"),
    ("flash_bwd_dkdv", "llama3_8b", "ops/flash_attention.py:621", "llama3_8b"),
    ("flash_bwd_dq", "llama3_8b", "ops/flash_attention.py:919", "llama3_8b"),
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
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "log.txt"), "w").close()

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    smi = phase("device", device_phase)
    recs = phase("paged kernels", kernel_phase)
    flash_recs = phase("flash kernels", flash_kernel_phase, smi)
    int8_recs = phase("int8 kernel", int8_kernel_phase, smi)
    runs = phase("serve", serve_phase, smi)
    phase("logits", logits_phase)
    train_runs = phase("train", train_phase, smi)
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
            "shape": case, "parts": r["parts"],
            **({"device_ms_by_kernel": r["device_ms_by_kernel"]}
               if "device_ms_by_kernel" in r else {}),
        })
    for name, case, replaces, run in FLASH_KERNELS:
        r = flash_recs[(name, case)]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "kubeflow_controller_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"kubeflow_controller_tpu/{replaces}",
            "launches": train_runs[run]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": case,
            # The forward's and the fused backward's ms are the whole call:
            # the rope prepass (timed alone) and the forward kernel; the
            # rope prepass, the delta prepass, the kernel and the dq
            # postprocess (the last two parts also timed alone). The
            # two-pass kernels' ms: the rope prepass and the kernel.
            **{k: r[k] for k in ("parts", "prepass_ms", "prep_ms", "post_ms",
                                 "device_ms_by_kernel", "two_pass_route_ms",
                                 "fused_route_ms") if k in r},
        })
    r = int8_recs[INT8_KERNEL_SHAPE]
    line["kernels"].append({
        "name": "int8_matmul", "route": "cuda",
        "source": "kubeflow_controller_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "kubeflow_controller_tpu/ops/quant_pallas.py:46",
        "launches": train_runs["flagship.int8_fused"]["launches"]["int8_matmul"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "library": r["library"],
        "shape": INT8_KERNEL_SHAPE,
        # ms is the whole call: the rhs codes' re-layout to [n, k], the
        # row-quantize prepass and the GEMM; each also timed alone.
        "parts": r["parts"], "prepass_ms": r["prepass_ms"],
        "kernels_ms": r["kernels_ms"], "relayout_ms": r["relayout_ms"],
    })
    # The factor that orders the kernel queue: whole call over the library
    # call, both from this run.
    for k in line["kernels"]:
        k["vs_library"] = k["ms"] / k["library_ms"]
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
