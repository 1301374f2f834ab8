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
   against its plain PyTorch version on the same inputs on the card
   (verify also at the speculative serve run's shape: 8 slots, a window
   of 5, 288 columns);
   each kernel's time beside the plain version's, a PyTorch library call
   on the gathered view (``scaled_dot_product_attention``, a yardstick
   only) and the least time the card could take; the serving prefill
   chunk also by kernel on the device; checked, not timed, a prefill at
   offset 0, a tail chunk of 8 rows and an int8 verify at pos 0;
3. flash kernels vs plain: the forward and the three backward kernels at
   the flagship's attention shape (B16 H8 S1024 D128), llama3_8b's
   (B2 H32/8 S2048 D128) and llama3_8b's exact prefill (B1 H32/8 S256
   D128), bf16 with rope tables, with and without
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
   route) are checked, not timed; BERT-base's attention (B8 H12 S512
   D64, not causal, no rope tables, with and without segment ids) is
   timed as the other shapes are;
4. int8 kernel vs plain: the fused dynamic-int8 matmul (B7: row-quantize
   prepass and int8 GEMM) at the seven projection shapes of the int8
   train runs and at 256x128x384, bit for bit against its plain version,
   on rows with an outlier, all zeros and exact .5 ties, and the prepass
   alone bit for bit; the whole call's time (with the re-layout of the
   rhs codes) and its parts beside the plain version's,
   ``torch._int_mm`` on the same codes and a bf16 ``torch.mm``; a shape
   it does not tile must raise;
5. serve: ``serve(config=SERVE_CONFIG, batch=16, slots=8, prompt_len=256,
   max_new_tokens=32, block_size=16)`` (llama3_8b at full width and 4 of
   its 32 layers: the serving phases' depth, ``SERVE_CONFIG``) with the
   kernels' launch counts zeroed just before and read just after, in
   bucketed prefill (then 4 requests with an int8 KV pool) and in exact
   prefill (B1 once per layer per admission, no prefill chunk), TTFT and
   TPOT side by side; greedy speculative decoding (prompt lookup,
   ``draft_k=4``) on tiled prompts beside the plain exact run on them
   (verify = B6 once per layer per verify step; a stream may leave the
   plain one only after a near-tie, ``SPEC_FLIP_GAP_OF_RMS``); exact
   prefill of the flagship at prompt lengths on both sides of the flash
   gate (256, 300: B1; 1042: the dense path) against the dense path; the tiny
   config in fp32, card vs CPU, bucketed and exact, without and with
   speculation (an oracle proposer: drafts must be accepted); per-request
   sampling (temperature 0.8, top_k 50, top_p 0.95, seed 0): the 16
   requests sampled in exact prefill beside the greedy run, then in
   reverse order (each request must commit the same stream), 4 prompts
   x 4 copy-on-write forks (shared pages, boundary copies and every
   page back, predicted exactly), sampled speculation on the tiled
   prompts by lookup and by oracle drafts (B6 through the sampled
   verifier), 4 requests under a ``re:`` grammar (every token admissible
   on replay), ``sample_step_slots`` at [8, 128256] card vs CPU with its
   ms and launches beside the argmax's, and the tiny config's sampled
   traffic (greedy and sampled rows, n=2, a regex mask, sampled
   speculation) card vs CPU; then, on one set of llama3_8b weights at
   all 32 layers, a profile of one decode micro-step and one prefill
   chunk (wall time,
   device time by kernel, idle share) and one request's first-token and
   next-token logits under ``attn_impl="kernel"`` and ``"gather"``, both
   held against ``transformer.forward`` over the prompt and the first
   greedy token (B1 and its rope prepass once a layer);
5a. int8 serve: weight-only int8 ``(q, scale)`` card vs CPU bit for bit
   at llama3_8b's projection shapes; ``SERVE_CONFIG`` with ``quant="int8"``
   (the 16 requests in exact prefill, B1 once a layer an admission; the
   tiled prompts in bucketed prefill with lookup speculation; 4 requests
   on an int8 KV pool), exact launch counts, TTFT/TPOT/tokens/s beside
   the bf16 runs and the weight bytes of both; the tiny config's int8
   streams card vs CPU (exact and bucketed, fp and int8 KV, with and
   without speculation) under the near-tie rule;
5b. prefix (on one set of ``SERVE_CONFIG`` weights): 32 chat requests behind
   one 192-token system prompt with the prefix cache off and on (the hit
   count and the prefill chunks predicted from the schedule and checked
   exactly; streams equal but after a near-tie, ``SPEC_FLIP_GAP_OF_RMS``); 16
   families of 192-token prefixes in 3 waves through a pool of 128 pages
   with the host tier off and at 512 pages (equal streams, spills and
   rehydrates, their ms a page and GB/s beside a pinned ``copy_``, the
   leak sweep and ``reset()``), and int8 pages through one slot;
   ``serve(turns=3)`` with the cache (the hit rate predicted exactly)
   and on the contiguous path (B1 for turn 1, ``prefill_continue``
   after), and a ``register_prefix`` round trip; the radix proposer over
   two waves of the same prompts (wave 2's streams may leave wave 1's
   only after a near-tie); each run's launches exact
   (``paged_chunk`` = (prefill chunks + verify steps) x the layers); then the
   tiny config, card vs CPU, through each of those paths;
5c. fleet (``fleet_phase``, on ``SERVE_CONFIG``): ``serve(disagg=True)``
   (``prefill-0`` prefills, ``decode-0`` decodes, the KV pages moving
   between their pools) beside the one-engine bucketed run with the
   prefix cache: B6 256 chunks x the layers, B1 none, B5 decode-0's
   dispatches x 4 x the layers, the migration counters and bytes exact
   (and on an int8 pool), the streams equal or off only after a
   near-tie, TTFT/TPOT/tokens/s of both and the export and install ms a
   request from the trace; the trace (one export, one install and one
   router hop a rid, nothing dropped) and the same run untraced (the
   same streams and launches); a three-engine fleet on a fake clock
   under one fault plan (a payload lost, an ACK lost and deduplicated, a
   hang window the watchdog strikes) with decode-1 killed mid-decode
   (its engine collected, its pool freed), then a rolling restart with
   8 requests in flight (none dropped); the books closed, no rid
   delivered twice, the fires accounted for, the memory back within a
   pool after the fleet; a fleet prefix pull (an owner cordoned, 12
   pages pulled into the other replica's host tier and rehydrated);
   the LMService loop (``lmservice``): an LMService of 3 replicas, 1 of
   them prefill, through ``LocalRuntime`` until its 3 pods run;
   ``router.sync_fleet_from_pods`` builds an engine a pod on the same
   weights, its role from the pod's ``LABEL_ROLE``; the 16 requests
   served disaggregated (streams the one engine's, or off only after a
   near-tie; B6 256 chunks x the layers, B5 the decode engines'
   dispatches x 4 x the layers, B1 none); a decode pod crashed, the
   sync naming it removed, the controller recreating it, the next sync
   naming it added, the membership 3 again;
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
7. checkpoint: the flagship through ``lm.train``, 2 steps into a model
   dir (a checkpoint every step, one kept), resumed to 4 against an
   uninterrupted run on the same batches (``RESUME_LOSS_REL_TOL``), then
   ``serve(model_dir=...)`` against an engine on the in-memory
   parameters; save and restore seconds and bytes on disk;
7a. control: the port's control plane launching the port's trainer
   (``runtime.LocalRuntime`` -> ``Controller`` -> ``FakeCluster``'s gang
   admission -> a pod's ``run_fn``): a ``Local`` TPUJob whose pod trains
   the flagship through ``lm.train(ProcessContext.from_env(pod env))``
   for 5 steps in its ``run_fn`` thread (Pending, Running, Succeeded;
   B1-B4 launches the train phase's a step times 5, the checkpoint in the
   injected ``TPUJOB_MODEL_DIR``), then a ``v5p-8`` gang of two pods,
   each starting one rank with its pod's env (the coordinator on
   loopback, gloo on cuda:0): the flagship at 2 layers, fsdp=2, exit 137
   after step 2's checkpoint, one gang restart, both ranks resuming from
   step 2 to step 4; simulated submit -> Running and -> Succeeded, the
   syncs and the wall time; then the control plane over the wire:
   ``remote.k8s``, the port's ``RestServer(k8s_mode=True)`` over a
   ``FakeCluster(use_native_index=True)`` ticked by a wall-clock thread
   (as ``tpujobctl apiserver`` does), a ``RemoteRuntime(k8s=True)`` with
   2 workers reconciling it only over HTTP, the job created over the
   wire, its pod training the flagship as the Local job does (the same
   phases, launches, model dir and checkpoint; the controller's queue
   and expectations and the cluster's index the C++ core's; the job's
   Events read back as core/v1 Events; within a wall timeout); and
   ``remote.rest``, the same over the framework wire with the flagship
   at 2 of its 16 layers for 2 steps; then ``serve_drain``, a preempted
   serving job: a ``v5p-8`` gang whose index 0 drives one
   ``ServingEngine`` on ``SERVE_CONFIG`` (8 prompts of 256 tokens,
   budgets of 512), preempted once every request holds 8 tokens, drained
   with no grace (typed partials, each a prefix of a one-engine twin's
   stream), gang-restarted, and re-served at 32 tokens (the twin's
   streams); B6 and B5 per epoch exactly, B1 none;
7b. models: the MNIST entry point at its defaults (200 steps, held-out
   evaluation every 40; accuracy well above chance); ResNet-50 through
   its entry point (B128 224² uint8, bf16, 8 steps: images/s, step ms,
   peak memory, the last step's idle share and device time by kernel,
   the BN statistics moved, no flash kernel) and resnet_tiny card vs
   CPU after 2 steps; BERT-base through its entry point (S512, B8,
   bf16, ``attn="auto"``, 4 steps, half the rows padded: B1 and B2 per
   step exactly as the per-layer remat predicts, no rope prepass) and
   ``encode`` card vs CPU;
7c. dist: a two-rank gang of ``python -c`` workers with the env the
   controller gives a pod (``JAX_COORDINATOR_ADDRESS``,
   ``JAX_NUM_PROCESSES=2``, ``JAX_PROCESS_ID``), entering through
   ``initialize_from_env`` and ``lm.train``: NCCL with a card a rank on
   a machine of two cards or more, else gloo with both ranks on cuda:0
   (the backend's collectives on CUDA tensors probed first; a layout
   whose collectives it lacks is not run and the line says so). The
   flagship at full width and 4 of its 16 layers (8 at fsdp=2; global
   batch 16; the depth cut for the script's time) at dp=2, fsdp=2
   (its checkpoint restored by a one-process loop, bit for bit) and
   tp=2, 3 steps; ``int8_fused`` at fsdp=2 and llama3_8b at 2 layers
   (B3/B4) at fsdp=2, 2 steps; the flagship at sp=2 (S=2048, global
   batch 4) with ring attention and with q/k/v gathered over sp (B1,
   B3/B4), at pp=2 (all 16 layers, 4 microbatches, global batch 16)
   through ``TrainLoop`` with ``next_token_loss(pp_microbatches=4)``, and
   llama3_8b at 2 layers, sp=2, S=4096 with ring attention; each rank's
   launches a step exactly the one-process counts (none on the ring;
   each rank's layers on every tick of the pipeline), its step ms, and
   the steps' peak memory within ``transformer_memory_plan`` plus
   ``DIST_PEAK_LEAF_COPIES`` copies of the largest leaf; rank 0 holds
   the losses and the parameters' change against a one-process run
   (``DIST_*`` tolerances); a rank's failure fails the run; the probe
   also runs the ring shift (``send_recv``) and names its transport;
   llama3_70b at full width and one layer, fsdp=2 (``after_gang``):
   each rank's save and the gang's own restore of its ~35.5 GB
   checkpoint (bit for bit) within its steps' peak plus one largest
   leaf, then, the gang gone, the one-process run, its yardstick and a
   one-process restore of the checkpoint in this process;
7d. aot: the memory gate (``parallel/aot_check.py``) on fake CUDA
   tensors under a fake process group, llama3_8b at dp=2 x fsdp=16 x
   tp=4 (B32) and llama3_70b at fsdp=16 x tp=8 (B16), S=8192: per-rank
   bytes beside the analytic plan and the card's 80 GB, nothing
   allocated or launched on the card (traced in a process of its own
   that starts with the script and runs on the host's cores beside the
   phases above; read and checked here);
8. a ``kernels`` JSON line (each kernel's whole-call time over its
   library call's, ``vs_library``, from this run; the flash kernels'
   and B7's launches a rank a step in each dist layout), the
   ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and writes only under
``kubeflow_controller_tpu_torch/_build/`` beside itself (the kernels'
library, the compiler log, every line it prints as ``log.txt``, the
served completions and, until the checkpoint phase removes it, its
model dir).
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
                 G=8, rep=4, D=128, bs=16, tp=1):
        import torch

        # tp: the G heads are one tp rank's share (the kernels plan their
        # split for tp * G heads).
        self.tp = tp
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
        if not plain:
            kw["tp"] = self.tp
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
        """The kernel this call launches (``kfc_paged_decode``'s and
        ``kfc_paged_chunk``'s rules)."""
        import torch

        from kubeflow_controller_tpu_torch.ops import paged_attention as pa

        if self.kind == "decode":
            return ["paged_decode_mma_kernel"
                    if pa.decode_uses_mma(self.dtype, self.rep, self.D)
                    else "paged_decode_kernel"]
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

    def __init__(self, label, B, H, KVH, S, D, segments, seed, causal=True,
                 rope=True):
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
        # BERT's attention has no rotary embedding: rope=False runs every
        # kernel without tables (no rope prepass).
        self.rope = fa.rope_full_tables(pos, D, 500000.0) if rope else None
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
        side = ((2 * B * S * D * 4 if self.rope is not None else 0)
                + (B * S * 4 if self.seg is not None else 0))
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
        out = dict(parts=["rope_rotate_kernel"] * (rope is not None) + [
            "flash_bwd_prep_kernel", "flash_bwd_wgmma_kernel",
            "flash_bwd_post_kernel"],
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
        out = {"parts": ["rope_rotate_kernel"] * (self.rope is not None) + [
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
            if kernel == "flash_fwd" and self.rope is None:
                rec["parts"] = (["flash_fwd_wgmma_kernel"]
                                if self.D in fa.WGMMA_HEAD_DIMS else ["flash_fwd_kernel"])
                if timed and self.seg is None:
                    rec["device_ms_by_kernel"] = _kernels_ms(call)
                    rec["library_device_ms_by_kernel"] = _kernels_ms(
                        self.library(kernel))
            elif kernel == "flash_fwd":
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


#: The flash kernels' shapes on the main path: the flagship's attention
#: (one tile per sequence: the fused backward), llama3_8b's and the
#: flagship's gathered over sp (two passes) in training, and llama3_8b's
#: exact prefill of one 256-token prompt in serving (the forward; its
#: backward kernels are checked too); each with and without packed
#: segment ids.
FLASH_SHAPES = {
    "flagship": dict(B=16, H=8, KVH=8, S=1024, D=128),
    "llama3_8b": dict(B=2, H=32, KVH=8, S=2048, D=128),
    "llama3_8b.prefill": dict(B=1, H=32, KVH=8, S=256, D=128),
    # The flagship with its sequence gathered over sp=2 (B1 and the
    # two-pass B3/B4, one query head a KV head); a pipeline microbatch
    # differs from "flagship" only in its batch.
    "flagship.sp2": dict(B=4, H=8, KVH=8, S=2048, D=128),
    # BERT-base's attention at S=512 (one tile: the fused backward), not
    # causal, no rotary embedding.
    "bert_base": dict(B=8, H=12, KVH=12, S=512, D=64, causal=False, rope=False),
    # llama3_70b: a GQA group of 8 query heads a KV head (the flagship's
    # is 1, llama3_8b's and mixtral's 4), at the dist case's S=1024 (the
    # fused backward) and at S=2048 (the two-pass backward).
    "llama3_70b": dict(B=1, H=64, KVH=8, S=1024, D=128),
    "llama3_70b.s2048": dict(B=1, H=64, KVH=8, S=2048, D=128),
}
#: Shapes whose rows the main path never packs: checked and timed without
#: segment ids only.
UNPACKED_SHAPES = ("llama3_70b", "llama3_70b.s2048")
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
            for segments in (False,) if shape in UNPACKED_SHAPES else (False, True):
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
#: B7's split entries (the row scales from the caller, the fp32 partial
#: product out) at the shapes a contraction split over tp=2 gives them in
#: the flagship: o's and down's forward (k halved), which are also
#: q/k/v's and gate/up's dx (n halved).
INT8_SPLIT_SHAPES = {"flagship.o.tp2": (16384, 512, 1024),
                     "flagship.down.tp2": (16384, 2048, 1024)}


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
    Then the split entries (:func:`_int8_split_checks`). A shape
    ``fusable`` refuses must raise. Returns records by shape."""
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
    recs.update(_int8_split_checks(gen, failures, smi))
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


def _int8_split_checks(gen, failures, smi):
    """B7's split entries at :data:`INT8_SPLIT_SHAPES` against their plain
    versions, bit for bit: the prepass quantizing by the caller's row
    scales (a split contraction's are at least this part's abs-max: here
    this part's times a factor drawn in [1, 4), 1 for the outlier, zero
    and tie rows) and the GEMM writing its dequantized product in fp32.
    Each is timed as the whole call (prepass and GEMM), the prepass
    alone, beside the plain version and ``torch._int_mm`` on the same
    codes; bound: a, the rhs codes and both scales in, the fp32 product
    out, or 2mkn int8 operations."""
    import torch

    from kubeflow_controller_tpu_torch.ops import quant as q
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    recs = {}
    for label, (m, k, n) in INT8_SPLIT_SHAPES.items():
        a = _int8_rows(m, k, gen)
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        grow = 1 + 3 * torch.rand((m, 1), generator=gen, device="cuda")
        grow[:3] = 1
        sa = (q._symmetric_scales(a.float(), 1) * grow).contiguous()
        qbt, sb = qf.rhs_codes(w)
        got, want = qf._launch(a, qbt, sb, sa), qf._fused_plain(a, qbt, sb, sa)
        qa, (qa_p, _) = qf.quantize_rows_scaled(a, sa), qf.quantize_rows_plain(a, sa)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        pre_mismatches = int((qa != qa_p).sum())
        max_abs = float((got - want).abs().max())
        if mismatches or got.dtype != torch.float32 or not bool(torch.isfinite(got).all()):
            failures.append(f"int8_matmul_f32[{label}]: {mismatches} outputs differ from "
                            f"the plain version (max |err| {max_abs}, {got.dtype})")
        if pre_mismatches:
            failures.append(f"int8_quantize_rows_scaled[{label}]: {pre_mismatches} codes "
                            "differ from the plain version")
        byts = m * k * 2 + k * n + n * 4 + m * 4 + m * n * 4
        ops = 2 * m * k * n
        t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["int8"] * 1e3
        qb_cm = qbt.t()                           # the same codes, column-major
        rec = dict(case=label, entry="split", m=m, k=k, n=n, mismatches=mismatches,
                   prepass_mismatches=pre_mismatches, max_abs_err=max_abs,
                   ms=_time_ms(lambda: qf._launch(a, qbt, sb, sa)),
                   prepass_ms=_time_ms(lambda: qf.quantize_rows_scaled(a, sa)),
                   parts=["quantize_rows_kernel<true>", "int8_gemm_kernel<true>"],
                   plain_ms=_time_ms(lambda: qf._fused_plain(a, qbt, sb, sa), iters=5),
                   library_ms=_time_ms(lambda: torch._int_mm(qa_p, qb_cm)),
                   library="torch._int_mm on the same int8 codes, rhs column-major "
                           "(the product alone, int32 out)",
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=byts, operations=ops)
        log(f"int8-case {json.dumps(rec)} | {smi}")
        recs[label] = rec
        del a, w, sa, qbt, sb, got, want, qa, qa_p, qb_cm
        torch.cuda.empty_cache()
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
        ("decode.int8.serve", Case("decode", bf, True, 8, 1, 18, 288, serve_pos, 14)),
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
        # The speculative serve run's verify: 8 slots, a window of draft_k
        # + 1 = 5 rows, past 256-token prompts in a 288-column span.
        ("verify.bf16.serve", Case("verify", bf, False, 8, 5, 18, 288,
                                   [256, 263, 270, 277, 282, 283, 259, 266], 24)),
        # One rank's share at tp=2 (tp_serve_phase): llama3_8b's 4 of 8 KV
        # heads (rep 4) and llama3_70b's 4 of 8 (rep 8), the serve shapes.
        ("decode.bf16.tp2", Case("decode", bf, False, 8, 1, 18, 288, serve_pos, 25,
                                 G=4, tp=2)),
        ("prefill.bf16.tp2", Case("prefill", bf, False, 1, 16, 18, 288, [240], 26,
                                  G=4, tp=2)),
        ("decode.bf16.70b.tp2", Case("decode", bf, False, 8, 1, 18, 288, serve_pos, 27,
                                     G=4, rep=8, tp=2)),
        ("prefill.bf16.70b.tp2", Case("prefill", bf, False, 1, 16, 18, 288, [240], 28,
                                      G=4, rep=8, tp=2)),
    ]
    # Checked, not timed: a prefill at offset 0 (no pool page live: the
    # intra-chunk tile alone), a tail chunk of 8 rows at offset 8, an int8
    # verify of one slot at pos 0; decode at head_dim 64 (bf16 and int8
    # pools), every slot at pos 0, pos on and beside page boundaries, a
    # slot past the width cap (inactive: every column up to the cap
    # visible), one slot at 2048 columns (the most parts), and pages of 8
    # rows (a 16-column tile spans two pages).
    edge = [
        ("prefill.bf16.off0", Case("prefill", bf, False, 1, 16, 18, 288, [0], 11)),
        ("prefill.bf16.tail8", Case("prefill", bf, False, 1, 8, 18, 288, [8], 12)),
        ("verify.int8.pos0", Case("verify", bf, True, 1, 5, 18, 288, [0], 13)),
        ("decode.bf16.d64", Case("decode", bf, False, 8, 1, 18, 288, serve_pos, 15, D=64)),
        ("decode.int8.d64", Case("decode", bf, True, 8, 1, 18, 288, serve_pos, 16, D=64)),
        ("decode.bf16.pos0", Case("decode", bf, False, 8, 1, 18, 288, [0] * 8, 17)),
        ("decode.int8.pages", Case("decode", bf, True, 8, 1, 18, 288,
                                   [15, 16, 31, 32, 15, 16, 31, 32], 18)),
        ("decode.bf16.past_cap", Case("decode", bf, False, 8, 1, 18, 288,
                                      [256, 300, 287, 288, 0, 500, 16, 270], 19)),
        ("decode.bf16.one2048", Case("decode", bf, False, 1, 1, 128, 2048, [2047], 20)),
        ("decode.int8.bs8", Case("decode", bf, True, 8, 1, 36, 288, serve_pos, 23, bs=8)),
    ]
    recs = {}
    for name, case in cases + edge:
        recs[name] = case.run(name, timed=name not in dict(edge),
                              profiled=name in ("decode.bf16.serve", "prefill.bf16.serve",
                                                "verify.bf16.serve"))
        del case
        torch.cuda.empty_cache()
    tp_split_check()
    return recs


#: The paged kernels' cases whose heads tp_split_check splits over two
#: ranks: (name, kind, W, pos, rep).
TP_SPLIT_CASES = (("decode", 1, [256, 263, 270, 277, 284, 287, 259, 266], 4),
                  ("decode", 1, [2047, 0, 15, 16, 1000, 1535, 777, 2040], 8),
                  ("prefill", 16, [240], 4), ("verify", 5, [2043, 0, 15, 16], 4))


def tp_split_check():
    """The split plan at tp: each half of the KV heads, called with
    ``tp=2`` on its own half of the pool (a tp rank's share), gives the
    bits of those heads in the one call over all 8 heads. Without the
    ``tp`` argument a half plans its split for 4 heads: whether its bits
    still match is logged, as the finding the argument answers."""
    import torch

    bf = torch.bfloat16
    for seed, (kind, w, pos, rep) in enumerate(TP_SPLIT_CASES, 40):
        mb = 128 if max(pos) > 288 else 18
        whole = Case(kind, bf, False, len(pos), w, mb, mb * 16, pos, seed, rep=rep)
        want = whole.call(plain=False)
        same_unplanned = True
        for r in range(2):
            heads = slice(4 * r, 4 * r + 4)
            for tp in (2, 1):
                half = Case(kind, bf, False, len(pos), w, mb, mb * 16, pos, seed,
                            G=4, rep=rep, tp=tp)
                half.copies = 1
                half.k_pool = whole.k_pool[:1, :, :, heads].contiguous()
                half.v_pool = whole.v_pool[:1, :, :, heads].contiguous()
                half.tables = whole.tables
                half.q = whole.q[..., heads, :, :].contiguous()
                if kind != "decode":
                    half.k_new = whole.k_new[..., heads, :].contiguous()
                    half.v_new = whole.v_new[..., heads, :].contiguous()
                got = half.call(plain=False)
                equal = torch.equal(got, want[..., heads, :, :])
                if tp == 2 and not equal:
                    raise AssertionError(
                        f"tp split {kind} pos {pos}: rank {r}'s heads at tp=2 are not "
                        f"the bits of the whole call")
                if tp == 1:
                    same_unplanned &= equal
                del half
        log(f"tp split {kind} W{w} rep{rep} {len(pos)} slot(s): each rank's 4 of 8 heads "
            f"at tp=2 give the whole call's bits; planned for 4 heads alone they "
            f"{'also do' if same_unplanned else 'do not'}")
        del whole
        torch.cuda.empty_cache()


def two_stream_check():
    """C4: a split decode on a side stream while a split verify chunk runs
    on the current stream, each queued behind a sleep of the same length
    so that their launches start together. The two kernels merge their
    parts through counters and scratch of their own stream; every output
    must be the bits of a run alone and within TOL of its plain version."""
    import torch

    from kubeflow_controller_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    serve_pos = [256, 263, 270, 277, 284, 287, 259, 266]
    dec = Case("decode", bf, False, 8, 1, 18, 288, serve_pos, 21)
    ver = Case("verify", bf, False, 8, 5, 128, 2048,
               [2043, 0, 15, 16, 1000, 1535, 777, 2040], 22)
    n = 24
    dec_alone, ver_alone = dec.call(False), ver.call(False)
    dec_plain, ver_plain = dec.call(True), ver.call(True)
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    torch.cuda.synchronize()
    cycles = 20_000_000                       # ~10 ms at the H100's clock
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles)
        dec_outs = [dec.call(False) for _ in range(n)]
    torch.cuda._sleep(cycles)
    ver_outs = [ver.call(False) for _ in range(n)]
    torch.cuda.synchronize()
    for name, outs, alone, plain in (("decode", dec_outs, dec_alone, dec_plain),
                                     ("verify", ver_outs, ver_alone, ver_plain)):
        diff = sum(int((o != alone).sum()) for o in outs)
        ok, err = _close(alone, plain, **TOL["bfloat16"])
        if diff or not ok:
            raise AssertionError(f"two-stream {name}: {diff} elements differ from a run "
                                 f"alone over {n} launches; alone vs plain max |err| {err}")
    keys = [k for k in pa._STREAM_BUFFERS if k[1] in (side.cuda_stream, main.cuda_stream)]
    if len(keys) != 2:
        raise AssertionError(f"two-stream: stream buffer keys {keys}, want one per stream")
    log(f"two-stream check (C4): {n} split decodes on a side stream beside {n} split "
        f"verify chunks, the same bits as alone, {len(keys)} stream buffer sets")


def _read_completions(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _serve_launches():
    """The serving path's kernel launches since :func:`_reset_serve_launches`:
    the paged kernels' and the flash kernels' (B1 in exact prefill)."""
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa
    from kubeflow_controller_tpu_torch.ops import paged_attention as pa

    return {**pa.LAUNCHES, **fa.LAUNCHES}


def _reset_serve_launches():
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa
    from kubeflow_controller_tpu_torch.ops import paged_attention as pa

    pa.reset_launches()
    fa.reset_launches()


def _counted(fn):
    """``fn()`` with every serving kernel's count zeroed just before and
    read just after, the card synchronized on both sides: (its result,
    wall seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    _reset_serve_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _serve_launches()


def _check_streams(label, streams, keys, n_tokens, vocab):
    """Exactly the requests ``keys`` completed, each with ``n_tokens``
    in-vocab tokens."""
    if sorted(streams) != sorted(keys):
        raise AssertionError(f"{label}: completions {sorted(streams)}")
    for key, toks in streams.items():
        if len(toks) != n_tokens or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: bad completion {key}: {toks}")


def _log_serve(label, what, smi, res, wall, launches, config=None):
    config = config or SERVE_CONFIG
    cfg = _case_config(config)
    log(f"{label} {config} (d_model {cfg.d_model}, {cfg.n_layers} layers, {what}) on "
        f"{smi}: ttft_p50 "
        f"{res['ttft_p50_ms']} ms, ttft_p95 {res['ttft_p95_ms']} ms, tpot_p50 "
        f"{res['tpot_p50_ms']} ms, tokens/s {res['tokens_per_sec']}, wall {wall} s, "
        f"prefill chunks {res['prefill_chunks']}, prefix hit tokens "
        f"{res['prefix_hit_tokens']}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")


def _serve_run(label, smi, batch, n=1, prompt_len=256, config=None, **kw):
    """One ``serve()`` at ``config`` (``SERVE_CONFIG`` by default: llama3_8b
    at full width and 4 of its 32 layers, bf16; 8 slots,
    ``prompt_len``-token prompts, 32 new tokens, pages of 16) with every
    serving kernel's count zeroed just before and read just after. Checks
    the completions (``batch * n`` of 32 in-vocab tokens) and returns
    (summary, launches, {rid: tokens}; {(rid, gen): tokens} when n > 1)."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve

    config = config or SERVE_CONFIG
    vocab = _case_config(config).vocab_size
    out_file = os.path.join(OUT_DIR, f"serve_{label}.jsonl")
    res, wall, launches = _counted(lambda: serve(
        config=config, batch=batch, slots=8, prompt_len=prompt_len,
        max_new_tokens=32, block_size=16, output_file=out_file, n=n, **kw))
    streams = {((c["rid"], c["gen"]) if n > 1 else c["rid"]): c["completion"]
               for c in _read_completions(out_file)}
    if res["requests"] != batch * n:
        raise AssertionError(f"serve[{label}]: {res['requests']} of {batch * n} "
                             f"requests")
    _check_streams(f"serve[{label}]", streams,
                   [(r, g) if n > 1 else r for r in range(batch) for g in range(n)],
                   32, vocab)
    what = json.dumps({k: v for k, v in kw.items() if k != "input_file"})
    _log_serve(f"serve[{label}]", f"{batch} requests x 32 tokens, {what}", smi, res,
               res["wall_s"], launches, config)
    return res, launches, streams


def _tiled_prompts(path, vocab, n, seed, period=16, reps=16):
    """``n`` prompts of ``period * reps`` tokens, each a random pattern
    of ``period`` tokens (drawn from ``seed``) tiled: prompt lookup finds
    n-gram matches in them. Written as the serve entry point's JSONL."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            pattern = rng.integers(0, vocab, period)
            f.write(json.dumps({"prompt": np.tile(pattern, reps).tolist()}) + "\n")
    return path


def _stream_context(prompts, streams):
    """``context(rid, pos)``: the tokens a single-turn request's run had
    before its ``pos``-th generated token."""
    return lambda rid, pos: list(map(int, prompts[rid])) + streams[rid][:pos]


def _first_divergence_gaps(params, a, b, context, cfg=None):
    """For each request whose stream in ``b`` differs from its stream in
    ``a``: (rid, first differing position, the top-2 logit gap there and
    the logits' RMS). The logits come from one block-prefill forward over
    ``context(rid, pos)``, the tokens ``a``'s run had before that
    position, on the weights ``params`` (on the card) of ``cfg``
    (``SERVE_CONFIG``'s by default)."""
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen

    cfg = cfg or _case_config(SERVE_CONFIG)
    out = []
    for rid in sorted(a):
        if a[rid] == b[rid]:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid])) if x != y)
        ctx = context(rid, p)
        logits, _ = gen.prefill(
            cfg, params, torch.tensor([ctx], dtype=torch.int32, device="cuda"),
            gen.init_kv_cache(cfg, 1, len(ctx), device="cuda"))
        top = logits[0].topk(2).values
        out.append((rid, p, float(top[0] - top[1]),
                    float(logits[0].float().pow(2).mean().sqrt())))
    return out


def _check_near_ties(label, gaps, n, gate=True):
    """Log each first divergence with its gap and limit; with ``gate``,
    fail on one past a near-tie (a gap over ``SPEC_FLIP_GAP_OF_RMS``
    times the logits' RMS)."""
    for rid, pos, gap, rms in gaps:
        log(f"{label}: request {rid} first differs at token {pos}, top-2 logit "
            f"gap {gap} (logits rms {rms}, limit {SPEC_FLIP_GAP_OF_RMS * rms})")
    bad = [g for g in gaps if g[2] > SPEC_FLIP_GAP_OF_RMS * g[3]]
    if gate and bad:
        raise AssertionError(f"{label}: streams differ past a near-tie: {bad}")
    log(f"{label}: {n - len(gaps)} of {n} streams equal, {len(gaps)} differ, "
        f"{len(bad)} of them past a near-tie"
        + ("" if gate else " (a finding: different computations)"))


class _OracleProposer:
    """Drafts the plain run's own continuation of each request (looked up
    by its prompt), so that multi-token accepts fire on random weights."""

    def __init__(self, prompts, streams):
        self.book = [(list(map(int, prompts[rid])), streams[rid]) for rid in streams]

    def propose(self, contexts, k):
        import numpy as np

        draft = np.zeros((len(contexts), k), np.int32)
        lens = np.zeros((len(contexts),), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            ctx = list(map(int, ctx))
            for prompt, stream in self.book:
                n = len(prompt)
                if ctx[:n] == prompt and ctx[n:] == stream[:len(ctx) - n]:
                    got = stream[len(ctx) - n:][:k]
                    draft[i, :len(got)] = got
                    lens[i] = len(got)
                    break
        return draft, lens


def tiny_serve_check():
    """The repo's own reference on a small input: the tiny config in fp32
    served with the kernels on the card and with their plain versions on
    the CPU, in bucketed and exact prefill, each without and with
    speculative decoding (an oracle proposer drafting the plain run's own
    continuation, ``draft_k=4``), must commit the same greedy streams
    (TF32 is off, so the two devices differ only in summation order, far
    below any argmax margin), speculation must not change a stream, and
    drafts must be accepted. One weight set drawn on the CPU serves all:
    a CUDA generator draws other numbers than a CPU one from one seed."""
    import numpy as np

    from kubeflow_controller_tpu_torch.dataplane import spec_decode
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    class Oracle(_OracleProposer, spec_decode.DraftProposer):
        pass

    cfg = tfm.tiny_config()
    cpu_params = tfm.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 20))
    for mode in ("bucketed", "exact"):
        streams, accepted = {}, {}
        for spec in (False, True):
            for device in ("cuda", "cpu"):
                params = {k: ({n: t.to(device) for n, t in v.items()}
                              if isinstance(v, dict) else v.to(device))
                          for k, v in cpu_params.items()}
                kw = {}
                if spec:
                    kw = dict(spec_decode=True, draft_k=4, proposer=Oracle(
                        prompts, dict(enumerate(streams[(False, "cpu")]))))
                eng = ServingEngine(cfg, params, n_slots=3, max_seq=32,
                                    block_size=8, prefill_mode=mode,
                                    device=device, **kw)
                out = eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                               for i, p in enumerate(prompts)])
                streams[(spec, device)] = [
                    c.tokens for c in sorted(out, key=lambda c: c.rid)]
                accepted[(spec, device)] = eng.stats.draft_accepted
        base = streams[(False, "cpu")]
        for key, got in streams.items():
            if got != base:
                raise AssertionError(f"serve[tiny] {mode}: streams of {key} "
                                     f"{got} != plain cpu streams {base}")
        if not (accepted[(True, "cuda")] > 0 and accepted[(True, "cpu")] > 0):
            raise AssertionError(f"serve[tiny] {mode}: no draft accepted {accepted}")
        log(f"serve[tiny] fp32 {mode}: cuda kernels and cpu plain versions, "
            f"without and with speculative decoding, commit the same "
            f"{len(base)} greedy streams; drafts accepted cuda "
            f"{accepted[(True, 'cuda')]}, cpu {accepted[(True, 'cpu')]}")
    tiny_sampled_check(cfg, cpu_params, prompts)


def tiny_sampled_check(cfg, cpu_params, prompts):
    """Sampled traffic on the tiny config, fp32, card vs CPU: greedy and
    sampled rows mixed (every knob), one request with n = 2 and one under
    a regex mask, in bucketed and exact prefill, without and with sampled
    speculative decoding (the oracle proposer drafting each request's own
    plain stream). Every stream must be identical on the card and the
    CPU and with speculation, and drafts must be accepted: the draws are
    keyed by (seed, gen, position) on both, and TF32 is off."""
    import re

    from kubeflow_controller_tpu_torch.dataplane import sampling, spec_decode
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )

    class Oracle(_OracleProposer, spec_decode.DraftProposer):
        pass

    mask = sampling.make_mask("re:[0-9a-f]+", cfg.vocab_size)
    knobs = [None, (0.9, 20, 0.9, 1), (1.3, 0, 1.0, 1), (0.7, 5, 1.0, 2),
             (1.0, 0, 0.8, 1), None, (0.8, 0, 1.0, 1), (0.9, 10, 0.95, 1)]

    def requests():
        out = []
        for i, (p, k) in enumerate(zip(prompts, knobs)):
            sp = None
            if k is not None:
                t, tk, tp, n = k
                sp = sampling.SamplingParams(
                    temperature=t, top_k=tk, top_p=tp, n=n, seed=17 * i,
                    logit_mask=mask if i == 6 else None)
            out.append(Request(rid=i, prompt=p, max_new_tokens=12, params=sp))
        return out

    for mode in ("bucketed", "exact"):
        streams, accepted = {}, {}
        for spec in (False, True):
            for device in ("cuda", "cpu"):
                params = {k: ({n: t.to(device) for n, t in v.items()}
                              if isinstance(v, dict) else v.to(device))
                          for k, v in cpu_params.items()}
                kw = {}
                if spec:
                    plain = streams[(False, "cpu")]
                    kw = dict(spec_decode=True, draft_k=4, proposer=Oracle(
                        prompts, {r: t for (r, g), t in plain.items() if g == 0}))
                eng = ServingEngine(cfg, params, n_slots=3, max_seq=32,
                                    block_size=8, prefill_mode=mode,
                                    device=device, **kw)
                out = eng.run(requests())
                if eng.pool.used_blocks:
                    raise AssertionError(f"serve[tiny sampled] {mode}: pages leaked")
                streams[(spec, device)] = {(c.rid, c.gen): c.tokens for c in out}
                accepted[(spec, device)] = eng.stats.draft_accepted
        base = streams[(False, "cpu")]
        for key, got in streams.items():
            if got != base:
                raise AssertionError(f"serve[tiny sampled] {mode}: streams of "
                                     f"{key} {got} != plain cpu streams {base}")
        strs = sampling.default_token_strs(cfg.vocab_size)
        if (not re.fullmatch("[0-9a-f]+", "".join(strs[t] for t in base[(6, 0)]))
                or base[(3, 0)] == base[(3, 1)] or len(base) != 9):
            raise AssertionError(f"serve[tiny sampled] {mode}: {base}")
        if not (accepted[(True, "cuda")] > 0 and accepted[(True, "cpu")] > 0):
            raise AssertionError(f"serve[tiny sampled] {mode}: no draft accepted "
                                 f"{accepted}")
        log(f"serve[tiny sampled] fp32 {mode}: greedy and sampled rows, n=2 and "
            f"a regex mask, without and with sampled speculation: the card and "
            f"the cpu commit the same {len(base)} streams; drafts accepted cuda "
            f"{accepted[(True, 'cuda')]}, cpu {accepted[(True, 'cpu')]}")


def exact_prefill_lengths_check(smi):
    """Exact prefill at prompt lengths on both sides of ``mha``'s flash
    gate (the JAX package's block rule), on the flagship's bf16 weights:
    256 and 300 tiles (B1, ragged at 300: one launch per layer), 1042 does
    not (the dense path: no launch) and must not fail. Each prompt's
    last-position logits against the dense path's on the same weights
    (``attn_impl="xla"``), within LOGITS_REL_L2_TOL: the two round
    attention at different points, as in the logits phase."""
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.ops import flash_attention as fa

    cfg = tfm.flagship_config()
    params = tfm.init_params(cfg, seed=11, device="cuda", dtype=cfg.dtype)
    gen_t = torch.Generator().manual_seed(12)
    for s, flash in ((256, True), (300, True), (1042, False)):
        prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen_t).cuda()
        fa.reset_launches()
        got, _ = gen.prefill(cfg, params, prompt,
                             gen.init_kv_cache(cfg, 1, s, device="cuda"))
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_fwd"]
        want, _ = gen.prefill(cfg.replace(attn_impl="xla"), params, prompt,
                              gen.init_kv_cache(cfg, 1, s, device="cuda"))
        rel = float((got - want).norm() / want.norm())
        log(f"exact prefill flagship S={s}: flash_fwd launches {launches}, "
            f"vs dense rel L2 {rel} (tol {LOGITS_REL_L2_TOL}) | {smi}")
        if (launches != (cfg.n_layers if flash else 0)
                or not bool(torch.isfinite(got).all()) or rel > LOGITS_REL_L2_TOL):
            raise AssertionError(f"exact prefill S={s}: launches {launches}, rel {rel}")
    del params
    torch.cuda.empty_cache()


# A speculative stream may leave the plain one only where the plain run
# had a near-tie: verify (B6, a window of 5 rows) and decode (B5, one row)
# sum attention in different orders and round at different points, and
# the difference carries through 32 bf16 layers. The logits phase bounds
# that difference by the kernel-vs-gather relative L2 (LOGITS_REL_L2_TOL),
# so each of the two top logits may move by about that much times the
# logits' RMS: a flip needs a gap under twice that.
SPEC_FLIP_GAP_OF_RMS = 2 * LOGITS_REL_L2_TOL


# The sampled llama3_8b runs' knobs (chat-style traffic) and the
# grammar run's pattern.
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0)
GRAMMAR = "re:[0-9]+"


def _count_launches(fn, iters: int = 5) -> float:
    """CUDA kernel launches of one call of ``fn`` (``torch.profiler``'s
    kernel events over ``iters`` calls, divided by ``iters``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    n = sum(evt.count for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.key.startswith("Memcpy"))
    return n / iters


def sampling_bench(smi):
    """``sample_step_slots`` at the served batch (8 rows x llama3_8b's
    128,256-token vocab), top_k 50, top_p 0.95, on the card: ms a call
    and kernel launches a call, beside the greedy argmax's; the parts the
    sampled decode chunk runs (the chunk's noise once, the per-row draw
    each micro-step) alike. The card's tokens must equal the CPU's on the
    same inputs (both draw under the same keys; the report gives the
    smallest top-2 gap of gumbel + filtered logits)."""
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen

    b, v, chunk = 8, 128256, 4
    g = torch.Generator().manual_seed(5)
    cpu = dict(
        logits=torch.randn(b, v, generator=g) * 4,
        temp=torch.full((b,), SAMPLED["temperature"]),
        top_k=torch.full((b,), SAMPLED["top_k"], dtype=torch.int32),
        top_p=torch.full((b,), SAMPLED["top_p"]),
        seed=torch.arange(b, dtype=torch.int32),
        gen=torch.zeros(b, dtype=torch.int32),
        pos=torch.arange(b, dtype=torch.int32) * 7)
    dev = {k: t.cuda() for k, t in cpu.items()}

    def draw(d):
        return gen.sample_step_slots(d["logits"], d["temp"], d["top_k"],
                                     d["top_p"], d["seed"], d["gen"], d["pos"])

    got, want = draw(dev).cpu(), draw(cpu)
    filt = gen._filter_logits_rows(cpu["logits"], cpu["temp"], cpu["top_k"],
                                   cpu["top_p"])
    z = gen.sampling_noise(gen.generation_keys(cpu["seed"], cpu["gen"]),
                           cpu["pos"], v) + filt
    top2 = z.topk(2, -1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    if not torch.equal(got, want):
        raise AssertionError(f"sample_step_slots card {got.tolist()} != cpu "
                             f"{want.tolist()} (smallest top-2 gap {gap})")
    steps = torch.arange(chunk + 1, dtype=torch.int32, device="cuda")
    # The engine hashes each lane's generation key on the host.
    key = tuple(k.cuda() for k in gen.generation_keys(cpu["seed"], cpu["gen"]))
    noise = gen.sampling_noise(key, dev["pos"][None] + steps[:, None], v)
    parts = {
        "sample_step_slots": lambda: draw(dev),
        "argmax": lambda: dev["logits"].argmax(-1),
        "chunk_noise": lambda: gen.sampling_noise(
            key, dev["pos"][None] + steps[:, None], v),
        "draw_with_noise": lambda: gen.sample_with_noise(
            dev["logits"], dev["temp"], dev["top_k"], dev["top_p"], noise[0]),
    }
    rec = {"shape": [b, v], "decode_chunk": chunk, "smallest_top2_gap": gap}
    for name, fn in parts.items():
        rec[name] = {"ms": _time_ms(fn), "launches": _count_launches(fn)}
    # A sampled micro-step adds the draw over the greedy argmax, and the
    # chunk's noise shared by its decode_chunk micro-steps (and the
    # speculative peek).
    rec["added_launches_per_micro_step"] = (
        rec["draw_with_noise"]["launches"] - rec["argmax"]["launches"]
        + rec["chunk_noise"]["launches"] / chunk)
    rec["added_ms_per_micro_step"] = (
        rec["draw_with_noise"]["ms"] - rec["argmax"]["ms"]
        + rec["chunk_noise"]["ms"] / chunk)
    log(f"sampling {json.dumps(rec)} | {smi}")
    return rec


def _mask_replay_errors(spec, vocab, streams):
    """(key, position, token) of every committed token a fresh automaton
    of ``spec`` does not admit on replay."""
    from kubeflow_controller_tpu_torch.dataplane import sampling

    bad = []
    for key, toks in streams.items():
        mask = sampling.make_mask(spec, vocab)
        st = mask.init_state()
        for i, t in enumerate(toks):
            if not mask.allowed(st)[t]:
                bad.append((key, i, t))
                break
            st = mask.advance(st, t)
    return bad


def sampled_oracle_spec(smi, prompts, streams, device="cuda"):
    """Sampled speculative decoding at ``SERVE_CONFIG`` through the engine, on
    ``serve()``'s weights (seed 0) and the sampled run's 16 requests,
    with a proposer that drafts each request's own plain sampled stream:
    the sampled verifier (B6's verify entry, once per layer per verify
    step) must run and accept drafts. A stream may leave the plain one
    where bf16 verify (B6) and decode (B5) logits move a draw; the count
    of equal streams is reported. Returns (summary, launches)."""
    import gc

    import torch

    from kubeflow_controller_tpu_torch.dataplane import spec_decode
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    class Oracle(_OracleProposer, spec_decode.DraftProposer):
        pass

    cfg = _case_config(SERVE_CONFIG)
    params = gen.inference_params(cfg, tfm.init_params(
        cfg, seed=SAMPLED["seed"], device=device, dtype=cfg.dtype))
    eng = ServingEngine(cfg, params, n_slots=8, max_seq=256 + 32,
                        block_size=16, spec_decode=True, draft_k=4,
                        proposer=Oracle(prompts, streams), device=device,
                        **SAMPLED)
    torch.cuda.synchronize()
    _reset_serve_launches()
    t = time.perf_counter()
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=32)
                   for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _serve_launches()
    res = eng.stats.summary(wall_s=wall)
    got = {c.rid: c.tokens for c in out}
    equal = sum(got[r] == streams[r] for r in streams)
    n_layers = cfg.n_layers
    if (res["spec_steps"] <= 0 or res["draft_accepted"] <= 0
            or launches["paged_chunk"] != res["spec_steps"] * n_layers
            or launches["flash_fwd"] != len(prompts) * n_layers
            or launches["paged_decode"] % n_layers or eng.pool.used_blocks
            or not all(len(t) == 32 for t in got.values())):
        raise AssertionError(f"serve[spec.sampled.oracle]: {res}, launches {launches}")
    hist = {k: v for k, v in res.items() if k.startswith("spec_step_tokens_")}
    log(f"serve sampled spec, oracle drafts ({SERVE_CONFIG}, {SAMPLED}): acceptance "
        f"{res['acceptance_rate']} ({res['draft_accepted']} of "
        f"{res['draft_proposed']}), verify steps {res['spec_steps']}, "
        f"paged_chunk {launches['paged_chunk']}, committed per slot-step "
        f"{json.dumps(hist)}, {equal} of {len(streams)} streams equal the plain "
        f"sampled run's, tpot_p50 {res['tpot_p50_ms']} ms, tokens/s "
        f"{res['tokens_per_sec']}, wall {wall} s | {smi}")
    del eng, params, out
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def sampling_serve_phase(smi, runs, tiled):
    """``SERVE_CONFIG`` served with per-request sampling, exact prefill,
    bf16, each run's serving kernels counted exactly:

    * 16 requests (256 + 32 tokens, 8 slots) at SAMPLED, beside the
      greedy exact run on the same requests; then the same requests
      submitted in reverse order, which must commit the same stream a
      request (the keying contract);
    * n = 4: 4 prompts of 250 tokens x 4 generations over 8 slots
      (bucketed prefill on the 16-token grid, so each prompt ends in a
      partial page): 15 shared pages a child, one boundary-page copy a
      child, the generations of a prompt all different, every page back;
    * sampled speculative decoding (prompt lookup, draft_k 4) on the
      tiled prompts: B6 once per layer per verify step; then with drafts
      of the sampled run's own streams (:func:`sampled_oracle_spec`);
    * GRAMMAR on 4 requests: every committed token admissible on replay;
      the masked step's ms a token and the first ``allowed()`` build's.
    """

    from kubeflow_controller_tpu_torch.dataplane import sampling
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import (
        _read_prompts,
    )

    cfg = _case_config(SERVE_CONFIG)
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    out = {}

    def whole_steps(launches, b1):
        return (launches["flash_fwd"] == b1 and launches["rope_rotate"] == b1
                and launches["paged_decode"] > 0
                and launches["paged_decode"] % n_layers == 0)

    res, launches, fwd = _serve_run("sampled", smi, 16, **SAMPLED)
    if (not whole_steps(launches, 16 * n_layers) or launches["paged_chunk"]
            or res["sampled_requests"] != 16 or res["prefill_chunks"]):
        raise AssertionError(f"serve[sampled]: {res}, launches {launches}")
    if len({tuple(t) for t in fwd.values()}) != 16:
        raise AssertionError("serve[sampled]: two requests drew one stream")
    greedy = runs["exact"][0]
    log(f"serve sampled vs greedy exact (same 16 requests, this run): ttft_p50 "
        f"{res['ttft_p50_ms']} vs {greedy['ttft_p50_ms']} ms, ttft_p95 "
        f"{res['ttft_p95_ms']} vs {greedy['ttft_p95_ms']} ms, tpot_p50 "
        f"{res['tpot_p50_ms']} vs {greedy['tpot_p50_ms']} ms, tokens/s "
        f"{res['tokens_per_sec']} vs {greedy['tokens_per_sec']}, wall "
        f"{res['wall_s']} vs {greedy['wall_s']} s | {smi}")
    out["sampled"] = (res, launches)

    prompts = _read_prompts("", vocab, 16, 256)
    rev_path = os.path.join(OUT_DIR, "reversed_prompts.jsonl")
    with open(rev_path, "w") as f:
        for p in prompts[::-1]:
            f.write(json.dumps({"prompt": p.tolist()}) + "\n")
    res_r, launches_r, rev = _serve_run("sampled.reversed", smi, 16,
                                        input_file=rev_path, **SAMPLED)
    moved = [i for i in range(16) if rev[15 - i] != fwd[i]]
    if moved or not whole_steps(launches_r, 16 * n_layers):
        raise AssertionError(f"serve[sampled.reversed]: requests {moved} drew "
                             f"another stream in reverse order; {launches_r}")
    log("serve sampled: the 16 requests submitted in reverse order commit the "
        "same 16 streams")

    res_f, launches_f, forks = _serve_run(
        "forks", smi, 4, n=4, prompt_len=250, prefill_mode="bucketed", **SAMPLED)
    fp, bs = 250 // 16, 16
    want = dict(fork_shared_tokens=12 * fp * bs, cow_page_copies=12,
                sampled_requests=16, pool_blocks_in_use=0)
    got = {k: res_f[k] for k in want}
    same = [r for r in range(4) if len({tuple(forks[(r, g)]) for g in range(4)}) < 4]
    if (got != want or same
            or launches_f["paged_chunk"] != res_f["prefill_chunks"] * n_layers
            or launches_f["paged_decode"] % n_layers or launches_f["flash_fwd"]):
        raise AssertionError(f"serve[forks]: {got} (want {want}), prompts with "
                             f"equal generations {same}, launches {launches_f}")
    log(f"serve forks n=4: {got}; every prompt's 4 generations differ | {smi}")
    out["forks"] = (res_f, launches_f)

    res_s, launches_s, _ = _serve_run(
        "tiled.spec.sampled", smi, 16, input_file=tiled, speculative=True,
        draft_k=4, temperature=SAMPLED["temperature"], seed=0)
    # Sampled random-weight streams rarely repeat an n-gram, so lookup may
    # draft nothing here; the oracle run below drafts for certain.
    if (launches_s["paged_chunk"] != res_s["spec_steps"] * n_layers
            or not whole_steps(launches_s, 16 * n_layers)):
        raise AssertionError(f"serve[spec.sampled]: {res_s}, launches {launches_s}")
    hist = {k: v for k, v in res_s.items() if k.startswith("spec_step_tokens_")}
    log(f"serve sampled spec (tiled prompts, temperature "
        f"{SAMPLED['temperature']}): acceptance {res_s['acceptance_rate']} "
        f"({res_s['draft_accepted']} of {res_s['draft_proposed']}), verify "
        f"steps {res_s['spec_steps']}, probe steps {res_s['spec_probe_steps']}, "
        f"committed per slot-step {json.dumps(hist)}, tpot_p50 "
        f"{res_s['tpot_p50_ms']} ms | {smi}")
    out["spec.sampled"] = (res_s, launches_s)
    out["spec.sampled.oracle"] = sampled_oracle_spec(smi, prompts, fwd)

    t = time.perf_counter()
    probe = sampling.make_mask(GRAMMAR, vocab)
    probe.allowed(probe.init_state())
    build_ms = (time.perf_counter() - t) * 1e3
    res_g, launches_g, gram = _serve_run("grammar", smi, 4, grammar=GRAMMAR,
                                         **SAMPLED)
    bad = _mask_replay_errors(GRAMMAR, vocab, gram)
    if bad or not whole_steps(launches_g, 4 * n_layers) or res_g[
            "mask_tokens_filtered"] <= 0:
        raise AssertionError(f"serve[grammar]: inadmissible tokens {bad}, "
                             f"launches {launches_g}, {res_g}")
    strs = sampling.default_token_strs(vocab)
    log(f"serve grammar {GRAMMAR!r}: 4 requests x 32 tokens all admissible on "
        f"replay (first: {''.join(strs[t] for t in gram[0])!r}); masked step "
        f"tpot_p50 {res_g['tpot_p50_ms']} ms a token, ttft_p50 "
        f"{res_g['ttft_p50_ms']} ms, first allowed() build {build_ms} ms "
        f"({vocab} token strings), mask_tokens_filtered "
        f"{res_g['mask_tokens_filtered']} | {smi}")
    out["grammar"] = (res_g, launches_g)
    out["grammar.allowed_build_ms"] = build_ms
    out["sampling"] = sampling_bench(smi)
    return out


def serve_phase(smi):
    """``SERVE_CONFIG`` served end to end: bucketed prefill
    (16 requests; then 4 with an int8 KV pool), exact prefill (the same 16
    requests), and greedy speculative decoding on tiled prompts beside
    the plain exact run on the same prompts; then the sampling runs
    (:func:`sampling_serve_phase`); each with exact kernel launch counts.
    Then the tiny config, card vs CPU."""
    n_layers = _case_config(SERVE_CONFIG).n_layers
    vocab = _case_config(SERVE_CONFIG).vocab_size
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = {}
    for label, batch, kv_quant in (("fp", 16, ""), ("int8", 4, "int8")):
        res, launches, _ = _serve_run(label, smi, batch, kv_quant=kv_quant,
                                      prefill_mode="bucketed")
        for k in ("paged_decode", "paged_chunk"):
            if launches[k] <= 0:
                raise AssertionError(f"serve[{label}]: kernel {k} never launched")
        # One chunk launch per layer per prefill chunk, one decode launch
        # per layer per decode micro-step.
        if (launches["paged_chunk"] != res["prefill_chunks"] * n_layers
                or launches["paged_decode"] % n_layers):
            raise AssertionError(f"serve[{label}]: launches {launches} are not one per "
                                 f"layer of {res['prefill_chunks']} chunks and whole steps")
        runs[label] = (res, launches)

    # Exact prefill: one forward of each whole prompt at admission, B1 (the
    # flash forward with its rope prepass) once per layer per admission;
    # no prefill chunk.
    res, launches, _ = _serve_run("exact", smi, 16)
    b1 = 16 * n_layers
    if (launches["flash_fwd"] != b1 or launches["rope_rotate"] != b1
            or launches["paged_chunk"] != 0 or launches["paged_decode"] <= 0
            or launches["paged_decode"] % n_layers or res["prefill_chunks"] != 0):
        raise AssertionError(f"serve[exact]: launches {launches}, want flash_fwd and "
                             f"rope_rotate {b1}, paged_chunk 0, whole decode steps")
    runs["exact"] = (res, launches)
    bucketed = runs["fp"][0]
    log(f"serve exact vs bucketed (same requests, this run): ttft_p50 "
        f"{res['ttft_p50_ms']} vs {bucketed['ttft_p50_ms']} ms, ttft_p95 "
        f"{res['ttft_p95_ms']} vs {bucketed['ttft_p95_ms']} ms, tpot_p50 "
        f"{res['tpot_p50_ms']} vs {bucketed['tpot_p50_ms']} ms, tokens/s "
        f"{res['tokens_per_sec']} vs {bucketed['tokens_per_sec']}, wall "
        f"{res['wall_s']} vs {bucketed['wall_s']} s")

    # Speculative decoding (prompt lookup, draft_k 4) on tiled prompts,
    # beside the plain exact run on the same prompts. Each verify step
    # launches B6's verify entry once per layer.
    seed = 0
    tiled = _tiled_prompts(os.path.join(OUT_DIR, "tiled_prompts.jsonl"), vocab, 16, seed)
    prompts = [r["prompt"] for r in _read_completions(tiled)]
    plain_res, _, plain = _serve_run("tiled.plain", smi, 16, input_file=tiled,
                                     seed=seed)
    res, launches, spec = _serve_run("tiled.spec", smi, 16, input_file=tiled,
                                     seed=seed, speculative=True, draft_k=4)
    if (res["draft_proposed"] <= 0 or res["spec_steps"] <= 0
            or launches["paged_chunk"] != res["spec_steps"] * n_layers
            or launches["flash_fwd"] != b1 or launches["paged_decode"] % n_layers):
        raise AssertionError(f"serve[spec]: {res}, launches {launches}: want drafts, "
                             f"verify steps, paged_chunk = spec_steps x {n_layers}")
    hist = {k: v for k, v in res.items() if k.startswith("spec_step_tokens_")}
    log(f"serve spec vs plain (tiled prompts, this run): acceptance "
        f"{res['acceptance_rate']} ({res['draft_accepted']} of "
        f"{res['draft_proposed']}), verify steps {res['spec_steps']}, probe "
        f"steps {res['spec_probe_steps']}, committed per slot-step "
        f"{json.dumps(hist)}, tpot_p50 {res['tpot_p50_ms']} vs "
        f"{plain_res['tpot_p50_ms']} ms, tokens/s {res['tokens_per_sec']} vs "
        f"{plain_res['tokens_per_sec']}, wall {res['wall_s']} vs "
        f"{plain_res['wall_s']} s")
    # serve() drew its weights from seed 0: the ones _llama() draws.
    gaps = (_first_divergence_gaps(_llama()[1], plain, spec,
                                   _stream_context(prompts, plain))
            if plain != spec else [])
    _drop_llama()
    _check_near_ties("serve spec vs plain", gaps, 16)
    runs["spec"] = (res, launches)
    runs["tiled.plain"] = (plain_res, None)
    runs.update(sampling_serve_phase(smi, runs, tiled))
    exact_prefill_lengths_check(smi)
    tiny_serve_check()
    return runs


# -- prefix cache, host tier, multi-turn, radix drafts -------------------------

#: The ``SERVE_CONFIG`` weights (seed 0, bf16) of the phases that serve
#: through the engine or hold a stream's logits: drawn once, the weights
#: ``serve(config=SERVE_CONFIG, seed=0)`` draws.
_LLAMA = {}
#: One-process engine runs (prompts, streams, summary, launches) that
#: tp_serve_phase holds its gang to.
_YARDSTICK = {}


def _llama():
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    if not _LLAMA:
        cfg = _case_config(SERVE_CONFIG)
        _LLAMA["cfg"] = cfg
        _LLAMA["params"] = gen.inference_params(
            cfg, tfm.init_params(cfg, seed=0, device="cuda", dtype=cfg.dtype))
        torch.cuda.synchronize()
    return _LLAMA["cfg"], _LLAMA["params"]


def _drop_llama():
    import gc

    import torch

    _LLAMA.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _prefix_requests(n, shared_len, tail_lo, tail_hi, seed, families=1):
    """``families`` seeded ``shared_len``-token prefixes, request ``i``
    the ``i % families``-th of them (so ``n // families`` waves) plus a
    seeded tail of ``tail_lo..tail_hi`` tokens: ``(rid, prompt)``
    pairs."""
    import numpy as np

    vocab = _LLAMA["cfg"].vocab_size
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, vocab, shared_len) for _ in range(families)]
    tails = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        f = fams[i % families]
        tail = tails.integers(0, vocab, int(tails.integers(tail_lo, tail_hi + 1)))
        out.append((i, np.concatenate([f, tail]).astype(np.int32)))
    return out


def _engine_run(label, smi, prompts, max_new=32, eng=None, rid0=0, **kw):
    """Serve ``prompts`` (``(rid, prompt)``) on the ``SERVE_CONFIG`` weights
    through a fresh engine (or ``eng``), every serving kernel's count
    zeroed just before and read just after. Checks every completion
    (``max_new`` in-vocab tokens) and returns (engine, summary, launches,
    {rid: tokens})."""
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )

    cfg, params = _llama()
    if eng is None:
        eng = ServingEngine(cfg, params, prefill_mode="bucketed",
                            block_size=16, device="cuda", **kw)
    comps, wall, launches = _counted(lambda: eng.run(
        [Request(rid=rid0 + rid, prompt=p, max_new_tokens=max_new)
         for rid, p in prompts]))
    res = eng.stats.summary(wall_s=wall)
    streams = {c.rid - rid0: list(map(int, c.tokens)) for c in comps}
    _check_streams(label, streams, [r for r, _ in prompts], max_new, cfg.vocab_size)
    _log_serve(label, f"{len(prompts)} requests x {max_new} tokens, "
               f"{json.dumps(kw)}", smi, res, wall, launches)
    return eng, res, launches, streams


def _check_paged_launches(label, res, launches, n_layers, verify_steps=0):
    """One chunk launch per layer per prefill chunk and verify step, one
    decode launch per layer per micro-step."""
    want = (res["prefill_chunks"] + verify_steps) * n_layers
    if launches["paged_chunk"] != want or launches["paged_decode"] % n_layers:
        raise AssertionError(f"{label}: launches {launches}, want paged_chunk "
                             f"{want} and whole decode steps")


def _check_contiguous_launches(launches, n_layers):
    """The contiguous multi-turn path: B1 and its rope prepass once a
    layer (turn 1's batched prefill), no paged kernel."""
    if (launches["flash_fwd"] != n_layers or launches["rope_rotate"] != n_layers
            or launches["paged_chunk"] or launches["paged_decode"]):
        raise AssertionError(f"multiturn[contiguous]: launches {launches}, want "
                             f"flash_fwd and rope_rotate {n_layers}, no paged kernel")


def _trie_sweep(label, eng):
    """The leak sweep: no request pin survives, pool pages in use are the
    trie's resident pages, and each live host entry is one spilled
    node's. Returns (resident, spilled) node counts."""
    store, tier = eng._prefix_store, eng._host_tier
    stack = list(store.trie.root.children.values())
    resident, handles = 0, []
    while stack:
        n = stack.pop()
        if n.refs:
            raise AssertionError(f"{label}: a request pin leaked")
        if n.block >= 0:
            resident += 1
        elif tier is not None and tier.has(n.host_handle):
            handles.append(n.host_handle)
        stack.extend(n.children.values())
    tier_pages = 0 if tier is None else tier.resident_pages
    if eng.pool.used_blocks != resident or len(handles) != tier_pages:
        raise AssertionError(
            f"{label}: pool pages in use {eng.pool.used_blocks} vs resident "
            f"trie pages {resident}; tier entries {tier_pages} vs spilled "
            f"nodes {len(handles)}")
    return resident, len(handles)


def prefix_serve_phase(smi):
    """32 chat requests behind one seeded 192-token system prompt (tails
    of 1-64 tokens, 32 new tokens, 8 slots, pages of 16, bucketed,
    greedy) with the prefix cache off, then on. The hit count and both
    runs' prefill chunks are predicted from the schedule first: the
    first wave of 8 is admitted before anything is published and misses;
    every later admission hits the prompt's 12 full pages."""
    cfg, _ = _llama()
    n_layers = cfg.n_layers
    reqs = _prefix_requests(32, 192, 1, 64, seed=100)
    prompts = dict(reqs)
    max_seq = 192 + 64 + 32
    want_hits = (32 - 8) * 192
    want_chunks = {
        "off": sum(-(-p.size // 16) for _, p in reqs),
        "on": sum(-(-p.size // 16) if rid < 8 else -(-(p.size - 192) // 16)
                  for rid, p in reqs)}
    log(f"prefix predicted: prefix_hit_tokens {want_hits}, prefill chunks "
        f"off {want_chunks['off']}, on {want_chunks['on']}")
    runs = {}
    for mode, on in (("off", False), ("on", True)):
        eng, res, launches, streams = _engine_run(
            f"prefix[{mode}]", smi, reqs, n_slots=8, max_seq=max_seq,
            prefix_cache=on)
        _check_paged_launches(f"prefix[{mode}]", res, launches, n_layers)
        hits = int(res["prefix_hit_tokens"])
        if res["prefill_chunks"] != want_chunks[mode] or hits != (want_hits if on else 0):
            raise AssertionError(
                f"prefix[{mode}]: prefill chunks {res['prefill_chunks']} (predicted "
                f"{want_chunks[mode]}), prefix hits {hits} (predicted "
                f"{want_hits if on else 0})")
        if on:
            _trie_sweep("prefix[on]", eng)
        runs[mode] = (res, launches, streams)
        del eng
    log(f"prefix: prefix_hit_tokens {int(runs['on'][0]['prefix_hit_tokens'])} vs "
        f"predicted {want_hits}; hit rate {runs['on'][0]['prefix_hit_rate']}")
    _check_near_ties("prefix on vs off", _first_divergence_gaps(
        _llama()[1], runs["off"][2], runs["on"][2],
        _stream_context(prompts, runs["off"][2])), len(prompts))
    off, on = runs["off"][0], runs["on"][0]
    log(f"prefix on vs off (this run): ttft_p50 {on['ttft_p50_ms']} vs "
        f"{off['ttft_p50_ms']} ms, ttft_p95 {on['ttft_p95_ms']} vs "
        f"{off['ttft_p95_ms']} ms, tpot_p50 {on['tpot_p50_ms']} vs "
        f"{off['tpot_p50_ms']} ms, tokens/s {on['tokens_per_sec']} vs "
        f"{off['tokens_per_sec']}, B6 {runs['on'][1]['paged_chunk']} vs "
        f"{runs['off'][1]['paged_chunk']}, B5 {runs['on'][1]['paged_decode']} vs "
        f"{runs['off'][1]['paged_decode']}")
    return {f"prefix.{m}": (r[0], r[1]) for m, r in runs.items()}


def _time_tier_moves(eng, rec):
    """Wrap the engine's spill and rehydrate callbacks with host timers
    around synchronized calls (the pipeline stalls at each: these runs'
    TTFT includes the stalls). A rehydrate's own time leaves out the
    spills it triggers."""
    import torch

    spill, rehydrate = eng._spill_nodes, eng._rehydrate_nodes
    nested = [0.0]

    def timed_spill(nodes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        keep = spill(nodes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        nested[0] += dt
        rec["spill"].append((dt, sum(keep)))
        return keep

    def timed_rehydrate(nodes, rid=None):
        torch.cuda.synchronize()
        nested[0] = 0.0
        t = time.perf_counter()
        n = rehydrate(nodes, rid)
        torch.cuda.synchronize()
        rec["rehydrate"].append((time.perf_counter() - t - nested[0], n))
        return n

    eng._spill_nodes, eng._rehydrate_nodes = timed_spill, timed_rehydrate


def _copy_yardstick(page_bytes, pages=16):
    """A plain pinned ``copy_`` of ``pages`` pages' bytes each way (CUDA
    events, the mean of 10): (d2h ms a page, h2d ms a page)."""
    import torch

    n = pages * page_bytes
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    d2h = _time_ms(lambda: host.copy_(dev, non_blocking=True), 10)
    h2d = _time_ms(lambda: dev.copy_(host, non_blocking=True), 10)
    return d2h / pages, h2d / pages


def _spill_breakdown(cache, smi, pages=8):
    """Where a spill's time goes: ``gather_pool_pages`` of ``pages``
    pages (one device gather, one D2H copy a page and part into a fresh
    pinned buffer of its own, the wait), and the fresh pinned buffers
    alone, each round's buffers kept alive as the tier keeps its entries
    (so the caching host allocator has no freed block to hand back);
    each the median of 3 host-timed rounds after one warm-up."""
    import statistics

    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen

    ids = list(range(pages))
    shape = (cache.k.shape[0], 1) + tuple(cache.k.shape[2:])
    kept = []

    def gather():
        kept.append(gen.gather_pool_pages(cache, ids))

    def fresh():
        kept.append([torch.empty(shape, dtype=cache.k.dtype, pin_memory=True)
                     for _ in range(2 * pages)])

    out = {}
    for name, fn in (("gather", gather), ("fresh pinned", fresh)):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / pages)
        out[name] = statistics.median(times)
    log(f"tier spill breakdown on {smi}: gather_pool_pages {out['gather']} ms a "
        f"page; fresh pinned buffers for a page's K and V alone "
        f"{out['fresh pinned']} ms a page ({pages} pages, median of 3)")
    del kept
    return out


def _same_streams(label, a, b):
    """The tier moves bytes verbatim: its streams equal the tier-off
    run's, token for token."""
    diff = [rid for rid in sorted(a) if a[rid] != b[rid]]
    if diff:
        raise AssertionError(f"{label}: streams of requests {diff} differ")
    log(f"{label}: {len(a)} of {len(a)} streams equal")


def tier_serve_phase(smi):
    """16 seeded families of 192-token prefixes, each revisited in 3
    waves (tails of 1-16 tokens, 32 new tokens, 4 slots, pages of 16) in
    a pool of 128 pages (60 of them live reservations; 256 MiB of 2 MiB
    pages at llama3_8b's 32 layers, the budget scaled with the served
    depth so that the pages and the schedule stay those of all 32), with
    the host tier off, then at 512 pages: the streams must be equal,
    and the tier run must spill and rehydrate; the spill's and the
    rehydrate's ms a page and GB/s beside a pinned ``copy_``; the leak
    sweep, then ``reset()`` to zero. Then int8 pages: 4 requests of two
    families in turn through one slot and a pool of 16 pages, so that
    each family evicts the other's chain, tier off and on."""
    from kubeflow_controller_tpu_torch.models import generate as gen

    cfg, _ = _llama()
    n_layers = cfg.n_layers
    # MiB at this depth for what 1 MiB holds at all 32 layers.
    depth = n_layers / _case_config(CUT_CONFIGS[SERVE_CONFIG][0]).n_layers
    reqs = _prefix_requests(48, 192, 1, 16, seed=200, families=16)
    kw = dict(n_slots=4, max_seq=192 + 16 + 32, prefix_cache=True,
              kv_hbm_budget_mb=256 * depth)
    runs, streams = {}, {}
    rec = {"spill": [], "rehydrate": []}
    for mode, mb in (("off", 0), ("on", 1024 * depth)):
        eng = None
        if mb:
            from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
                ServingEngine,
            )
            eng = ServingEngine(_llama()[0], _llama()[1], prefill_mode="bucketed",
                                block_size=16, device="cuda", host_kv_mb=mb, **kw)
            _time_tier_moves(eng, rec)
        eng, res, launches, streams[mode] = _engine_run(
            f"tier[{mode}]", smi, reqs, eng=eng, host_kv_mb=mb, **kw)
        _check_paged_launches(f"tier[{mode}]", res, launches, n_layers)
        if eng.pool.n_blocks != 128:
            raise AssertionError(f"tier: pool {eng.pool.n_blocks} pages, want 128 "
                                 f"({256 * depth} MiB)")
        resident, spilled = _trie_sweep(f"tier[{mode}]", eng)
        log(f"tier[{mode}]: spilled_pages {res['spilled_pages']}, spill_bytes "
            f"{res['spill_bytes']}, rehydrate_hits {res['rehydrate_hits']}, "
            f"rehydrate_tokens {res['rehydrate_tokens']}, host_pages_resident "
            f"{res['host_pages_resident']}, prefix_hit_tokens "
            f"{res['prefix_hit_tokens']}, zero-copy {res['prefix_zero_copy_tokens']}; "
            f"leak sweep: {eng.pool.used_blocks} pool pages in use = {resident} "
            f"resident trie pages, {spilled} spilled nodes = host entries")
        if mb:
            if res["spilled_pages"] <= 0 or res["rehydrate_hits"] <= 0:
                raise AssertionError(f"tier[on]: no spill or no rehydrate: {res}")
            page_bytes = gen.pool_page_host_bytes(eng.cache)
            _spill_breakdown(eng.cache, smi)
            eng.reset()
            if eng.pool.used_blocks or eng._host_tier.resident_pages:
                raise AssertionError("tier: reset() left pages")
            log(f"tier[on]: after reset(): {eng.pool.used_blocks} pool pages, "
                f"{eng._host_tier.resident_pages} host entries")
        runs[f"tier.{mode}"] = (res, launches)
        del eng
    _same_streams("tier on vs off", streams["off"], streams["on"])
    d2h, h2d = _copy_yardstick(page_bytes)
    for name, ys in (("spill", d2h), ("rehydrate", h2d)):
        secs = sum(t for t, _ in rec[name])
        pages = sum(n for _, n in rec[name])
        ms = secs * 1e3 / max(pages, 1)
        log(f"tier {name}: {pages} pages in {len(rec[name])} calls, {ms} ms a "
            f"page ({page_bytes} B), {page_bytes / ms / 1e6} GB/s; pinned "
            f"copy_ of the same bytes {ys} ms a page, "
            f"{page_bytes / ys / 1e6} GB/s, on {smi}")
    tier = runs["tier.on"][0]
    off = runs["tier.off"][0]
    log(f"tier on vs off (this run): ttft_p50 {tier['ttft_p50_ms']} vs "
        f"{off['ttft_p50_ms']} ms, tpot_p50 {tier['tpot_p50_ms']} vs "
        f"{off['tpot_p50_ms']} ms, tokens/s {tier['tokens_per_sec']} vs "
        f"{off['tokens_per_sec']}, prefill chunks {tier['prefill_chunks']} vs "
        f"{off['prefill_chunks']}")

    # int8 pages: A, B, A, B through one slot and 16 pages.
    fam = _prefix_requests(2, 192, 1, 16, seed=210, families=2)
    pair = [(0, fam[0][1]), (1, fam[1][1]), (2, fam[0][1]), (3, fam[1][1])]
    int8 = {}
    for mode, mb in (("off", 0), ("on", 64 * depth)):
        eng, res, launches, int8[mode] = _engine_run(
            f"tier.int8[{mode}]", smi, pair, n_slots=1, max_seq=240,
            prefix_cache=True, kv_pool_blocks=16, kv_quant="int8", host_kv_mb=mb)
        _check_paged_launches(f"tier.int8[{mode}]", res, launches, n_layers)
        _trie_sweep(f"tier.int8[{mode}]", eng)
        log(f"tier.int8[{mode}]: spilled_pages {res['spilled_pages']}, "
            f"rehydrate_hits {res['rehydrate_hits']}, rehydrate_tokens "
            f"{res['rehydrate_tokens']}")
        if mb and (res["spilled_pages"] <= 0 or res["rehydrate_hits"] <= 0):
            raise AssertionError(f"tier.int8[on]: no spill or no rehydrate: {res}")
        runs[f"tier.int8.{mode}"] = (res, launches)
        del eng
    _same_streams("tier.int8 on vs off", int8["off"], int8["on"])
    # The one-process run the tp gang's tier case is held to.
    _YARDSTICK["tier.int8.on"] = dict(
        prompts=[p.tolist() for _, p in pair], streams=int8["on"],
        summary=runs["tier.int8.on"][0], launches=runs["tier.int8.on"][1],
        engine_kw=dict(n_slots=1, max_seq=240, prefix_cache=True, kv_pool_blocks=16,
                       kv_quant="int8", host_kv_mb=64 * depth))
    return runs


def _history_context(prompts, follow, streams, rid, pos, turns, max_new):
    """The token context a multi-turn conversation had before its
    ``pos``-th generated token: the prompt, then each turn's follow-up
    and reply in order."""
    ctx = list(map(int, prompts[rid]))
    for turn in range(turns):
        if turn:
            ctx += list(map(int, follow[turn][rid]))
        take = min(max_new, pos - turn * max_new)
        if take <= 0:
            break
        ctx += streams[rid][turn * max_new:turn * max_new + take]
        if take < max_new:
            break
    return ctx


def multiturn_phase(smi):
    """``serve(config=SERVE_CONFIG, batch=8, slots=8, prompt_len=256,
    max_new_tokens=32, turns=3)`` with the prefix cache and without. With
    it: the hit rate must equal the count that follows from the full
    pages each turn's history already published (turn t reuses turn
    t-1's prompt and reply). Without it: B1 (and its rope prepass) once a
    layer for turn 1's batched prefill, ``prefill_continue`` on turns 2-3,
    no paged kernel. The two paths are different computations: their
    first divergence and its gap are a finding, not a gate. Then a
    ``register_prefix`` round trip: a ``generate_from_cache`` session's
    KV registered in an engine, whose next turn hits every full block."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import (
        _read_prompts, serve,
    )
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    cfg, params = _llama()
    n_layers = cfg.n_layers
    b, s, new, turns = 8, 256, 32, 3
    prompts = _read_prompts("", cfg.vocab_size, b, s)
    follow = {t: np.random.default_rng(t).integers(0, cfg.vocab_size, (b, s))
              for t in range(1, turns)}
    # Turn t's admission finds the full pages of turn t-1's prompt and
    # reply: (history_{t-1} + new) // 16 pages.
    hist, want_hits, lookup = s, 0, 0
    for t in range(turns):
        lookup += b * hist
        if t:
            want_hits += b * ((prev + new) // 16) * 16
        prev = hist
        hist = hist + new + s
    want_rate = want_hits / lookup
    log(f"multiturn predicted: prefix_hit_tokens {want_hits} of {lookup} "
        f"(hit rate {want_rate})")
    runs, streams = {}, {}
    for mode, on in (("cache", True), ("contiguous", False)):
        out_file = os.path.join(OUT_DIR, f"multiturn_{mode}.jsonl")
        res, wall, launches = _counted(lambda: serve(
            config=SERVE_CONFIG, batch=b, slots=b, prompt_len=s,
            max_new_tokens=new, turns=turns, prefix_cache=on, block_size=16,
            output_file=out_file))
        streams[mode] = {c["rid"]: c["completion"]
                         for c in _read_completions(out_file)}
        _check_streams(f"multiturn[{mode}]", streams[mode], range(b), turns * new,
                       cfg.vocab_size)
        log(f"multiturn[{mode}] {SERVE_CONFIG} on {smi}: {b} conversations x "
            f"{turns} turns x {new} tokens, tokens/s {res['tokens_per_sec']} "
            f"(serve wall {res['wall_s']} s, call {wall} s with the weights' "
            f"init), launches { {k: v for k, v in launches.items() if v} }")
        if on:
            _check_paged_launches("multiturn[cache]", res, launches, n_layers)
            log(f"multiturn[cache]: prefix_hit_rate {res['prefix_hit_rate']} "
                f"({int(res['prefix_hit_tokens'])} tokens) vs predicted "
                f"{want_rate} ({want_hits})")
            if int(res["prefix_hit_tokens"]) != want_hits or abs(
                    res["prefix_hit_rate"] - want_rate) > 1e-12:
                raise AssertionError(f"multiturn[cache]: hits {res['prefix_hit_tokens']} "
                                     f"!= predicted {want_hits}")
        else:
            _check_contiguous_launches(launches, n_layers)
        runs[f"multiturn.{mode}"] = (res, launches)
    _check_near_ties("multiturn cache vs contiguous", _first_divergence_gaps(
        params, streams["cache"], streams["contiguous"],
        lambda rid, pos: _history_context(prompts, follow, streams["cache"], rid,
                                          pos, turns, new)), b, gate=False)

    # register_prefix: a contiguous session (256 prompt tokens + a 32-token
    # reply = 18 full pages) registered; its next turn (64 more tokens)
    # hits all 18.
    prompt = torch.from_numpy(prompts[:1]).to("cuda")
    cache = gen.init_kv_cache(cfg, 1, 512, device="cuda")
    logits, cache = gen.prefill(cfg, params, prompt, cache)
    toks, logits, cache = gen.generate_from_cache(cfg, params, logits, cache, new,
                                                  return_state=True)
    session = np.concatenate([prompts[0], toks[0].cpu().numpy().astype(np.int32)])
    eng = ServingEngine(cfg, params, n_slots=1, max_seq=512,
                        prefill_mode="bucketed", block_size=16, prefix_cache=True,
                        device="cuda")
    registered = eng.register_prefix(session, cache)
    turn2 = np.concatenate([session, follow[1][0, :64].astype(np.int32)])
    out = eng.run([Request(rid=0, prompt=turn2, max_new_tokens=new)])
    hits = eng.stats.prefix_hit_tokens
    if registered != 288 or hits != 288 or len(out[0].tokens) != new:
        raise AssertionError(f"register_prefix: registered {registered}, hits {hits}, "
                             f"want 288 and 288")
    cold = ServingEngine(cfg, params, n_slots=1, max_seq=512,
                         prefill_mode="bucketed", block_size=16, device="cuda")
    ref = cold.run([Request(rid=0, prompt=turn2, max_new_tokens=new)])
    same = ref[0].tokens == out[0].tokens
    log(f"register_prefix {SERVE_CONFIG}: a {session.size}-token session registered "
        f"{registered} tokens; turn 2 ({turn2.size} tokens) hit {hits}, prefilled "
        f"{turn2.size - hits}; its stream {'equals' if same else 'differs from'} a "
        f"cold engine's (a finding: contiguous vs paged computations)")
    del eng, cold, cache
    return runs


def radix_spec_phase(smi):
    """Prefix cache on, speculative decoding, ``proposer="radix"``,
    ``draft_k=4``: 16 requests (128-token seeded prompts, 32 new tokens,
    8 slots), then the same 16 prompts under new rids on the same engine,
    whose trie now holds wave 1's replies, so wave 2 drafts them.
    Acceptance a wave; ``paged_chunk`` = (prefill chunks + verify steps)
    x the layers a wave; wave 2's streams may leave wave 1's (same prompts) only
    after a near-tie (``SPEC_FLIP_GAP_OF_RMS``, as serve[spec])."""
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        ServingEngine,
    )

    cfg, params = _llama()
    reqs = _prefix_requests(16, 0, 128, 128, seed=300)
    prompts = dict(reqs)
    # 256 pages: wave 1's 16 published chains (10 pages each) and wave
    # 2's live reservations fit, so no reply is evicted before wave 2
    # drafts it. spec_cooldown_max=1: a lane that found no draft in wave 1
    # (whose trie holds no reply yet) probes again the next step instead
    # of cooling down into wave 2 (the backoff is kept per lane).
    eng = ServingEngine(cfg, params, n_slots=8, max_seq=160, prefill_mode="bucketed",
                        block_size=16, prefix_cache=True, kv_pool_blocks=256,
                        spec_decode=True, draft_k=4, proposer="radix",
                        spec_cooldown_max=1, device="cuda")
    runs, streams = {}, {}
    before = {k: 0.0 for k in ("prefill_chunks", "spec_steps", "draft_proposed",
                                "draft_accepted")}
    for wave in (1, 2):
        _, res, launches, streams[wave] = _engine_run(
            f"radix[wave {wave}]", smi, reqs, eng=eng, rid0=16 * (wave - 1))
        d = {k: res[k] - before[k] for k in before}
        before = {k: res[k] for k in before}
        _check_paged_launches(f"radix[wave {wave}]", d, launches, cfg.n_layers,
                              verify_steps=d["spec_steps"])
        rate = d["draft_accepted"] / d["draft_proposed"] if d["draft_proposed"] else 0.0
        log(f"radix[wave {wave}]: acceptance {rate} ({d['draft_accepted']} of "
            f"{d['draft_proposed']}), verify steps {d['spec_steps']}, prefill "
            f"chunks {d['prefill_chunks']}, tpot_p50 (cumulative) "
            f"{res['tpot_p50_ms']} ms")
        runs[f"radix.wave{wave}"] = (dict(res, **{f"wave_{k}": v for k, v in d.items()}),
                                     launches)
    if runs["radix.wave2"][0]["wave_draft_accepted"] <= 0:
        raise AssertionError("radix: wave 2 accepted no draft from the trie")
    _trie_sweep("radix", eng)
    # Wave 2 commits through verify windows (B6) what wave 1 decoded
    # (B5), as serve[spec] does beside its plain run: a stream may leave
    # wave 1's only at a near-tie.
    _check_near_ties("radix wave 2 vs wave 1", _first_divergence_gaps(
        params, streams[1], streams[2], _stream_context(prompts, streams[1])),
        len(streams[1]))
    del eng
    return runs


def tiny_prefix_check():
    """The tiny config in fp32, card vs CPU, on one weight set drawn on
    the CPU: the same streams with the prefix cache off and on, the tier
    on over a 12-page pool (spills and rehydrates on both devices, the
    same counts), a ``register_prefix`` session's next turn, the radix
    proposer, and ``serve(turns=3)`` on the contiguous path, greedy and
    sampled."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config()
    cpu_params = tfm.init_params(cfg, seed=0, device="cpu")

    def on(device):
        return {k: ({n: t.to(device) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(device))
                for k, v in cpu_params.items()}

    rng = np.random.default_rng(5)
    fams = [rng.integers(0, cfg.vocab_size, 16) for _ in range(4)]
    reqs = [(i, np.concatenate([fams[i % 4], rng.integers(0, cfg.vocab_size,
                                                          1 + i % 4)]).astype(np.int32))
            for i in range(12)]
    cases = {
        "off": dict(n_slots=2, max_seq=32),
        "on": dict(n_slots=2, max_seq=32, prefix_cache=True),
        "tier": dict(n_slots=2, max_seq=32, prefix_cache=True,
                     kv_pool_blocks=12, host_kv_mb=1.0),
        # The prompts twice: the repeats draft the first replies.
        "radix": dict(n_slots=2, max_seq=32, prefix_cache=True,
                      kv_pool_blocks=96, spec_decode=True, draft_k=4,
                      proposer="radix", spec_cooldown_max=1),
    }
    got = {}
    for device in ("cuda", "cpu"):
        params = on(device)
        for name, kw in cases.items():
            eng = ServingEngine(cfg, params, prefill_mode="bucketed", block_size=4,
                                device=device, **kw)
            work = reqs + ([(100 + i, p) for i, p in reqs] if name == "radix"
                           else [])
            out = eng.run([Request(rid=i, prompt=p,
                                   max_new_tokens=12 if name == "radix" else 4)
                           for i, p in work])
            got[(name, device)] = (
                {c.rid: c.tokens for c in out},
                {k: getattr(eng.stats, k) for k in (
                    "prefix_hit_tokens", "spilled_pages", "rehydrate_hits",
                    "rehydrate_tokens", "draft_accepted")})
        # register_prefix: a contiguous session, then its next turn.
        prompt = torch.from_numpy(reqs[0][1][None]).to(device)
        cache = gen.init_kv_cache(cfg, 1, 64, device=device)
        logits, cache = gen.prefill(cfg, params, prompt, cache)
        toks, _, cache = gen.generate_from_cache(cfg, params, logits, cache, 8,
                                                 return_state=True)
        session = np.concatenate([reqs[0][1], toks[0].cpu().numpy().astype(np.int32)])
        eng = ServingEngine(cfg, params, n_slots=1, max_seq=64,
                            prefill_mode="bucketed", block_size=4,
                            prefix_cache=True, device=device)
        reg = eng.register_prefix(session, cache)
        out = eng.run([Request(rid=0, prompt=np.concatenate([session, reqs[1][1]]),
                               max_new_tokens=6)])
        got[("register", device)] = (out[0].tokens, (reg, eng.stats.prefix_hit_tokens))
        # serve(turns=3) on the contiguous path, greedy and sampled.
        saved = serve_lm._load_params
        serve_lm._load_params = lambda *a, **k: (params, None)
        try:
            for name, kw in (("turns", {}), ("turns.sampled", dict(temperature=0.8,
                                                                   seed=3))):
                path = os.path.join(OUT_DIR, f"tiny_{name}_{device}.jsonl")
                serve_lm.serve(config="tiny", batch=3, prompt_len=9,
                               max_new_tokens=5, turns=3, output_file=path,
                               device=device, **kw)
                got[(name, device)] = ([r["completion"] for r in _read_completions(path)],
                                     None)
        finally:
            serve_lm._load_params = saved
    for name in list(cases) + ["register", "turns", "turns.sampled"]:
        if got[(name, "cuda")] != got[(name, "cpu")]:
            raise AssertionError(f"prefix[tiny] {name}: card {got[(name, 'cuda')]} "
                                 f"!= cpu {got[(name, 'cpu')]}")
    if got[("on", "cpu")][0] != got[("off", "cpu")][0] or got[("tier", "cpu")][0] != got[("off", "cpu")][0]:
        raise AssertionError("prefix[tiny]: cache or tier changed a stream")
    tier = got[("tier", "cuda")][1]
    if tier["spilled_pages"] <= 0 or tier["rehydrate_hits"] <= 0:
        raise AssertionError(f"prefix[tiny]: the tier did not spill and rehydrate: {tier}")
    if got[("radix", "cuda")][1]["draft_accepted"] <= 0:
        raise AssertionError("prefix[tiny]: no radix draft accepted")
    log(f"prefix[tiny] fp32: cuda kernels and cpu plain versions commit the same "
        f"streams with the cache off and on, the tier on ({tier}), register_prefix "
        f"{got[('register', 'cuda')][1]}, the radix proposer "
        f"({got[('radix', 'cuda')][1]}), and serve(turns=3) greedy and sampled")


def prefix_phase(smi):
    """The prefix-cache phases on one set of ``SERVE_CONFIG`` weights, then the
    tiny config card vs CPU; the weights are dropped at the end."""
    runs = {}
    try:
        for fn in (prefix_serve_phase, tier_serve_phase, multiturn_phase,
                   radix_spec_phase):
            t = time.perf_counter()
            runs.update(fn(smi))
            log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
    finally:
        _drop_llama()
    tiny_prefix_check()
    return runs


# -- the serving fleet: disaggregation, chaos, prefix pulls ---------------------

#: The fleet phase's fake clock step a router quantum (seconds).
FLEET_DT = 0.05
#: The chaos plan's hang on decode-0: from this clock reading (decode-0
#: then decodes the first requests it took), this many quanta: long
#: enough that the requests the watchdog takes off it prefill again and
#: finish on decode-1 before it wakes (its stale copies then complete
#: second, and are dropped). The watchdog strikes a busy replica whose
#: heartbeat stalls FLEET_WATCHDOG_S.
FLEET_HANG_AFTER = 1.0
FLEET_HANG_FIRES = 48
FLEET_WATCHDOG_S = 0.3


class _FleetClock:
    """A clock the fleet phase advances by FLEET_DT a router quantum, so
    that the fault plan's windows and the watchdog read quanta, not the
    host's speed."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _page_bytes(cfg, kv_quant=""):
    """One pool page's K and V (and int8 scales) over every layer: the
    unit a migration ships."""
    import torch

    kv = 2 * cfg.n_layers * 16 * cfg.n_kv_heads
    if kv_quant == "int8":
        return kv * cfg.head_dim + kv * 4
    return kv * cfg.head_dim * torch.empty((), dtype=cfg.dtype).element_size()


def _serve_prompts(vocab, batch=16, prompt_len=256):
    """The synthetic prompts ``serve()`` draws when given no input file."""
    import numpy as np

    return np.random.default_rng(0).integers(0, vocab, (batch, prompt_len)).astype(
        np.int32)


def _pool_bytes(eng):
    return sum(t.numel() * t.element_size() for t in (
        eng.cache.k, eng.cache.v, eng.cache.k_scale, eng.cache.v_scale)
        if t is not None)


def _fleet_engine(clock, injector=None, **kw):
    """A replica of ``serve(disagg=True)``'s shape on the ``SERVE_CONFIG``
    weights: 8 slots of 256 + 32 tokens, bucketed prefill, the prefix
    cache, pages of 16."""
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import ServingEngine

    cfg, params = _llama()
    return ServingEngine(cfg, params, n_slots=8, max_seq=288, prefill_mode="bucketed",
                         prefix_cache=True, block_size=16, clock=clock,
                         injector=injector, device="cuda", **kw)


def _pump_fleet(router, clock, label, steps=4000, until=None):
    """Step the fleet on its fake clock until it idles (or ``until()``)."""
    for _ in range(steps):
        if until is not None and until():
            return
        if until is None and router.idle:
            return
        clock.t += FLEET_DT
        router.step()
    raise AssertionError(f"{label}: the fleet did not settle in {steps} quanta "
                         f"({router.pending} pending)")


def _near_tie_streams(label, want, got, prompts):
    """Each stream of ``got`` equal to ``want``'s, or leaving it only at a
    near-tie (SPEC_FLIP_GAP_OF_RMS) on the ``SERVE_CONFIG`` weights."""
    gaps = (_first_divergence_gaps(_llama()[1], want, got,
                                   _stream_context(prompts, want))
            if want != got else [])
    _check_near_ties(label, gaps, len(got))


def _trace_ms(doc, name):
    """Each rid's durations (ms) of the complete spans named ``name``."""
    return sorted(e["dur"] / 1e3 for e in doc["traceEvents"]
                  if e.get("name") == name and e.get("ph") == "X")


def _fleet_disagg(smi, n_layers, cfg, prompts):
    """(a) and (b): ``serve(disagg=True)`` traced, untraced and on an int8
    pool, beside the one-engine bucketed run with the prefix cache."""
    from kubeflow_controller_tpu_torch.obs.trace import load_chrome_trace

    runs = {}
    one_res, one_l, one = _serve_run("fleet.one", smi, 16, prefill_mode="bucketed",
                                     prefix_cache=True)
    runs["fleet.one"] = (one_res, one_l)
    trace = os.path.join(OUT_DIR, "fleet_trace.json")
    res, launches, dis = _serve_run("fleet.disagg", smi, 16, disagg=True, trace=trace)
    runs["fleet.disagg"] = (res, launches)
    doc = load_chrome_trace(trace)
    # Every decode dispatch is decode-0's (prefill-0's slots never
    # decode): B5 = its dispatches x decode_chunk (4) x the layers.
    dispatches = sum(1 for e in doc["traceEvents"]
                     if e.get("name") == "dispatch" and e.get("cat") == "dataplane")
    chunks = 16 * 256 // 16
    want = {"paged_chunk": chunks * n_layers, "flash_fwd": 0, "rope_rotate": 0,
            "paged_decode": dispatches * 4 * n_layers}
    got = {k: launches[k] for k in want}
    if got != want or one_l["paged_chunk"] != chunks * n_layers:
        raise AssertionError(f"fleet[disagg]: launches {launches}, want {want} "
                             f"(one engine: {one_l})")
    page = _page_bytes(cfg)
    counters = {k: res[k] for k in ("migrations", "pages_migrated",
                                    "migrated_zero_copy_tokens", "migration_bytes")}
    if counters != {"migrations": 16, "pages_migrated": chunks,
                    "migrated_zero_copy_tokens": 0,
                    "migration_bytes": chunks * page}:
        raise AssertionError(f"fleet[disagg]: {counters}, want 16 migrations of "
                             f"{chunks} pages, {chunks * page} B")
    _near_tie_streams("fleet disagg vs one engine", one, dis, prompts)
    # (b) the trace: one export, one install and one router hop a rid.
    per_rid = {}
    for e in doc["traceEvents"]:
        rid = e.get("args", {}).get("rid")
        if rid is not None and e["name"] in ("migrate_export", "migrate_install",
                                             "migrate"):
            key = (e["name"], e["cat"])
            per_rid.setdefault(rid, {}).setdefault(key, 0)
            per_rid[rid][key] += 1
    want_rid = {("migrate_export", "dataplane"): 1,
                ("migrate_install", "dataplane"): 1, ("migrate", "router"): 1}
    if sorted(per_rid) != sorted(map(str, range(16))) or any(
            v != want_rid for v in per_rid.values()):
        raise AssertionError(f"fleet[trace]: per-rid migration events {per_rid}")
    if res["spans_dropped"] != 0 or doc["otherData"]["spans_dropped"] != 0:
        raise AssertionError(f"fleet[trace]: {res['spans_dropped']} spans dropped")
    exp, ins = _trace_ms(doc, "migrate_export"), _trace_ms(doc, "migrate_install")
    log(f"fleet disagg vs one engine ({SERVE_CONFIG}, 16 requests of 256 + 32, this "
        f"run, {smi}): ttft_p50 {res['ttft_p50_ms']} vs {one_res['ttft_p50_ms']} ms, "
        f"ttft_p95 {res['ttft_p95_ms']} vs {one_res['ttft_p95_ms']} ms, tpot_p50 "
        f"{res['tpot_p50_ms']} vs {one_res['tpot_p50_ms']} ms, tokens/s "
        f"{res['tokens_per_sec']} vs {one_res['tokens_per_sec']}, wall {res['wall_s']} "
        f"vs {one_res['wall_s']} s; migrate_export ms a request p50 "
        f"{exp[len(exp) // 2]} max {exp[-1]} (16 pages, {16 * page} B, copies "
        f"enqueued), migrate_install p50 {ins[len(ins) // 2]} max {ins[-1]}; "
        f"{res['spans_recorded']} spans, decode dispatches {dispatches}")
    # The same run without the tracer: the same streams and launches.
    res2, launches2, dis2 = _serve_run("fleet.disagg.untraced", smi, 16, disagg=True)
    if dis2 != dis or launches2 != launches:
        raise AssertionError(f"fleet[untraced]: launches {launches2} vs {launches}, "
                             f"streams equal {dis2 == dis}")
    runs["fleet.disagg.untraced"] = (res2, launches2)
    # An int8 pool ships its codes and scales raw.
    res8, launches8, _ = _serve_run("fleet.disagg.int8", smi, 4, disagg=True,
                                    kv_quant="int8")
    page8 = _page_bytes(cfg, "int8")
    if (res8["migrations"], res8["pages_migrated"], res8["migration_bytes"]) != (
            4, 64, 64 * page8) or launches8["paged_chunk"] != 64 * n_layers:
        raise AssertionError(f"fleet[int8]: {res8['migrations']} migrations, "
                             f"{res8['pages_migrated']} pages, {res8['migration_bytes']} "
                             f"B (want 4, 64, {64 * page8}); launches {launches8}")
    runs["fleet.disagg.int8"] = (res8, launches8)
    return runs, one


def _fleet_chaos(smi, n_layers, prompts, one):
    """(c) and (e): three engines under one fault plan (a lost payload, a
    lost ACK, a hang window on decode-0 with the watchdog), decode-1
    killed mid-decode, then a rolling restart of every replica with
    traffic in flight; conservation, no duplicate delivery, the fires
    accounted for, the streams (a)'s, and every engine let go of freed."""
    import gc
    import weakref

    import torch

    from kubeflow_controller_tpu_torch.dataplane.faults import FaultInjector, FaultPlan
    from kubeflow_controller_tpu_torch.dataplane.router import FleetRouter
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request

    _llama()                            # the weights stay: not the fleet's
    gc.collect()
    torch.cuda.synchronize()
    m_before = torch.cuda.memory_allocated()
    clock = _FleetClock()
    plan = FaultPlan.from_dict({"specs": [
        {"kind": "drop_migration", "site": "router.migrate", "max_fires": 1},
        {"kind": "drop_migration", "site": "router.migrate_ack", "max_fires": 1},
        {"kind": "hang", "site": "engine.step", "target": "decode-0",
         "after": FLEET_HANG_AFTER, "max_fires": FLEET_HANG_FIRES}]})
    inj = FaultInjector(plan, clock=clock, seed=0)
    router = FleetRouter(clock=clock, block_size=16, injector=inj,
                         watchdog_stale_s=FLEET_WATCHDOG_S)
    for name, role in (("prefill-0", "prefill"), ("decode-0", "decode"),
                       ("decode-1", "decode")):
        router.add_replica(name, _fleet_engine(clock, inj), role=role)
    pool = _pool_bytes(router.get_replica("decode-1").engine)

    def run():
        # Eight requests, the hang's window, then eight more; decode-1 is
        # killed once decode-0 is back and decode-1 decodes.
        for rid in range(8):
            router.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=32))
        _pump_fleet(router, clock, "fleet[chaos]", until=lambda: inj.fired.get(
            ("engine.step", "hang"), 0) == FLEET_HANG_FIRES)
        for rid in range(8, 16):
            router.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=32))
        _pump_fleet(router, clock, "fleet[chaos]", until=lambda: (
            router.get_replica("decode-0").healthy
            and router.get_replica("decode-1").engine.n_active > 0))
        torch.cuda.synchronize()
        m_pre = torch.cuda.memory_allocated()
        gone = weakref.ref(router.get_replica("decode-1").engine)
        moved = router.kill("decode-1")
        gc.collect()
        torch.cuda.synchronize()
        m_post = torch.cuda.memory_allocated()
        if gone() is not None or m_pre - m_post < pool:
            raise AssertionError(f"fleet[kill]: engine collected {gone() is None}, "
                                 f"{m_pre - m_post} B freed, its pool {pool} B")
        log(f"fleet[kill]: decode-1 killed at {clock.t:.2f} s with {len(moved)} "
            f"requests re-dispatched; {m_pre - m_post} B freed (its pool {pool} B)")
        _pump_fleet(router, clock, "fleet[chaos]")

    _, wall, launches = _counted(run)
    fs = router.fleet_summary()
    comps = router.completions
    streams = {c.rid: list(map(int, c.tokens)) for c in comps}
    fires = inj.summary()
    if (fs["submitted"] != fs["completed"] + fs["rejected"] + fs["cancelled"]
            or fs["completed"] != 16 or fs["pending"] != 0
            or len(comps) != len({c.rid for c in comps})):
        raise AssertionError(f"fleet[chaos]: books {fs}, {len(comps)} completions")
    if (fs["migrate_dedups"] != 1 or fs["migration_timeouts"] != 2
            or fs["faults_injected"] != FLEET_HANG_FIRES
            or inj.total_fires != FLEET_HANG_FIRES + 2
            or fs["watchdog_strikes"] < 1 or fs["redispatched"] < 1):
        raise AssertionError(f"fleet[chaos]: {fs}, fires {fires}")
    if (launches["flash_fwd"] or launches["paged_chunk"] % n_layers
            or launches["paged_decode"] % n_layers or not launches["paged_decode"]):
        raise AssertionError(f"fleet[chaos]: launches {launches}")
    _near_tie_streams("fleet chaos vs one engine", one, streams, prompts)
    log(f"fleet[chaos] ({SERVE_CONFIG}, 3 engines, 16 requests, {smi}): wall {wall} s, "
        f"{clock.t:.2f} s of fleet clock; watchdog strikes {fs['watchdog_strikes']}, "
        f"ejections {fs['ejections']}, readmissions {fs['readmissions']}, "
        f"redispatched {fs['redispatched']}, duplicate completions "
        f"{fs['duplicate_completions']}, migrations {fs['migrations']}, dedups "
        f"{fs['migrate_dedups']}, fires {json.dumps(fires)}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    runs = {"fleet.chaos": (fs, launches)}

    # The rolling restart, 8 requests in flight.
    old = [weakref.ref(h.engine) for h in router.replicas]

    def restart():
        for rid in range(16, 24):
            router.submit(Request(rid=rid, prompt=prompts[rid - 16], max_new_tokens=32))
        for _ in range(6):
            clock.t += FLEET_DT
            router.step()
        router.rolling_restart(lambda name: _fleet_engine(clock, inj), grace_s=5.0)
        _pump_fleet(router, clock, "fleet[restart]")

    _, wall, launches = _counted(restart)
    gc.collect()
    torch.cuda.synchronize()
    fs = router.fleet_summary()
    comps = router.completions
    if (fs["completed"] != 24 or fs["submitted"] != 24 or fs["rejected"]
            or fs["cancelled"] or len(comps) != len({c.rid for c in comps})
            or any(r() is not None for r in old)):
        raise AssertionError(f"fleet[restart]: {fs}; old engines alive "
                             f"{[r() is not None for r in old]}")
    streams = {c.rid - 16: list(map(int, c.tokens)) for c in comps if c.rid >= 16}
    _near_tie_streams("fleet restart vs one engine", {r: one[r] for r in range(8)},
                      streams, prompts)
    live = torch.cuda.memory_allocated()
    del router, comps
    gc.collect()
    torch.cuda.synchronize()
    m_after = torch.cuda.memory_allocated()
    log(f"fleet[restart]: 8 requests through a rolling restart of 3 engines, wall "
        f"{wall} s, dropped 0, redispatched {fs['redispatched']}; allocated before "
        f"the fleet {m_before} B, with its 2 live engines {live} B, after it "
        f"{m_after} B (a pool {pool} B); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if m_after - m_before > pool:
        raise AssertionError(f"fleet[memory]: {m_after - m_before} B still allocated "
                             f"after the fleet, more than a pool ({pool} B)")
    runs["fleet.restart"] = (fs, launches)
    return runs


def _fleet_prefix_pull(smi, n_layers, cfg):
    """(d): two mixed replicas with host tiers; 8 requests behind one
    192-token prefix in two waves of 4; the owner is cordoned after the
    first, so the second routes away and pulls the prefix. Held against
    one engine serving the same two waves."""
    import numpy as np

    from kubeflow_controller_tpu_torch.dataplane.router import FleetRouter
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request

    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 192)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 64)]).astype(
        np.int32) for _ in range(8)]
    waves = (range(4), range(4, 8))

    def reqs(rids):
        return [Request(rid=r, prompt=prompts[r], max_new_tokens=32) for r in rids]

    eng = _fleet_engine(_FleetClock())
    (out1, out2), _, one_l = _counted(lambda: [eng.run(reqs(w)) for w in waves])
    one = {c.rid: list(map(int, c.tokens)) for c in out1 + out2}
    del eng
    clock = _FleetClock()
    router = FleetRouter(clock=clock, block_size=16)
    for name in ("m0", "m1"):
        router.add_replica(name, _fleet_engine(clock, host_kv_mb=64.0))

    def run():
        for r in reqs(waves[0]):
            router.submit(r)
        _pump_fleet(router, clock, "fleet[pull]")
        # Affinity sent the whole wave where its first request went.
        owner = next(iter(router._owners.values()))
        router.get_replica(owner).cordoned = True
        for r in reqs(waves[1]):
            router.submit(r)
        _pump_fleet(router, clock, "fleet[pull]")
        return owner

    owner, wall, launches = _counted(run)
    fs = router.fleet_summary()
    recv = next(h.engine for h in router.replicas if h.name != owner)
    streams = {c.rid: list(map(int, c.tokens)) for c in router.completions}
    if (fs["prefix_pulls"] < 1 or fs["prefix_pull_pages"] != 12
            or recv.stats.rehydrate_hits < 1 or fs["completed"] != 8):
        raise AssertionError(f"fleet[pull]: {fs}, receiver rehydrate hits "
                             f"{recv.stats.rehydrate_hits}")
    _near_tie_streams("fleet prefix pull vs one engine", one, streams, prompts)
    log(f"fleet[pull] ({SERVE_CONFIG}, {smi}): owner {owner} cordoned after wave 1; "
        f"prefix pulls {fs['prefix_pulls']}, pages {fs['prefix_pull_pages']}, bytes "
        f"{fs['prefix_pull_bytes']}, receiver rehydrate hits "
        f"{recv.stats.rehydrate_hits} ({recv.stats.rehydrate_tokens} tokens); wall "
        f"{wall} s; launches {launches} (one engine {one_l})")
    if launches["flash_fwd"] or launches["paged_chunk"] % n_layers:
        raise AssertionError(f"fleet[pull]: launches {launches}")
    return {"fleet.pull": (fs, launches)}


def _fleet_lmservice(smi, n_layers, prompts, one):
    """(f) The LMService loop: the control plane's pods become the fleet's
    replicas. An LMService of 3 replicas, 1 of them prefill, through the
    port's ``LocalRuntime`` until its 3 pods run; ``sync_fleet_from_pods``
    builds a ``serve(disagg=True)``-shaped engine a pod on the
    ``SERVE_CONFIG`` weights, its role from the pod's ``LABEL_ROLE``; the
    16 requests served disaggregated on the host's clock, with every
    serving kernel's count zeroed just before and read just after: B6 256
    chunks x the layers (on the prefill replica), B5 the decode engines'
    dispatches (from the trace) x 4 x the layers, B1 none; the streams the
    one engine's, or off only after a near-tie. Then a decode pod crashed:
    the next sync removes its replica, the controller recreates the pod,
    the sync after it adds the replica back, the membership 3 again."""
    from kubeflow_controller_tpu_torch.api.core import ObjectMeta
    from kubeflow_controller_tpu_torch.api.types import LMService, LMServiceSpec
    from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
    from kubeflow_controller_tpu_torch.dataplane.router import (
        FleetRouter, sync_fleet_from_pods,
    )
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request
    from kubeflow_controller_tpu_torch.obs.trace import Tracer
    from kubeflow_controller_tpu_torch.runtime import LocalRuntime
    from kubeflow_controller_tpu_torch.tpu import naming

    rt = LocalRuntime(PodRunPolicy(start_delay=1.0, run_duration=1e9))
    tracer = Tracer()

    def pods():
        return sorted(rt.client.list_pods("default", {naming.LABEL_LMSERVICE: "llama"}),
                      key=lambda p: p.metadata.name)

    def running():
        ps = pods()
        return len(ps) == 3 and all(p.status.phase.value == "Running" for p in ps)

    def factory(name):
        return _fleet_engine(time.perf_counter, tracer=tracer)

    try:
        rt.submit_lmservice(LMService(
            metadata=ObjectMeta(name="llama", namespace="default"),
            spec=LMServiceSpec(model=SERVE_CONFIG, replicas=3, prefill_replicas=1)))
        if not rt.run_until(running, max_steps=20):
            raise AssertionError("fleet[lmservice]: pods " + str(
                [(p.metadata.name, p.status.phase.value) for p in pods()]))
        router = FleetRouter(clock=time.perf_counter, block_size=16, tracer=tracer)
        t0 = time.perf_counter()
        added, removed = sync_fleet_from_pods(router, pods(), factory)
        roles = {h.name: h.role for h in router.replicas}
        labels = {p.metadata.name: p.metadata.labels[naming.LABEL_ROLE] for p in pods()}
        if (sorted(added) != sorted(labels) or removed or roles != labels
                or sorted(roles.values()) != ["decode", "decode", "prefill"]
                or not router.two_stage):
            raise AssertionError(f"fleet[lmservice]: sync ({added}, {removed}), roles "
                                 f"{roles}, labels {labels}")
        sync_s = time.perf_counter() - t0
        for i in range(len(prompts)):
            router.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=32))
        completions = []

        def pump():
            for _ in range(20000):
                completions.extend(router.step())
                if router.idle:
                    return
            raise AssertionError(f"fleet[lmservice]: {router.pending} pending")

        _, wall, launches = _counted(pump)
        streams = {c.rid: list(map(int, c.tokens)) for c in completions}
        _check_streams("fleet[lmservice]", streams, list(range(len(prompts))), 32,
                       _case_config(SERVE_CONFIG).vocab_size)
        dispatches = sum(1 for sp in tracer.snapshot()
                         if sp.name == "dispatch" and sp.track == "dataplane")
        chunks = len(prompts) * prompts.shape[1] // 16
        want = {"paged_chunk": chunks * n_layers, "flash_fwd": 0, "rope_rotate": 0,
                "paged_decode": dispatches * 4 * n_layers}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"fleet[lmservice]: launches {launches}, want {want}")
        _near_tie_streams("fleet lmservice vs one engine", one, streams, prompts)
        summary = router.fleet_summary()
        # A decode pod crashed: the controller deletes and recreates it;
        # the router follows the pods.
        victim = next(n for n, r in sorted(labels.items()) if r == "decode")
        rt.cluster.crash_pod("default", victim)
        rt.controller.drain()
        after_crash = sync_fleet_from_pods(router, pods(), factory)
        if not rt.run_until(running, max_steps=20):
            raise AssertionError(f"fleet[lmservice]: {victim} not recreated")
        after_restart = sync_fleet_from_pods(router, pods(), factory)
        members = sorted((h.name, h.role) for h in router.replicas)
        if (after_crash != ([], [victim]) or after_restart != ([victim], [])
                or members != sorted(labels.items())):
            raise AssertionError(f"fleet[lmservice]: after the crash {after_crash}, "
                                 f"after the restart {after_restart}, members {members}")
        res = {"wall_s": wall, "sync_s": sync_s, "decode_dispatches": dispatches,
               "victim": victim, "after_crash": after_crash,
               "after_restart": after_restart, "roles": roles,
               "syncs": rt.controller.sync_count,
               **{k: summary[k] for k in ("migrations", "pages_migrated",
                                          "migration_bytes") if k in summary}}
        log(f"fleet[lmservice] {SERVE_CONFIG}: {json.dumps(res)}, launches "
            f"{ {k: v for k, v in launches.items() if v} } | {smi}")
        return {"lmservice": (res, launches)}
    finally:
        rt.stop()


def fleet_phase(smi):
    """The serving fleet on ``SERVE_CONFIG`` (llama3_8b at full width, 4 of
    its 32 layers, pages of 16): (a) ``serve(disagg=True)`` beside the
    one-engine bucketed run with the prefix cache, each engine's
    launches (B6 256 chunks x the layers, B1 none, B5 decode-0's
    dispatches x 4 x the layers), the migration counters and bytes
    exact, the streams equal or off only after a near-tie, again on an
    int8 pool; (b) its trace (one export, one install and one router hop
    a rid, nothing dropped) and the same run untraced (the same streams
    and launches); (c) a three-engine fleet under one fault plan and a
    kill, then a rolling restart; (d) a fleet prefix pull; (e) every
    engine the fleet let go of freed; (f) the LMService loop: pods synced
    into the router's membership, served, a crash followed."""
    n_layers = _case_config(SERVE_CONFIG).n_layers
    cfg = _case_config(SERVE_CONFIG)
    prompts = _serve_prompts(cfg.vocab_size)
    try:
        runs, one = _fleet_disagg(smi, n_layers, cfg, prompts)
        runs.update(_fleet_chaos(smi, n_layers, prompts, one))
        runs.update(_fleet_prefix_pull(smi, n_layers, cfg))
        runs.update(_fleet_lmservice(smi, n_layers, prompts, one))
    finally:
        _drop_llama()
    return runs


#: The slot-path check: llama3_8b at 2 of its 32 layers (full width, bf16),
#: 4 requests of 256 prompt tokens (the flash kernels' shortest prompt)
#: and 16 new ones.
SLOT_CHECK_CONFIG = "llama3_8b_2l"


def slot_path_check(smi):
    """The contiguous per-slot reference path on the card
    (``generate.prefill_into_slot`` a request, then
    ``decode_step_slots``, greedy; plain PyTorch, B1 in each admission's
    block prefill) beside the paged engine on the same prompts (bucketed
    prefill: B6 a chunk and layer, B5 a decode micro-step and layer):
    every stream equal, or off only after a near-tie. Returns the engine's
    launches."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    cfg = _case_config(SLOT_CHECK_CONFIG)
    params = gen.init_inference_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(23)
    plen, new = 256, 16
    prompts = {i: rng.integers(0, cfg.vocab_size, plen).astype(np.int32) for i in range(4)}

    def slots():
        cache = gen.init_slot_cache(cfg, len(prompts), plen + new, device="cuda")
        rows = []
        for i, p in prompts.items():
            lg, cache = gen.prefill_into_slot(
                cfg, params, torch.from_numpy(p[None]).cuda(), cache, i)
            rows.append(lg)
        logits, toks = torch.cat(rows), []
        for _ in range(new):
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            logits, cache = gen.decode_step_slots(cfg, params, tok[:, None], cache)
        out = torch.stack(toks, 1).cpu().numpy()
        return {i: list(map(int, out[i])) for i in prompts}

    slot, slot_wall, slot_launches = _counted(slots)
    eng = ServingEngine(cfg, params, n_slots=4, max_seq=plen + new, prefill_mode="bucketed",
                        block_size=16, device="cuda")
    comps, wall, launches = _counted(lambda: eng.run(
        [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in prompts.items()]))
    paged = {c.rid: list(map(int, c.tokens)) for c in comps}
    want_chunk = len(prompts) * plen // 16 * cfg.n_layers
    if (slot_launches["paged_chunk"] or slot_launches["paged_decode"]
            or slot_launches["flash_fwd"] != len(prompts) * cfg.n_layers
            or launches["paged_chunk"] != want_chunk or not launches["paged_decode"]
            or launches["paged_decode"] % cfg.n_layers or launches["flash_fwd"]):
        raise AssertionError(f"slot path: launches {slot_launches} (want flash_fwd "
                             f"{len(prompts) * cfg.n_layers}, no paged kernel); engine "
                             f"{launches} (want paged_chunk {want_chunk})")
    _check_streams("slot path", slot, sorted(prompts), new, cfg.vocab_size)
    gaps = _first_divergence_gaps(params, slot, paged, _stream_context(prompts, slot), cfg)
    _check_near_ties("slot path vs paged engine", gaps, len(slot))
    log(f"slot path ({SLOT_CHECK_CONFIG}, 4 requests of {plen} + {new}, {smi}): slot decode "
        f"wall {slot_wall} s, launches {slot_launches}; paged engine wall {wall} s, "
        f"launches {launches}")
    del params, eng
    torch.cuda.empty_cache()
    return {"slot": slot_launches, "paged": launches}


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
    the same llama3_8b weights at all 32 layers; then ``tfm.forward``
    over the 257 tokens (the prompt and the first greedy token) as the
    yardstick: the kernel path's first- and next-token logits within
    LOGITS_REL_L2_TOL of its rows 255 and 256, the argmax the same or
    off only after a near-tie, and B1 once a layer (with its rope
    prepass) in the forward. Returns the forward's launches."""
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
        tok = first.argmax(-1).to(torch.int32)[:, None]
        nxt, cache = gen.decode_step_paged(
            cfg, params, tok, cache, view_width=mb * bs, attn_impl=impl)
        out[impl] = (first.float(), nxt.float(), tok)
    # At S=257 the JAX package's flash rule (a block that tiles S) sends
    # "auto" to the dense path; the forward asks for B1 by name.
    fcfg = cfg.replace(attn_impl="flash")
    seq = torch.cat([prompt, out["kernel"][2].long()], 1)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        full = tfm.forward(fcfg, params, seq)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = _launches()
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
    if tuple(full.shape) != (1, 257, cfg.vocab_size) or full.dtype != torch.float32:
        raise AssertionError(f"forward: logits {tuple(full.shape)} {full.dtype}")
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("forward: logits not finite")
    for i, (name, pos) in enumerate((("first-token", 255), ("next-token", 256))):
        a, want = out["kernel"][i][0], full[0, pos]
        rel = float((a - want).norm() / want.norm())
        if rel > LOGITS_REL_L2_TOL:
            raise AssertionError(
                f"{name} logits: paged kernel vs forward rel L2 {rel} > {LOGITS_REL_L2_TOL}")
        got_am, want_am = int(a.argmax()), int(want.argmax())
        gaps = ([] if got_am == want_am else
                [(0, pos, float(want[want_am] - want[got_am]),
                  float(want.pow(2).mean().sqrt()))])
        log(f"logits[{name}] paged kernel vs forward[:, {pos}]: rel L2 {rel} "
            f"(tol {LOGITS_REL_L2_TOL}), max |diff| {float((a - want).abs().max())}, "
            f"argmax {got_am} vs {want_am}")
        _check_near_ties(f"logits[{name}] vs forward", gaps, 1)
    want = {k: 0 for k in launches}
    want.update(flash_fwd=cfg.n_layers, rope_rotate=cfg.n_layers)
    log(f"forward llama3_8b (32 layers, S=257, attn flash): {fwd_s:.3f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"forward: launches {launches} != {want}")
    return launches


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
            "flash_bwd_dq": 0, "int8_quantize_rows": b7, "int8_matmul": b7,
            "int8_quantize_rows_scaled": 0, "int8_matmul_f32": 0}
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


# Checkpoint round trip: the resumed run's losses at steps 3 and 4 against
# an uninterrupted run fed the same batches (the entry point's stream
# starts again on resume, as the reference's does, so the uninterrupted
# run takes its first two batches twice). Both start from one seeded init
# and take the same schedule; the restore itself is bit for bit (the CPU
# tests), so the two differ only where B2's dq does from run to run
# (DQ_RUN_TO_RUN: one bf16 ulp, moving two updates of lr <= 3e-4 by far
# less than 1e-3 of a loss near ln(32768)). Steps 1 and 2 of the first
# run against the uninterrupted run's are logged as that spread.
RESUME_LOSS_REL_TOL = 1e-3


def checkpoint_phase(smi):
    """The flagship (335.6 M parameters, bf16, B16 S1024) through
    ``lm.train``: 2 steps into a model dir saving every step and keeping
    one checkpoint, then resumed to 4; its losses against an uninterrupted
    4-step run on the same batches; then ``serve(model_dir=...)`` must
    report restored step 4 and stream what an engine on the resumed
    loop's in-memory parameters streams. Logs save and restore seconds
    and the bytes on disk; removes the directory."""
    import shutil

    import torch

    from kubeflow_controller_tpu_torch.dataplane import train as dtrain
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    ckpt = os.path.join(OUT_DIR, "ckpt_flagship")
    shutil.rmtree(ckpt, ignore_errors=True)
    timed = {"save": [], "restore": []}
    loops = []
    real = {name: getattr(dtrain.TrainLoop, name) for name in ("save", "restore", "run")}

    def timing(name):
        def wrapped(loop, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[name](loop, *a, **k)
            torch.cuda.synchronize()
            timed[name].append(time.perf_counter() - t)
            return out
        return wrapped

    def keeping(loop, *a, **k):
        loops.append(loop)
        return real["run"](loop, *a, **k)

    def train(label, total, **kw):
        log_dir = os.path.join(OUT_DIR, f"ckpt_{label}")
        shutil.rmtree(log_dir, ignore_errors=True)
        t = time.perf_counter()
        out = lm.train(ProcessContext(log_dir=log_dir), config="flagship",
                       total_steps=total, per_data_shard_batch=16, seq_len=1024,
                       **kw)
        rows = _read_completions(os.path.join(log_dir, "metrics-p0.jsonl"))
        losses = {r["step"]: r["loss"] for r in rows}
        if not all(math.isfinite(x) for x in losses.values()):
            raise AssertionError(f"checkpoint[{label}]: losses {losses}")
        return out, losses, time.perf_counter() - t

    synthetic = lm.synthetic_lm

    def first_two_twice(*a, **k):
        it = synthetic(*a, **k)
        first = [next(it), next(it)]
        while True:
            yield from first

    lm.synthetic_lm = first_two_twice
    try:
        _, whole, whole_s = train("uninterrupted", 4)
    finally:
        lm.synthetic_lm = synthetic
    for name in ("save", "restore"):
        setattr(dtrain.TrainLoop, name, timing(name))
    dtrain.TrainLoop.run = keeping
    try:
        kw = dict(model_dir=ckpt, checkpoint_every=1, keep_checkpoints=1)
        out1, first, first_s = train("first", 2, **kw)
        out2, resumed, resumed_s = train("resumed", 4, **kw)
    finally:
        for name, fn in real.items():
            setattr(dtrain.TrainLoop, name, fn)
    if (out1["start_step"], out1["final_step"]) != (0, 2) or \
            (out2["start_step"], out2["final_step"]) != (2, 4) or \
            sorted(resumed) != [3, 4] or dtrain.checkpoint_steps(ckpt) != [4]:
        raise AssertionError(f"checkpoint: runs {out1} {out2}, steps {resumed}, "
                             f"kept {dtrain.checkpoint_steps(ckpt)}")
    spread = max(abs(first[k] - whole[k]) / abs(whole[k]) for k in (1, 2))
    rel = max(abs(resumed[k] - whole[k]) / abs(whole[k]) for k in (3, 4))
    n_bytes = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(ckpt) for f in files)
    log(f"checkpoint flagship: uninterrupted losses {whole}, first {first}, "
        f"resumed {resumed}; steps 1-2 run-to-run rel {spread}, resumed vs "
        f"uninterrupted rel {rel} (tol {RESUME_LOSS_REL_TOL}); save s "
        f"{timed['save']}, restore s {timed['restore']}, bytes on disk "
        f"{n_bytes} (one checkpoint), runs s {whole_s} / {first_s} / "
        f"{resumed_s} | {smi}")
    if not rel <= RESUME_LOSS_REL_TOL:
        raise AssertionError("checkpoint: resumed losses leave the uninterrupted run's")

    # Serve the directory, and an engine on the resumed loop's parameters.
    cfg = lm.model_config("flagship")
    out_file = os.path.join(OUT_DIR, "serve_flagship_ckpt.jsonl")
    t = time.perf_counter()
    res = serve_lm.serve(config="flagship", model_dir=ckpt, batch=8, slots=8,
                         prompt_len=256, max_new_tokens=16, output_file=out_file)
    serve_s = time.perf_counter() - t
    got = {c["rid"]: c["completion"] for c in _read_completions(out_file)}
    params = gen.inference_params(cfg, loops[-1].state.params)
    del loops[:]
    prompts = serve_lm._read_prompts("", cfg.vocab_size, 8, 256)
    eng = ServingEngine(cfg, params, n_slots=8, max_seq=256 + 16, device="cuda")
    want = {c.rid: c.tokens for c in eng.run([
        Request(rid=i, prompt=prompts[i], max_new_tokens=16) for i in range(8)])}
    log(f"checkpoint serve flagship: restored_step {res['restored_step']}, "
        f"{sum(got[r] == want[r] for r in want)} of 8 streams equal the "
        f"in-memory params', serve s {serve_s}")
    if res["restored_step"] != 4 or got != want:
        raise AssertionError(f"checkpoint serve: restored {res['restored_step']}, "
                             f"streams {got} vs in-memory {want}")
    del params, eng
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()


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


# -- weight-only int8 serving ------------------------------------------------

def _weight_bytes(params):
    """Device bytes of a serving parameter tree, each ``(q, scale)`` pair
    counted whole."""
    from kubeflow_controller_tpu_torch.convert import tree_leaves

    total = 0
    for leaf in tree_leaves(params):
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            total += t.numel() * t.element_size()
    return total


def int8_quant_check():
    """Weight-only int8's ``(q, scale)`` on the card bit for bit the CPU's,
    from the same fp32 weights: two layers of llama3_8b's wq and w_down
    and a quarter of its lm_head, a few weights scaled up to be their
    channel's maximum."""
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen

    g = torch.Generator().manual_seed(7)
    shapes = {"wq": (2, 4096, 4096), "w_down": (2, 14336, 4096),
              "lm_head": (4096, 32064)}
    checked = 0
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=g) * 0.02
        w[..., :3, :] *= 40.0
        qc, sc = gen.quantize_weight(w, torch.bfloat16)
        qg, sg = gen.quantize_weight(w.cuda(), torch.bfloat16)
        nq = int((qg.cpu() != qc).sum())
        ns = int((sg.cpu().view(torch.int16) != sc.view(torch.int16)).sum())
        if nq or ns:
            raise AssertionError(f"int8 weights[{name}]: {nq} codes and {ns} scales "
                                 "differ card vs CPU")
        checked += w.numel()
        del w, qc, sc, qg, sg
    torch.cuda.empty_cache()
    log(f"int8 weights: (q, scale) card vs CPU bit for bit over {checked} fp32 "
        f"weights ({', '.join(f'{k} {v}' for k, v in shapes.items())})")


def _tiny_int8_streams(cfg, params, prompts, device, mode, kv_quant, spec):
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )

    kw = dict(spec_decode=True, draft_k=4) if spec else {}
    eng = ServingEngine(cfg, params, n_slots=3, max_seq=32, block_size=8,
                        prefill_mode=mode, kv_quant=kv_quant, device=device, **kw)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                   for i, p in enumerate(prompts)])
    return {c.rid: c.tokens for c in out}, eng.stats.spec_steps


def tiny_int8_check():
    """The tiny config (fp32) with weight-only int8 from one CPU-drawn
    master: ``(q, scale)`` card vs CPU bit for bit; then served on the card
    (the kernels) and on the CPU (their plain versions) in exact and
    bucketed prefill, fp and int8 KV, without and with lookup
    speculation on tiled prompts: the streams must be equal, or leave
    each other only at a near-tie (``SPEC_FLIP_GAP_OF_RMS``)."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config()
    master = tfm.init_params(cfg, seed=0, device="cpu")
    p_cpu = gen.inference_params(cfg, master, quant="int8")
    p_gpu = gen.inference_params(cfg, {k: ({n: t.cuda() for n, t in v.items()}
                                           if isinstance(v, dict) else v.cuda())
                                       for k, v in master.items()}, quant="int8")
    for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(x, y.cpu()):
                raise AssertionError("serve[tiny int8]: (q, scale) card vs CPU differ")
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, 4), 5).astype(np.int32)
               for _ in range(6)]
    for mode in ("exact", "bucketed"):
        for kv_quant in ("", "int8"):
            for spec in (False, True):
                got, acc_g = _tiny_int8_streams(cfg, p_gpu, prompts, "cuda", mode,
                                                kv_quant, spec)
                want, acc_c = _tiny_int8_streams(cfg, p_cpu, prompts, "cpu", mode,
                                                 kv_quant, spec)
                label = f"serve[tiny int8 {mode} kv={kv_quant or 'fp'} spec={spec}]"
                gaps = (_first_divergence_gaps(
                    p_gpu, want, got, _stream_context(prompts, want), cfg=cfg)
                    if got != want else [])
                _check_near_ties(label, gaps, len(prompts))
                if spec and not (acc_g > 0 and acc_c > 0):
                    raise AssertionError(f"{label}: no verify step ({acc_g}, {acc_c})")


def int8_serve_phase(smi, runs):
    """``SERVE_CONFIG`` served with weight-only int8 projections (seeded
    init, quantized after it is drawn): the 16 requests of
    256 + 32 over 8 slots in exact prefill (B1 once a layer an
    admission), bucketed prefill with lookup speculation on the tiled
    prompts (B6 once a layer a chunk and a verify step), and 4 requests
    on an int8 KV pool; each with exact launch counts, beside its bf16
    twin in the same mode on the same requests (the exact and int8 KV
    runs of :func:`serve_phase`, and a bf16 bucketed speculative run
    made here just before the int8 one); the weight bytes of both;
    ``(q, scale)`` card vs CPU; the tiny config card vs CPU."""
    from kubeflow_controller_tpu_torch.models import generate as gen

    int8_quant_check()
    cfg = _case_config(SERVE_CONFIG)
    n_layers = cfg.n_layers
    out = {}
    res, launches, _ = _serve_run("int8w.exact", smi, 16, quant="int8")
    b1 = 16 * n_layers
    if (launches["flash_fwd"] != b1 or launches["rope_rotate"] != b1
            or launches["paged_chunk"] != 0 or launches["paged_decode"] <= 0
            or launches["paged_decode"] % n_layers or res["prefill_chunks"] != 0):
        raise AssertionError(f"serve[int8w.exact]: launches {launches}, want "
                             f"flash_fwd and rope_rotate {b1}, paged_chunk 0")
    out["int8w.exact"] = (res, launches)
    tiled = os.path.join(OUT_DIR, "tiled_prompts.jsonl")      # serve_phase's
    twins = {"int8w.exact": ("exact", runs["exact"][0]),
             "int8w.int8kv": ("int8", runs["int8"][0])}
    for label, quant in (("tiled.spec.bucketed", ""), ("int8w.spec", "int8")):
        res, launches, _ = _serve_run(label, smi, 16, input_file=tiled, seed=0,
                                      quant=quant, prefill_mode="bucketed",
                                      speculative=True, draft_k=4)
        if (res["draft_proposed"] <= 0 or res["spec_steps"] <= 0
                or not launches["paged_decode"]):
            raise AssertionError(f"serve[{label}]: {res}, launches {launches}")
        _check_paged_launches(f"serve[{label}]", res, launches, n_layers,
                              verify_steps=res["spec_steps"])
        out[label] = (res, launches)
    twins["int8w.spec"] = ("tiled.spec.bucketed", out.pop("tiled.spec.bucketed")[0])
    res, launches, _ = _serve_run("int8w.int8kv", smi, 4, quant="int8",
                                  kv_quant="int8", prefill_mode="bucketed")
    if not (launches["paged_decode"] and launches["paged_chunk"]):
        raise AssertionError(f"serve[int8w.int8kv]: launches {launches}")
    _check_paged_launches("serve[int8w.int8kv]", res, launches, n_layers)
    out["int8w.int8kv"] = (res, launches)
    _, params16 = _llama()
    bytes16 = _weight_bytes(params16)
    bytes8 = _weight_bytes(gen.inference_params(cfg, params16, quant="int8"))
    _drop_llama()
    log(f"int8 weights {SERVE_CONFIG}: {bytes8} bytes vs bf16 {bytes16} "
        f"({bytes8 / bytes16} of bf16) | {smi}")
    for label, (bf16, b) in twins.items():
        a = out[label][0]
        log(f"serve {label} vs bf16 serve[{bf16}] (this run): ttft_p50 "
            f"{a['ttft_p50_ms']} vs {b['ttft_p50_ms']} ms, tpot_p50 "
            f"{a['tpot_p50_ms']} vs {b['tpot_p50_ms']} ms, tokens/s "
            f"{a['tokens_per_sec']} vs {b['tokens_per_sec']}, acceptance "
            f"{a['acceptance_rate']} vs {b['acceptance_rate']}, modelled "
            f"hbm_bytes_per_step {a['hbm_bytes_per_step']} vs "
            f"{b['hbm_bytes_per_step']}")
    tiny_int8_check()
    return out


# -- the mixture-of-experts decoder -------------------------------------------------

#: The mixtral_8x7b exact serve run's launches a layer, written in PERF.md
#: before the first run: B1 and its rope prepass once a layer an admission
#: (16), B5 once a layer a decode micro-step (72 micro-steps for 16
#: requests of 32 tokens over 8 slots, the llama3_8b run's schedule), no
#: B6.
MIXTRAL_EXACT_LAUNCHES = {"flash_fwd": 16, "rope_rotate": 16, "paged_decode": 72,
                          "paged_chunk": 0}
#: tiny_moe (fp32, TF32 off) card vs CPU: only summation order differs, and
#: routing runs in fp32 on both, so the logits, the loss and each gradient
#: leaf agree to ~1e-6 relative unless a router near-tie flips a pick.
MOE_TINY_REL_TOL = 1e-4
MOE_TRAIN_STEPS = 8


def _rel_l2(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def moe_tiny_check():
    """tiny_moe (fp32) on the card against the CPU from one CPU-drawn
    init: the forward's logits and MoE aux, the loss and every gradient
    of ``next_token_loss`` under the einsum and the gather dispatch
    (``MOE_TINY_REL_TOL``); then greedy engine streams card vs CPU with
    exact prefill, with lookup speculation on tiled prompts (which must
    accept drafts) and with int8 weights: equal, or leaving each other
    only at a near-tie (``SPEC_FLIP_GAP_OF_RMS``)."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_moe_config()
    init = tfm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 65)))
    for dispatch in ("einsum", "gather"):
        c = cfg.replace(moe_dispatch=dispatch)
        got = {}
        for device in ("cuda", "cpu"):
            params = _to(init, device)
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            tok = tokens.to(device)
            loss, metrics = tfm.next_token_loss(c, params, {"tokens": tok})
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                hidden, aux = tfm.forward_hidden(c, params, tok)
                logits = hidden @ params["lm_head"]
            got[device] = (loss.detach(), grads, logits, aux,
                           metrics["moe_drop_rate"].detach())
        (lg, gg, og, ag, dg), (lc, gc, oc, ac, dc) = got["cuda"], got["cpu"]
        errs = {"loss": _rel_l2(lg, lc), "logits": _rel_l2(og, oc),
                "aux": _rel_l2(ag, ac),
                "grad_leaf_max": max(_rel_l2(a, b) for a, b in zip(gg, gc))}
        log(f"moe[tiny] fp32 {dispatch}: cuda vs cpu {json.dumps(errs)} (tol "
            f"{MOE_TINY_REL_TOL}), drop rate {float(dg)} vs {float(dc)}")
        if not all(v <= MOE_TINY_REL_TOL for v in errs.values()):
            raise AssertionError(f"moe[tiny] {dispatch}: cuda vs cpu {errs}")

    rng = np.random.default_rng(2)
    random_prompts = [rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
                      for _ in range(6)]
    # Tiled prompts on which lookup finds drafts for these weights (3
    # verify steps on the CPU): a random tiny model seldom continues a
    # pattern.
    rng = np.random.default_rng(3)
    tiled = [np.tile(rng.integers(0, cfg.vocab_size, 4), 5).astype(np.int32)
             for _ in range(6)]
    for label, quant, prompts, spec in (("exact", "", random_prompts, False),
                                        ("exact.spec", "", tiled, True),
                                        ("int8w.exact", "int8", random_prompts, False)):
        p_cpu = gen.inference_params(cfg, init, quant=quant)
        p_gpu = gen.inference_params(cfg, _to(init, "cuda"), quant=quant)
        got, acc_g = _tiny_int8_streams(cfg, p_gpu, prompts, "cuda", "exact", "", spec)
        want, acc_c = _tiny_int8_streams(cfg, p_cpu, prompts, "cpu", "exact", "", spec)
        name = f"moe[tiny {label}]"
        gaps = (_first_divergence_gaps(p_gpu, want, got,
                                       _stream_context(prompts, want), cfg=cfg)
                if got != want else [])
        _check_near_ties(name, gaps, len(prompts))
        if spec and not (acc_g > 0 and acc_c > 0):
            raise AssertionError(f"{name}: no verify step ({acc_g}, {acc_c})")


def mixtral_serve_phase(smi):
    """mixtral_8x7b at full width (8 experts, top-2, d_ff 14336) and 8
    of its 32 layers (``MOE_SERVE_CONFIG``) served with weight-only int8
    from the streamed seeded init (``serve(quant="int8")``: at 32 layers
    the bf16 tree would not fit): the 16 requests of 256 + 32 over 8
    slots in exact prefill (launches :data:`MIXTRAL_EXACT_LAUNCHES` a
    layer exactly), then the 16 tiled prompts in
    exact prefill and with lookup speculation (``draft_k=4``: B6 once a
    layer a verify step), the speculative streams held to the exact
    ones under the near-tie rule. Logs each run's peak memory beside the
    summary, and the int8 tree's bytes."""
    import gc

    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen

    cfg = _case_config(MOE_SERVE_CONFIG)
    n_layers = cfg.n_layers
    runs = {}

    def run(label, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, streams = _serve_run(label, smi, 16, config=MOE_SERVE_CONFIG,
                                            quant="int8", **kw)
        peak = torch.cuda.max_memory_allocated()
        log(f"serve[{label}] mixtral_8x7b int8: peak memory {peak} bytes "
            f"({peak / 1e9} GB), moe_tokens_dispatched "
            f"{res['moe_tokens_dispatched']} | {smi}")
        runs[label] = (res, launches, peak)
        return res, launches, streams

    res, launches, _ = run("mixtral.exact")
    got = {k: launches[k] for k in MIXTRAL_EXACT_LAUNCHES}
    want = {k: v * n_layers for k, v in MIXTRAL_EXACT_LAUNCHES.items()}
    if got != want or res["prefill_chunks"] != 0:
        raise AssertionError(f"serve[mixtral.exact]: launches {got} != {want}")
    tiled = _tiled_prompts(os.path.join(OUT_DIR, "mixtral_tiled_prompts.jsonl"),
                           cfg.vocab_size, 16, 0)
    prompts = [r["prompt"] for r in _read_completions(tiled)]
    _, launches, plain = run("mixtral.tiled.exact", input_file=tiled)
    if (launches["flash_fwd"] != 16 * n_layers or launches["paged_chunk"]
            or launches["paged_decode"] % n_layers):
        raise AssertionError(f"serve[mixtral.tiled.exact]: launches {launches}")
    res, launches, spec = run("mixtral.tiled.spec", input_file=tiled,
                              speculative=True, draft_k=4)
    if (res["draft_proposed"] <= 0 or res["spec_steps"] <= 0
            or launches["flash_fwd"] != 16 * n_layers
            or launches["paged_chunk"] != res["spec_steps"] * n_layers
            or launches["paged_decode"] % n_layers):
        raise AssertionError(f"serve[mixtral.tiled.spec]: {res}, launches "
                             f"{launches}: want paged_chunk = spec_steps x {n_layers}")
    plain_res = runs["mixtral.tiled.exact"][0]
    log(f"serve mixtral spec vs exact (tiled prompts, this run): acceptance "
        f"{res['acceptance_rate']}, verify steps {res['spec_steps']}, tpot_p50 "
        f"{res['tpot_p50_ms']} vs {plain_res['tpot_p50_ms']} ms, tokens/s "
        f"{res['tokens_per_sec']} vs {plain_res['tokens_per_sec']}")
    gc.collect()
    torch.cuda.empty_cache()
    # serve() drew its weights from seed 0: the ones drawn here.
    params = gen.init_inference_params(cfg, 0, "cuda", quant="int8")
    log(f"int8 weights mixtral_8x7b: {_weight_bytes(params)} bytes | {smi}")
    gaps = (_first_divergence_gaps(params, plain, spec,
                                   _stream_context(prompts, plain), cfg=cfg)
            if plain != spec else [])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _check_near_ties("serve mixtral spec vs exact", gaps, 16)
    return runs


def mixtral_train_phase(smi):
    """mixtral_8x7b at full width and 2 layers (B2 S2048, bf16, remat, the
    einsum dispatch; 8 experts of d_ff 14336, top-2, capacity 320 a
    group of 1024) through ``TrainLoop`` with exact flash launch counts
    (the llama3_8b run's: S=2048 takes the two-pass backward); MFU on the
    active parameters. Then ``int8_fused`` for 4 steps: B7 44 a layer a
    step (the attention's 4 forwards, 4 remat re-forwards and 4 dx; each
    expert's gate and up forwards at M = 1280 and their re-forwards: 8 x
    4; w_down (k = 14336) and every expert dx are composed). Both runs
    must fit on the card: an out-of-memory error fails the phase."""
    import gc

    import torch

    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = tfm.mixtral_8x7b_config(n_layers=2, max_seq=2048, attn_impl="flash")
    L = cfg.n_layers
    flash = {"rope_rotate": 3 * L, "flash_fwd": 2 * L, "flash_bwd_prep": L,
             "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    runs = {"mixtral_8x7b": train_run("mixtral_8x7b", cfg, 2048, 2,
                                      MOE_TRAIN_STEPS, flash, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    runs["mixtral_8x7b.int8_fused"] = train_run(
        "mixtral_8x7b.int8_fused", cfg.replace(quant="int8_fused"), 2048, 2,
        INT8_STEPS, {**flash, "int8_quantize_rows": 44 * L,
                     "int8_matmul": 44 * L}, smi)
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def moe_phase(smi):
    """The MoE decoder: tiny_moe card vs CPU, mixtral_8x7b served (int8,
    8 layers) and trained (2 layers). Returns every run's record."""
    moe_tiny_check()
    return {**mixtral_serve_phase(smi), **mixtral_train_phase(smi)}


# -- MNIST, ResNet-50 and BERT ---------------------------------------------------

def _entry_train(label, fn, steps, smi):
    """``fn()`` (an entry point's ``train``) with the flash and B7 counts
    zeroed just before and read just after, every step timed on a host
    clock between synchronizations and its last of ``steps`` steps under
    ``torch.profiler``: (result, launches, profile of the last step as
    (wall ms, device ms, idle share, ms by kernel, top kernels), wall
    seconds, peak GB, the median ms of the steps but the first two and
    the profiled one)."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane import train as dtrain

    step_fn = dtrain.TrainLoop.step
    profiled, step_ms = [], []

    def step_profiling_the_last(loop, batch):
        if loop.state.step != steps - 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step_fn(loop, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return metrics
        metrics = {}

        def one(b):
            metrics.update(step_fn(loop, b))
            return metrics

        profiled.append(_step_profile(one, batch))
        return metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    dtrain.TrainLoop.step = step_profiling_the_last
    try:
        out = fn()
    finally:
        dtrain.TrainLoop.step = step_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    if out["final_step"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"{label}: {out}")
    steady = sorted(step_ms[2:])
    if len(steady) < 5:
        raise AssertionError(f"{label}: {len(steady)} steady steps timed, want >= 5")
    return (out, launches, profiled[0], wall,
            torch.cuda.max_memory_allocated() / 1e9, steady[len(steady) // 2])


def mnist_phase(smi):
    """The MNIST entry point at the reference's defaults (batch 100, 128
    hidden units, Adam 0.01, 200 steps, evaluation every 40 steps on the
    held-out synthetic stream): the held-out accuracy must clear chance
    (0.1) by far; step ms from the last report's window."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import mnist

    out, launches, prof, wall, peak, step_ms = _entry_train(
        "mnist", lambda: mnist.train(total_steps=200, batch_size=100), 200, smi)
    if not out["val_accuracy"] > 0.3 or any(launches.values()):
        raise AssertionError(f"mnist: {out}, launches {launches}")
    rec = dict(run="mnist", steps=200, val_accuracy=out["val_accuracy"],
               val_cross_entropy=out["val_cross_entropy"], accuracy=out["accuracy"],
               loss=out["loss"], step_ms=step_ms, wall_s=wall,
               profiled_step_wall_ms=prof[0], profiled_step_device_ms=prof[1],
               idle_share=prof[2], peak_gb=peak)
    log(f"mnist {json.dumps(rec)} | {smi}")
    return rec


RESNET_STEPS = 8
#: resnet_tiny (fp32, TF32 off) trained 2 steps on the card and on the CPU
#: from one CPU-drawn init: cuDNN's and the CPU's convolutions sum in other
#: orders, which the 2 SGD steps at lr 0.1 carry into the weights; limit
#: 1e-4 of each compared tensor's largest element.
RESNET_TINY_TOL_OF_MAX = 1e-4


def resnet_tiny_check():
    """resnet_tiny, card vs CPU: 2 stateful steps of the entry point's SGD
    from one init drawn on the CPU, then the train-mode logits on a new
    batch and the BN running statistics."""
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.models import resnet
    from kubeflow_controller_tpu_torch.optim import SGD

    model = resnet.resnet_tiny()
    init = model.init(0, "cpu")
    stream = resnet.synthetic_imagenet(8, 32, 10, seed=1, uint8=True)
    batches = [next(stream) for _ in range(3)]
    got = {}
    for dev in ("cuda", "cpu"):
        def init_fn(seed, device):
            return tuple({k: _to(v, device) for k, v in t.items()} for t in init)

        loop = TrainLoop(init_fn=init_fn, loss_fn=resnet.make_loss_fn(model),
                         optimizer=SGD(0.1, momentum=0.9, nesterov=True),
                         config=TrainLoopConfig(total_steps=2), stateful=True,
                         device=dev)
        loop.run(device_prefetch(iter(batches[:2]), dev))
        with torch.no_grad():
            logits, _ = model.apply(loop.state.params, loop.state.model_state,
                                    torch.from_numpy(batches[2]["image"]).to(dev))
        got[dev] = [logits.cpu()] + [t.cpu() for t in tree_leaves(loop.state.model_state)]
    worst = 0.0
    for a, b in zip(got["cuda"], got["cpu"]):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, err)
    if worst > RESNET_TINY_TOL_OF_MAX:
        raise AssertionError(f"resnet[tiny]: card vs CPU {worst} of max past "
                             f"{RESNET_TINY_TOL_OF_MAX}")
    log(f"resnet[tiny] fp32: logits and BN statistics after 2 steps, card vs CPU "
        f"within {worst} of each tensor's max (limit {RESNET_TINY_TOL_OF_MAX})")


def _to(tree, device):
    """A copy of a tensor tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def resnet50_phase(smi):
    """The ResNet-50 entry point at full depth and width: batch 128 of
    224² uint8 images, bf16, 8 steps (SGD, Nesterov momentum), into a
    model dir whose final checkpoint holds the BN statistics: the loss
    must be finite, no flash or int8 kernel may launch, and the running
    statistics must have moved from their init (mean 0, var 1). Logs
    images/s per card, step ms, peak memory, and the last step's idle
    share and device time by kernel. Then resnet_tiny card vs CPU."""
    import shutil

    from kubeflow_controller_tpu_torch.dataplane import train as dtrain
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import resnet

    model_dir = os.path.join(OUT_DIR, "resnet50_ckpt")
    shutil.rmtree(model_dir, ignore_errors=True)
    out, launches, prof, wall, peak, step_ms = _entry_train(
        "resnet50", lambda: resnet.train(total_steps=RESNET_STEPS, per_chip_batch=128,
                                         model_dir=model_dir),
        RESNET_STEPS, smi)
    stem = dtrain.CheckpointReader(model_dir, RESNET_STEPS).index["model_state"]["stem_norm"]
    moved = (float(stem["mean"].abs().max()), float((stem["var"] - 1).abs().max()))
    shutil.rmtree(model_dir, ignore_errors=True)
    if any(launches.values()) or not min(moved) > 0:
        raise AssertionError(f"resnet50: launches {launches}, stem BN moved {moved}")
    rec = dict(run="resnet50", steps=RESNET_STEPS, loss=out["loss"],
               images_per_sec_per_chip=128e3 / step_ms, step_ms=step_ms,
               entry_images_per_sec_per_chip=out["images_per_sec_per_chip"],
               wall_s=wall, peak_gb=peak,
               profiled_step_wall_ms=prof[0], profiled_step_device_ms=prof[1],
               idle_share=prof[2], device_ms_by_kernel=prof[3], top_kernels=prof[4],
               stem_bn_moved=dict(mean_max_abs=moved[0], var_max_abs_from_1=moved[1]))
    log(f"resnet50 {json.dumps(rec)} | {smi}")
    resnet_tiny_check()
    return rec


BERT_STEPS = 8
#: BERT, card vs CPU, on one CPU-drawn init and a batch with padded rows:
#: fp32 (the dense attention on both, TF32 off) differs in summation order
#: only; bf16 at S=256, head_dim 64 runs B1 on the card and the dense path
#: on the CPU, which round attention at different points (as
#: LOGITS_REL_L2_TOL's kernel vs gather paths do).
BERT_TINY_FP32_TOL_OF_MAX = 1e-4
BERT_TINY_BF16_REL_L2_TOL = LOGITS_REL_L2_TOL


def _padded_mlm(cfg, batch, seq, seed=0, synthetic=None):
    """The synthetic MLM stream (``synthetic``, by default
    ``bert.synthetic_mlm_batch``) with the tails of half of each batch's
    rows padded (attention mask 0 from a drawn length on, no position
    there scored)."""
    import numpy as np

    from kubeflow_controller_tpu_torch.models import bert

    rng = np.random.default_rng(seed + 100)
    for b in (synthetic or bert.synthetic_mlm_batch)(cfg, batch, seq, seed=seed):
        for row in range(0, batch, 2):
            b["attention_mask"][row, int(rng.integers(seq // 2, seq - 8)):] = 0
        b["mlm_mask"] = b["mlm_mask"] * b["attention_mask"]
        yield b


def bert_tiny_check():
    """``encode`` card vs CPU on padded rows: fp32 tiny config, and bf16
    at S=256 and head_dim 64 (B1 on the card)."""
    import torch

    from kubeflow_controller_tpu_torch.models import bert

    for label, cfg, seq in (
            ("fp32", bert.bert_tiny_config(), 64),
            ("bf16.flash", bert.bert_tiny_config(d_model=128, n_heads=2, max_seq=256,
                                                 vocab_size=1024,
                                                 dtype=torch.bfloat16), 256)):
        params = bert.init_params(cfg, seed=0, device="cpu")
        batch = next(_padded_mlm(cfg, 4, seq, seed=2))
        hid = {}
        for dev in ("cuda", "cpu"):
            from kubeflow_controller_tpu_torch.ops import flash_attention as fa
            fa.reset_launches()
            with torch.no_grad():
                hid[dev] = bert.encode(
                    cfg, _to(params, dev), torch.from_numpy(batch["tokens"]).to(dev),
                    torch.from_numpy(batch["attention_mask"]).to(dev)).float().cpu()
            if dev == "cuda":
                b1 = fa.LAUNCHES["flash_fwd"]
        a, b = hid["cuda"], hid["cpu"]
        if label == "fp32":
            err = float((a - b).abs().max()) / float(b.abs().max())
            ok, lim = err <= BERT_TINY_FP32_TOL_OF_MAX and b1 == 0, BERT_TINY_FP32_TOL_OF_MAX
        else:
            err = float((a - b).norm() / b.norm())
            ok, lim = err <= BERT_TINY_BF16_REL_L2_TOL and b1 == cfg.n_layers, \
                BERT_TINY_BF16_REL_L2_TOL
        if not ok:
            raise AssertionError(f"bert[tiny {label}]: card vs CPU {err} (limit {lim}), "
                                 f"B1 launches {b1}")
        log(f"bert[tiny {label}] encode card vs CPU: {err} (limit {lim}), B1 "
            f"launches on the card {b1}")


def bert_phase(smi):
    """The BERT entry point with BERT-base at S=512, batch 8, bf16,
    ``attn="auto"``, 8 steps (the median of steps 2-6 reported), on
    batches whose even rows pad their tails (the entry point's synthetic
    stream, swapped for the padded one for the call): ``auto`` must take
    the flash kernels with segment ids, not causal; per step B1 twice a
    layer (the forward and the remat recompute), B2 with its delta
    prepass and dq postprocess once a layer, no rope prepass (BERT has
    no rotary embedding) and no two-pass kernel, exactly. Logs tokens/s,
    step ms, peak memory and the last step's device time by kernel; then
    ``encode`` card vs CPU."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import bert as entry
    from kubeflow_controller_tpu_torch.models import bert

    cfg = bert.bert_base_config(max_seq=512, attn_impl="auto")
    L = cfg.n_layers
    synthetic = bert.synthetic_mlm_batch
    bert.synthetic_mlm_batch = (
        lambda cfg, batch, seq, seed=0: _padded_mlm(cfg, batch, seq, seed, synthetic))
    try:
        out, launches, prof, wall, peak, step_ms = _entry_train(
            "bert", lambda: entry.train(total_steps=BERT_STEPS, per_data_shard_batch=8,
                                        seq_len=512, cfg=cfg),
            BERT_STEPS, smi)
    finally:
        bert.synthetic_mlm_batch = synthetic
    want = {"rope_rotate": 0, "flash_fwd": 2 * L * BERT_STEPS,
            "flash_bwd_prep": L * BERT_STEPS, "flash_bwd_fused": L * BERT_STEPS,
            "flash_bwd_post": L * BERT_STEPS, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
            "int8_quantize_rows": 0, "int8_matmul": 0, "int8_quantize_rows_scaled": 0,
            "int8_matmul_f32": 0}
    if launches != want:
        raise AssertionError(f"bert: launches {launches} != {want}")
    rec = dict(run="bert_base.S512.B8", steps=BERT_STEPS, loss=out["loss"],
               tokens_per_sec=8 * 512e3 / step_ms, step_ms=step_ms,
               entry_tokens_per_sec=out["tokens_per_sec"], wall_s=wall, peak_gb=peak,
               profiled_step_wall_ms=prof[0], profiled_step_device_ms=prof[1],
               idle_share=prof[2], device_ms_by_kernel=prof[3], top_kernels=prof[4],
               launches=launches)
    log(f"bert {json.dumps(rec)} | {smi}")
    bert_tiny_check()
    return rec


def models_phase(smi):
    """MNIST, ResNet-50 and BERT through their entry points."""
    return {"mnist": mnist_phase(smi), "resnet50": resnet50_phase(smi),
            "bert": bert_phase(smi)}


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


# -- multi-process training --------------------------------------------------------

# A case's ``loss_tol`` replaces DIST_LOSS_REL_TOL where that limit, set
# on the flagship, does not hold the model's own rounding; each is about
# twice the worst reading on an H100 80GB HBM3 at 700 W, the rule
# TRAIN_LOSS_REL_TOL was set by, and the yardstick's loss difference (the
# plain attention's one-process run against the flash run) is recorded
# beside it. A routed (MoE) layout: the top-k routing is discrete, and
# an input one bf16 rounding apart (a tp partial sum, an attention path)
# may send a near-tied token to another expert, which moves mixtral's
# loss by ~1e-4 of itself a token: its yardstick read 1.31e-4 and
# 1.46e-4, mixtral_8x7b (1 layer) at tp=2 2.94e-4 (twice), at ep=2 and
# sp=2 below 2e-7. BERT-base at tp=2: 8.28e-5 and 1.045e-4 (its
# yardstick 6.18e-5: the fused backward's dq sums through atomics in an
# order that varies run to run, DQ_RUN_TO_RUN).
ROUTED_LOSS_REL_TOL = 6e-4
BERT_TP_LOSS_REL_TOL = 2.1e-4

# The gang's layouts: each a two-rank lm.train (global batch 16 at S1024
# for the flagship at full width, 2 at S2048 for llama3_8b at 2 layers)
# held against a one-process run of the same batches, init and steps on
# the same card. The flagship's dp, tp and sp layouts run it at 4 of its
# 16 layers, its fsdp layouts at 8: on one card over gloo every
# collective goes through host memory (an int8 tp=2 step of all 16 layers
# sums ~9.6 GB of fp32 partials: 12.9 s), and the whole script must stay
# within its time. At 4 layers fsdp=2's steps' peak (4.304 GB a rank)
# passes the plan's 3.892 GB plus 3 leaves: buffers that do not shrink
# with the depth.
# ``needs``: the collectives the layout runs on its tensors beyond
# all_reduce (probed first on the gang's backend).
DIST_CASES = [
    # llama3_70b at full width cut to one of its 80 layers (2.957 B
    # parameters: embed and head 1.051 B each, the layer 0.856 B; 47.3 GB
    # of fp32 weights, gradients and moments whole, 23.7 GB a rank at
    # fsdp=2): the GQA group of 8 on the train path (B1, B2 at S=1024),
    # and a checkpoint of ~35.5 GB that no rank gathers (C11): each
    # rank's save, and its restore of the checkpoint at fsdp=2 (bit for
    # bit), held to its steps' peak plus SAVE_PEAK_LEAF_COPIES copies of
    # the largest leaf. Its one-process runs (the oracle alone holds 47.3
    # GB) wait until the gang has gone (``after_gang``: _after_gang). It
    # runs first, in the gang's fresh processes, with the host's memory
    # and the card's free of the other layouts' caches.
    dict(label="llama3_70b_1l.fsdp2", config="llama3_70b_1l", mesh=dict(dp=1, fsdp=2),
         batch=1, seq=1024, steps=2, checkpoint=True, after_gang=True,
         needs=("all_gather_into_tensor", "reduce_scatter_tensor"), change_cap=0.0428),
    dict(label="flagship_4l.dp2", config="flagship_4l", mesh=dict(dp=2), batch=8, seq=1024,
         steps=3, needs=(), change_cap=0.114),
    dict(label="flagship_8l.fsdp2", config="flagship_8l", mesh=dict(dp=1, fsdp=2), batch=8,
         seq=1024, steps=3, needs=("all_gather_into_tensor", "reduce_scatter_tensor"),
         checkpoint=True, change_cap=0.114),
    dict(label="flagship_4l.tp2", config="flagship_4l", mesh=dict(dp=1, tp=2), batch=16,
         seq=1024, steps=3, needs=("all_gather_into_tensor", "all_gather", "all_reduce_max"),
         change_cap=0.114),
    dict(label="flagship_8l.int8_fused.fsdp2", config="flagship_8l", quant="int8_fused",
         mesh=dict(dp=1, fsdp=2), batch=8, seq=1024, steps=2,
         needs=("all_gather_into_tensor", "reduce_scatter_tensor"), change_cap=0.3654),
    dict(label="llama3_8b.fsdp2", config="llama3_8b_2l", attn="flash",
         mesh=dict(dp=1, fsdp=2), batch=1, seq=2048, steps=2,
         needs=("all_gather_into_tensor", "reduce_scatter_tensor"), change_cap=0.0666),
    # Sequence parallelism: each rank holds half of every row. Ring
    # attention (plain PyTorch block updates, no flash kernel; the K/V
    # blocks go around by send and receive), held against the one-process
    # flash run; and the gather path (q/k/v gathered over sp: B1 and the
    # two-pass backward B3/B4 at S=2048 on every rank).
    dict(label="flagship_4l.sp2.ring", config="flagship_4l", attn="ring", one_process_attn="auto",
         mesh=dict(dp=1, sp=2), batch=4, seq=2048, steps=3, needs=("send_recv",),
         change_cap=0.123),
    dict(label="flagship_4l.sp2", config="flagship_4l", mesh=dict(dp=1, sp=2), batch=4, seq=2048,
         steps=3, needs=("all_gather_into_tensor", "reduce_scatter_tensor"),
         change_cap=0.123),
    # Pipeline parallelism: 8 layers a stage, 4 microbatches, through
    # TrainLoop with next_token_loss(pp_microbatches=4) on parameters
    # placed by param_specs(cfg, pp=True) (the JAX package's train-step
    # entry: no lm.train flag). It keeps the flagship's 16 layers: at 8
    # its steps' peak (8.364 GB a rank) passes the plan's 7.919 plus 3
    # leaves, since a tick's buffers do not shrink with the stage's
    # layers, and its steps are short (~0.9 s).
    dict(label="flagship.pp2", config="flagship", mesh=dict(pp=2, dp=1), batch=16,
         seq=1024, steps=3, pp_microbatches=4, needs=("send_recv",), change_cap=0.114),
    # The long context the sp axis exists for: llama3_8b at 2 layers,
    # S=4096, one row, ring attention, against the one-process flash run.
    dict(label="llama3_8b_2l.sp2.ring", config="llama3_8b_2l", attn="ring",
         one_process_attn="flash", mesh=dict(dp=1, sp=2), batch=1, seq=4096, steps=2,
         needs=("send_recv",), change_cap=0.0658),
    # Expert parallelism and MoE over tp and sp: mixtral_8x7b at full
    # width, cut to one layer (1.71 B parameters, 27 GB of fp32 weights,
    # gradients and moments whole: two sp ranks hold 55 GB of one card).
    # At ep=2 each rank holds 4 experts and the dispatched tokens go to
    # them by all-to-all; at tp=2 each expert's SwiGLU is column- and
    # row-parallel; at sp=2 the routed FFN runs on the sequence gathered
    # over sp (q/k/v gathered too: B1 and the two-pass B3/B4 at S=2048).
    dict(label="mixtral_8x7b_1l.ep2", config="mixtral_8x7b_1l", loss_tol=ROUTED_LOSS_REL_TOL,
         mesh=dict(dp=1, ep=2), batch=2, seq=1024, steps=2, needs=("all_to_all",),
         change_cap=0.2432),
    dict(label="mixtral_8x7b_1l.tp2", config="mixtral_8x7b_1l", loss_tol=ROUTED_LOSS_REL_TOL,
         mesh=dict(dp=1, tp=2), batch=2, seq=1024, steps=2,
         needs=("all_gather_into_tensor", "all_gather", "all_reduce_max"),
         change_cap=0.2335),
    dict(label="mixtral_8x7b_1l.sp2", config="mixtral_8x7b_1l", loss_tol=ROUTED_LOSS_REL_TOL,
         mesh=dict(dp=1, sp=2), batch=1, seq=2048, steps=2,
         needs=("all_gather_into_tensor", "reduce_scatter_tensor"), change_cap=0.2836),
    # Int8 projections over tp: the row-parallel projections' scales span
    # the tp-split contraction (MAX over tp) and their fp32 partials are
    # summed over tp; under int8_fused they take B7's split entries (the
    # row scales from the caller, fp32 out), as do q/k/v's and gate/up's
    # dx.
    dict(label="flagship_4l.int8.tp2", config="flagship_4l", quant="int8", mesh=dict(dp=1, tp=2),
         batch=16, seq=1024, steps=2, needs=("all_gather_into_tensor", "all_gather",
                                             "all_reduce_max"), change_cap=0.346),
    dict(label="flagship_4l.int8_fused.tp2", config="flagship_4l", quant="int8_fused",
         mesh=dict(dp=1, tp=2), batch=16, seq=1024, steps=2,
         needs=("all_gather_into_tensor", "all_gather", "all_reduce_max"), change_cap=0.346),
    # 8-bit AdamW on fsdp chunks: each leaf's row statistics the whole
    # leaf's; checkpointed, and restored by one process with its
    # quantized moments.
    dict(label="flagship_8l.opt8bit.fsdp2", config="flagship_8l", quant="int8_fused", opt8bit=True,
         mesh=dict(dp=1, fsdp=2), batch=8, seq=1024, steps=2, checkpoint=True,
         needs=("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce_max"),
         change_cap=0.3536),
    # BERT over tp: the vocabulary-split embedding and MLM head, the
    # column-parallel mlm_dense gathered over tp before its norm.
    dict(label="bert_base.tp2", model="bert", config="bert_base", loss_tol=BERT_TP_LOSS_REL_TOL,
         mesh=dict(dp=1, tp=2),
         batch=8, seq=512, steps=3, needs=("all_gather_into_tensor", "all_gather",
                                           "all_reduce_max"), change_cap=0.2328),
]
# A layout against the one-process run: the two differ in each rank's
# rows (bf16 weight gradients are rounded per rank before the ranks'
# halves meet in fp32) and in the shapes cuBLAS sees. The loss takes the
# flagship's flash-vs-plain limit, TRAIN_LOSS_REL_TOL. The parameters
# after the last step are held by their change from the init, relative
# L2 against the one-process change, over the whole model and for the
# worst leaf. AdamW's step is about lr times the gradient's sign, so an
# element whose gradient is rounding noise moves either way in either
# run, and a fixed limit on the change would measure the optimizer, not
# the layout: the yardstick is the same one-process run with the plain
# attention instead of the flash kernels (the pair the flagship's
# flash-vs-plain gradient limits were set on), read in the same call,
# and a layout may differ from the one-process run by at most
# DIST_VS_YARDSTICK times as much, whole and worst leaf. So that this
# limit cannot grow with the flash kernels' own error, the whole
# model's change is also capped by the case's ``change_cap``: twice its
# yardstick as read on an H100 80GB HBM3 at 700 W (flagship 0.0570 at
# 16 layers, whose caps its 4- and 8-layer dp, fsdp, tp and sp layouts keep,
# int8_fused 0.1827, llama3_8b 0.0333; the flagship at B4 S2048 0.0615,
# llama3_8b at S4096 0.0329; mixtral_8x7b at 1 layer: 0.1216 at ep=2,
# 0.1167 at tp=2 (B2 S1024), 0.1418 at sp=2 (B1 S2048); the flagship's 8
# layers with int8 at tp=2 0.1730, with 8-bit AdamW at fsdp=2 0.1768,
# caps its 4-layer layouts keep;
# BERT-base 0.1164; llama3_70b at 1 layer, fsdp=2, B2 S1024: 0.0214).
# The ring cases are held against the
# one-process flash run (``one_process_attn``): without a mesh the ring
# is the plain attention, which is the yardstick itself.
DIST_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL
DIST_VS_YARDSTICK = 2.0
# Each rank's peak memory against ``transformer_memory_plan``: the plan
# counts the stored chunks, the gradients and the moments sharded, but
# not what a gather or a reduction of one leaf holds for a moment (the
# whole leaf or its whole gradient, its contiguous copy, its bf16
# cast). A rank may exceed the plan by DIST_PEAK_LEAF_COPIES copies of
# the largest leaf in fp32; a step that held every parameter and every
# gradient whole would exceed that. This holds the steps' peak. A save
# gathers nothing (each rank writes its chunks), so its own peak (reset
# just before it) may exceed the steps' by SAVE_PEAK_LEAF_COPIES copies
# of the largest leaf at most, and so may the gang's restore of its
# checkpoint (``after_gang`` layouts); before C11 was fixed every rank
# gathered the whole parameters and moments to save.
DIST_PEAK_LEAF_COPIES = 3
SAVE_PEAK_LEAF_COPIES = 1
DIST_TIMEOUT_S = 900


#: The memory gate's cases (``parallel/aot_check.py``, traced on fake
#: CUDA tensors at S=8192): llama3_8b at the JAX package's mesh of two
#: v5p-64 slices (``tests/test_llama_fits.py``), and llama3_70b at
#: fsdp=16 x tp=8, tp inside an 8-card NVLink domain.
AOT_CASES = (("llama3_8b", {"dp": 2, "fsdp": 16, "tp": 4}, 32),
             ("llama3_70b", {"fsdp": 16, "tp": 8}, 16))
AOT_SEQ = 8192
CARD_BYTES = 80e9


def _aot_records():
    """The memory gate (``aot_trace_train_step(device="cuda")``) on each
    of :data:`AOT_CASES` in this process, each record beside the plan
    (``transformer_memory_plan``) and the card's 80 GB; raises if the
    traces allocated anything on the card or launched anything."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import model_config
    from kubeflow_controller_tpu_torch.parallel import aot_check, memory

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    out = {}
    for name, axes, batch in AOT_CASES:
        r = aot_check.aot_trace_train_step(name, axes, batch, seq=AOT_SEQ, device="cuda")
        plan = memory.transformer_memory_plan(model_config(name), axes, batch, AOT_SEQ)
        out[name] = dict(r, per_rank_bytes=r["argument_bytes_per_device"]
                         + r["temp_bytes_per_device"], plan_bytes=plan.total,
                         plan_argument_bytes=plan.params + plan.opt_state,
                         plan_rows=dict(plan.rows()), card_bytes=CARD_BYTES)
    torch.cuda.synchronize()
    launches = _launches()
    if any(launches.values()) or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"aot: launches {launches}, allocated "
                             f"{torch.cuda.memory_allocated() - before} B on the card")
    return out


def _aot_worker(path) -> int:
    """:func:`_aot_records` in a process of its own, written to ``path``."""
    sys.path.insert(0, ROOT)
    out = _aot_records()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def aot_start():
    """Start the memory gate's traces in a process of their own (they use
    the host's cores, not the card), so that they run beside the phases
    before :func:`aot_phase` reads them."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "aot.json")
    if os.path.exists(path):
        os.remove(path)
    log_file = open(os.path.join(OUT_DIR, "aot.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; raise SystemExit(c._aot_worker({path!r}))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=log_file,
        stderr=subprocess.STDOUT)
    log_file.close()
    return proc, path


def aot_phase(smi, started=None):
    """The memory gate: one AdamW train step of each :data:`AOT_CASES`
    traced as rank 0 of a fake process group on fake CUDA tensors
    (``started``: the traces :func:`aot_start` began, waited for here;
    else traced now), its per-rank bytes beside the analytic plan and
    the card's 80 GB, and the trace's seconds. The rank's parameters and
    moments must be the plan's to the byte and the whole under the
    card's memory; the traces allocate nothing on the card and launch
    nothing."""
    if started is None:
        out = _aot_records()
    else:
        proc, path = started
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            with open(os.path.join(OUT_DIR, "aot.log")) as f:
                log(f"aot rc={rc}:\n{f.read()[-6000:]}")
            raise AssertionError(f"aot: the traces' process failed (rc {rc})")
        with open(path) as f:
            out = json.load(f)
    for (name, axes, batch), rec in zip(AOT_CASES, out.values()):
        rec["fits"] = rec["per_rank_bytes"] < CARD_BYTES
        log(f"aot[{name}] {json.dumps(rec)} | {smi}")
        log(f"aot[{name}] mesh {axes} B{batch} S{AOT_SEQ}: "
            f"{rec['per_rank_bytes'] / 1e9:.3f} GB a rank traced (arguments "
            f"{rec['argument_bytes_per_device'] / 1e9:.3f}, temp "
            f"{rec['temp_bytes_per_device'] / 1e9:.3f}) vs plan "
            f"{rec['plan_bytes'] / 1e9:.3f} GB vs the card's {CARD_BYTES / 1e9:.0f} GB; "
            f"trace {rec['trace_s']:.2f} s | {smi}")
        if (rec["argument_bytes_per_device"] != rec["plan_argument_bytes"]
                or not 2 ** 30 < rec["per_rank_bytes"] < CARD_BYTES):
            raise AssertionError(f"aot[{name}]: {rec}")
    return out


def _send_recv_probe(device):
    """The ring shift over a two-rank sp mesh on a tensor of ``device``:
    each rank must receive the other's. Returns the transport it took."""
    import torch

    from kubeflow_controller_tpu_torch.parallel.collectives import p2p_transport, ring_shift
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    mesh = make_mesh(MeshConfig(dp=1, sp=2), device_type=device.type)
    x = torch.full((4,), float(mesh.rank), device=device)
    with use_mesh(mesh):
        got = ring_shift(x, "sp", -1)
    if not torch.equal(got, torch.full_like(x, float(1 - mesh.rank))):
        raise AssertionError(f"received {got.tolist()}")
    return p2p_transport(x, mesh.group("sp"))


def _all_to_all_probe(device):
    """The expert exchange over a two-rank ep mesh on a bf16 tensor of
    ``device`` (``collectives.all_to_all``): each rank must receive its
    expert's slots of both ranks' groups, and the inverse must give its
    own back. Returns the transport it took."""
    import torch

    from kubeflow_controller_tpu_torch.parallel.collectives import all_to_all, p2p_transport
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    mesh = make_mesh(MeshConfig(dp=1, ep=2), device_type=device.type)
    r = mesh.coords["ep"]

    def slots(rank):                      # [E=2, G=1, cap=1, D=3] of rank's groups
        return (torch.arange(6, device=device, dtype=torch.float32).reshape(2, 1, 1, 3)
                + 10 * rank).to(torch.bfloat16)

    x = slots(r)
    with use_mesh(mesh):
        got = all_to_all(x)
        back = all_to_all(got, inverse=True)
    want = torch.stack([slots(j)[r] for j in range(2)], 1)    # [1, 2, 1, 3]
    if not (torch.equal(got, want) and torch.equal(back, x)):
        raise AssertionError(f"received {got.tolist()}, back {back.tolist()}")
    return p2p_transport(x, mesh.group("ep"))


def _dist_probe(device):
    """Which collectives the gang's backend runs on tensors of
    ``device``: {name: True or the error's text}; ``send_recv_transport``
    and ``all_to_all_transport`` name the routes the ring shift and the
    expert exchange took."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device=device)
    tests = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device=device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=device), x.clone()),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, fn in tests.items():
        try:
            fn()
            torch.cuda.synchronize(device)
            out[name] = True
        except Exception as e:  # a probe: its finding is the answer
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    for name, probe in (("send_recv", _send_recv_probe), ("all_to_all", _all_to_all_probe)):
        try:
            out[f"{name}_transport"] = probe(device)
            out[name] = True
        except Exception as e:  # a probe: its finding is the answer
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def _dist_expected(case, n_layers):
    """The flash and B7 launches a rank makes a step: the one-process
    counts (each rank runs every layer on its rows or heads, or on the
    sequence gathered over sp); none on the ring path (its block update
    is plain PyTorch); over pp, each rank's L/P layers on each of the
    M + P - 1 ticks of the schedule. BERT: no rope prepass. Int8_fused
    over tp: B7's split entries take the row-parallel forwards (o, down)
    and the column-parallel dx (q, k, v, gate, up), 9 a layer, the
    regular ones the other 12 (``fusable`` judged on the logical
    shapes, the same projections as in one process)."""
    if case.get("model") == "bert":
        return {"flash_fwd": 2 * n_layers, "flash_bwd_prep": n_layers,
                "flash_bwd_fused": n_layers, "flash_bwd_post": n_layers}
    if case.get("attn") == "ring":
        return {}
    if case.get("pp_microbatches"):
        n_layers = (n_layers // case["mesh"]["pp"]) * (
            case["pp_microbatches"] + case["mesh"]["pp"] - 1)
    flash = {"rope_rotate": 3 * n_layers, "flash_fwd": 2 * n_layers,
             "flash_bwd_prep": n_layers}
    if case["seq"] > 1024:
        flash.update(flash_bwd_dkdv=n_layers, flash_bwd_dq=n_layers)
    else:
        flash.update(flash_bwd_fused=n_layers, flash_bwd_post=n_layers)
    if case.get("quant") == "int8_fused" and case["mesh"].get("tp", 1) > 1:
        flash.update(int8_quantize_rows=12 * n_layers, int8_matmul=12 * n_layers,
                     int8_quantize_rows_scaled=9 * n_layers, int8_matmul_f32=9 * n_layers)
    elif case.get("quant") == "int8_fused":
        flash.update(int8_quantize_rows=21 * n_layers, int8_matmul=21 * n_layers)
    return flash


#: Rank 0's one-process run, its yardstick and the init of a layout
#: whose next layouts run the same (:func:`_one_process_key`), kept on
#: the host until the next one takes them: the flagship at dp=2, fsdp=2,
#: tp=2 and pp=2 (16 rows of S=1024, 3 steps) and at sp=2 ring and
#: gathered (4 rows of S=2048).
_ONE_PROCESS = {}


def _one_process_key(case):
    """What a layout's one-process runs depend on: the model, its
    configuration, quantization and one-process attention, the global
    batch, the sequence, the steps and the optimizer."""
    _, dp, fsdp, ep, _, _ = _dist_mesh_config(case).resolve(2)
    return (case.get("model"), case["config"], case.get("quant", ""),
            case.get("one_process_attn", case.get("attn", "auto")),
            case["batch"] * dp * fsdp * ep, case["seq"], case["steps"],
            case.get("opt8bit", False))


def _change_rel(got, want, init):
    """Relative L2 of ``got``'s change from ``init`` against ``want``'s,
    over the whole tree and for each leaf."""
    num = [float((g - w).float().norm()) ** 2 for g, w in zip(got, want)]
    den = [float((w - i).float().norm()) ** 2 for w, i in zip(want, init)]
    whole = math.sqrt(sum(num) / sum(den))
    return whole, [math.sqrt(n / max(d, 1e-60)) for n, d in zip(num, den)]


def _model_pieces(case, cfg, global_batch, pp_microbatches=0):
    """A case's ``(init_fn, loss_fn, param specs, optimizer, stream of
    global batches)`` as its entry point builds them: ``lm.train``'s
    (the pipelined loss and ``param_specs(cfg, pp=True)`` with
    ``pp_microbatches``), or ``bert.train``'s."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import synthetic_lm
    from kubeflow_controller_tpu_torch.models import bert
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.optim import (
        AdamW, make_optimizer, warmup_cosine_decay_schedule,
    )

    steps = case["steps"]
    if case.get("model") == "bert":
        return (bert.make_init_fn(cfg), bert.make_loss_fn(cfg), bert.param_specs(cfg),
                AdamW(warmup_cosine_decay_schedule(0.0, 1e-4, min(100, steps // 10 + 1),
                                                   steps), weight_decay=0.01),
                bert.synthetic_mlm_batch(cfg, global_batch, case["seq"]))
    return (tfm.make_init_fn(cfg), tfm.make_loss_fn(cfg, pp_microbatches=pp_microbatches),
            tfm.param_specs(cfg, pp=pp_microbatches > 0),
            make_optimizer(3e-4, steps, case.get("opt8bit", False)),
            synthetic_lm(cfg.vocab_size, global_batch, case["seq"]))


def _loop_run(case, cfg, device, mesh, pp_microbatches=0, model_dir=""):
    """A case's run through ``TrainLoop`` with the pieces its entry point
    builds (:func:`_model_pieces`), on ``mesh``, each rank fed its rows
    of the gang's global batch: the one-process run (a mesh of this rank
    alone), or a pipelined case (``next_token_loss(pp_microbatches=M)``
    on parameters placed by ``param_specs(cfg, pp=True)``, as the JAX
    package's pipelined train steps are called: no ``lm.train`` flag).
    With ``model_dir``: a loop that would resume from it, not run."""
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )

    _, dp, fsdp, ep, _, _ = _dist_mesh_config(case).resolve(2)
    global_batch = case["batch"] * dp * fsdp * ep
    init_fn, loss_fn, specs, tx, stream = _model_pieces(case, cfg, global_batch,
                                                        pp_microbatches)
    loop = TrainLoop(
        init_fn=init_fn, loss_fn=loss_fn, optimizer=tx,
        config=TrainLoopConfig(total_steps=case["steps"], log_every=1),
        device=device, mesh=mesh, param_shardings=specs, model_dir=model_dir)
    if model_dir:
        return [], loop
    recs = []
    loop.run(device_prefetch(stream, device, rows=loop.local_rows(global_batch)),
             on_metrics=recs.append)
    return [m.loss for m in recs], loop


def _same_tensors(a, b) -> bool:
    """Whether two trees (dicts, lists) hold equal tensors at the same
    places (other values are not compared)."""
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b.to(a.device))
    return True


def _bert_memory_plan(cfg, axes, global_batch, seq, shapes, specs):
    """BERT's per-rank plan by the decoder plan's terms
    (``transformer_memory_plan``; the JAX package has none for BERT): the
    fp32 parameters, gradients and two moments as ``specs`` shard the
    leaves of ``shapes``; a layer's input a layer under remat and one
    layer's intermediates twice; the MLM head's fp32 logits four times
    (the logits, their exponentials, the log-probabilities and the
    gradient), this rank's vocab shard of them."""
    from kubeflow_controller_tpu_torch.parallel.memory import MemoryPlan, sharded_leaf_bytes

    pbytes = sum(sharded_leaf_bytes(sh, 4, sp, axes) for sh, sp in zip(shapes, specs))
    b = math.ceil(global_batch / (axes.get("dp", 1) * axes.get("fsdp", 1)))
    tp, act = axes.get("tp", 1), 2
    checkpoints = cfg.n_layers * b * seq * cfg.d_model * act
    in_layer = b * seq * (math.ceil(cfg.d_model / tp) * 4 + math.ceil(cfg.d_ff / tp) * 2
                          + cfg.d_model * 2) * act * 2
    logits = b * seq * math.ceil(cfg.vocab_size / tp) * 4 * 4
    return MemoryPlan(params=pbytes, grads=pbytes, opt_state=2 * pbytes,
                      activations=checkpoints + in_layer, logits=logits,
                      mesh_axes=dict(axes), global_batch=global_batch, seq=seq)


def _shape_leaves(tree):
    """The shapes of a tree of shapes, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shape_leaves(tree[k])]
    return [tuple(tree)]


def _leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _dist_mesh_config(case):
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig

    return MeshConfig(**case["mesh"])


def _dist_case(ctx, case, device):
    """One layout on this rank: its entry point (``lm.train``, or
    ``bert.train`` for ``model="bert"``) with the counts zeroed just
    before and read just after, the gathered parameters, and on rank 0
    the one-process run and the comparison (and, with ``checkpoint``, a
    one-process restore of the layout's checkpoint: parameters and
    optimizer state bit for bit)."""
    import gc
    import shutil

    import torch
    import torch.distributed as dist

    from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
    from kubeflow_controller_tpu_torch.dataplane import train as dtrain
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import bert as bert_entry
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.models import bert
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.parallel import memory, sharding
    from kubeflow_controller_tpu_torch.parallel.mesh import make_mesh, mesh_for_context

    kept, recs, step_peaks, saves = [], [], [], []
    real_run, real_save = dtrain.TrainLoop.run, dtrain.TrainLoop.save

    def keeping(loop, data, on_metrics=None, eval_iter=None):
        kept.append(loop)

        def both(m):
            recs.append(m)
            if on_metrics:
                on_metrics(m)
        return real_run(loop, data, on_metrics=both, eval_iter=eval_iter)

    def saving(loop, wait=True):
        # The steps' peak, then the save's own (seconds and peak memory,
        # reset just before it).
        step_peaks.append(torch.cuda.max_memory_allocated(device))
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        out = real_save(loop, wait=wait)
        torch.cuda.synchronize(device)
        saves.append((time.perf_counter() - t, torch.cuda.max_memory_allocated(device)))
        return out

    is_bert = case.get("model") == "bert"
    mdir = (os.path.join(OUT_DIR, "dist_ckpt", case["label"]) if case.get("checkpoint")
            else "")
    # The loops of the cases before (rank 0's one-process runs too) hold
    # reference cycles: collect them, so that this case's peak is its own.
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    if case.get("after_gang"):
        # The pinned host buffers gloo staged the cases before through
        # (cached, rounded up to powers of two) go back to the machine.
        torch._C._host_emptyCache()
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.memory_allocated(device)
    _reset_launches()
    dtrain.TrainLoop.run, dtrain.TrainLoop.save = keeping, saving
    t0 = time.perf_counter()
    if is_bert:
        cfg = bert.bert_base_config(max_seq=max(case["seq"], 128),
                                    attn_impl=case.get("attn", "auto"))
    else:
        cfg = lm.model_config(case["config"], max_seq=max(case["seq"], 128),
                              attn_impl=case.get("attn", "auto"),
                              quant=case.get("quant", ""))
    try:
        if case.get("pp_microbatches"):
            _, pp_loop = _loop_run(case, cfg, device, mesh_for_context(
                ctx, _dist_mesh_config(case), device_type="cuda"), case["pp_microbatches"])
            out = {"final_step": pp_loop.state.step}
            del pp_loop
        elif is_bert:
            out = bert_entry.train(ctx, total_steps=case["steps"],
                                   per_data_shard_batch=case["batch"], seq_len=case["seq"],
                                   cfg=cfg, mesh_config=_dist_mesh_config(case),
                                   model_dir=mdir)
        else:
            out = lm.train(ctx, config=case["config"], total_steps=case["steps"],
                           per_data_shard_batch=case["batch"], seq_len=case["seq"],
                           attn=case.get("attn", "auto"), quant=case.get("quant", ""),
                           opt8bit=case.get("opt8bit", False),
                           mesh_config=_dist_mesh_config(case), model_dir=mdir)
    finally:
        dtrain.TrainLoop.run, dtrain.TrainLoop.save = real_run, real_save
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)
    peak_steps = step_peaks[0] if step_peaks else peak
    peak = max([peak_steps, peak] + [p for _, p in saves])
    loop = kept[0]
    axes = {k: v for k, v in loop.mesh.shape.items() if v > 1}
    rows_a_rank = case["batch"] * loop.mesh.axis_size("dp", "fsdp")
    if is_bert:
        plan = _bert_memory_plan(cfg, axes, rows_a_rank, case["seq"], loop._full_shapes,
                                 loop._specs)
    else:
        plan = memory.transformer_memory_plan(cfg, axes, rows_a_rank, case["seq"],
                                              pp=bool(case.get("pp_microbatches")))
    leaf = 4 * max(math.prod(s) for s in loop._full_shapes)
    after_gang = case.get("after_gang", False)
    restored = _gang_restore(loop, device) if after_gang else {}
    # The whole state, for the comparisons with the one-process run (an
    # after_gang layout's is read back from its checkpoint instead).
    whole = [] if after_gang else [sharding.gather_full(p.detach(), s, loop.mesh)
                                   for p, s in zip(tree_leaves(loop.state.params), loop._specs)]
    whole_opt = _whole_opt(loop) if mdir and not after_gang else None
    names = _leaf_names(tree_unflatten(loop.state.params, loop._full_shapes))
    del loop, kept
    steps = case["steps"]
    want = {k: v * steps for k, v in _dist_expected(case, cfg.n_layers).items()}
    want = {k: want.get(k, 0) for k in launches}
    step_ms = [1e3 / m.steps_per_sec for m in recs]
    steady = sorted(step_ms[1:])
    rec = dict(rank=ctx.process_id, final_step=out["final_step"], start_gb=start / 1e9,
               losses=[m.loss for m in recs], step_ms=step_ms,
               step_ms_median_steady=steady[len(steady) // 2], wall_s=wall,
               peak_gb=peak / 1e9, peak_steps_gb=peak_steps / 1e9, plan_gb=plan.total / 1e9,
               plan_rows={k: v / 1e9 for k, v in plan.rows()},
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items() if v},
               **restored)
    if launches != want:
        raise AssertionError(f"dist[{case['label']}] rank {ctx.process_id}: "
                             f"launches {launches} != {want}")
    peak_limit = plan.total + DIST_PEAK_LEAF_COPIES * leaf
    rec["peak_limit_gb"] = peak_limit / 1e9
    if peak_steps > peak_limit:
        raise AssertionError(f"dist[{case['label']}] rank {ctx.process_id}: steps' peak "
                             f"{peak_steps / 1e9} GB (from {start / 1e9} GB allocated at "
                             f"the start) > the plan's {plan.total / 1e9} GB + "
                             f"{DIST_PEAK_LEAF_COPIES} x the largest leaf's {leaf / 1e9} GB")
    if mdir:
        save_s, save_peak = saves[0]
        io_limit = peak_steps + SAVE_PEAK_LEAF_COPIES * leaf
        rec.update(save_s=save_s, save_peak_gb=save_peak / 1e9, io_limit_gb=io_limit / 1e9)
        worst = max(save_peak, int(rec.get("restore_peak_gb", 0) * 1e9))
        if worst > io_limit or not rec.get("restore_equal", True):
            raise AssertionError(
                f"dist[{case['label']}] rank {ctx.process_id}: save peak "
                f"{save_peak / 1e9} GB, restore peak {rec.get('restore_peak_gb')} GB "
                f"against the steps' {peak_steps / 1e9} GB + {SAVE_PEAK_LEAF_COPIES} x "
                f"{leaf / 1e9} GB; restored bit for bit: {rec.get('restore_equal')}")
    if ctx.process_id == 0 and not after_gang:
        key = _one_process_key(case)
        if key in _ONE_PROCESS:
            ref_losses, yard_losses, *host = _ONE_PROCESS.pop(key)
            ref_leaves, yard_leaves, init = [[t.to(device) for t in h] for h in host]
        else:
            one = make_mesh(devices=[0], device_type="cuda")
            # Without a mesh the ring is the plain attention, the
            # yardstick: the ring cases are held against the flash run.
            one_cfg = cfg.replace(attn_impl=case.get("one_process_attn", cfg.attn_impl))
            ref_losses, ref = _loop_run(case, one_cfg, device, one)
            ref_leaves = [p.detach() for p in tree_leaves(ref.state.params)]
            del ref
            yard_losses, yard = _loop_run(case, cfg.replace(attn_impl="xla"), device, one)
            yard_leaves = [p.detach() for p in tree_leaves(yard.state.params)]
            del yard
            init = tree_leaves((bert if is_bert else tfm).init_params(cfg, seed=0,
                                                                      device=device))
        if case.get("keep_one_process"):
            _ONE_PROCESS[key] = (ref_losses, yard_losses, *[
                [t.to("cpu", copy=True) for t in leaves]
                for leaves in (ref_leaves, yard_leaves, init)])
        rel_whole, rel = _change_rel(whole, ref_leaves, init)
        yard_whole, yard_rel = _change_rel(yard_leaves, ref_leaves, init)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref_losses))
        yard_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(yard_losses, ref_losses))
        loss_tol = case.get("loss_tol", DIST_LOSS_REL_TOL)
        worst = max(range(len(rel)), key=rel.__getitem__)
        rec.update(one_process_losses=ref_losses, loss_rel=loss_rel,
                   yardstick_losses=yard_losses, yardstick_loss_rel=yard_loss_rel,
                   loss_tol=loss_tol,
                   param_change_rel_l2=rel_whole,
                   param_change_rel_l2_worst=(names[worst], rel[worst]),
                   yardstick_rel_l2=yard_whole,
                   yardstick_rel_l2_worst=max(yard_rel),
                   param_change_rel_l2_by_leaf=dict(zip(names, rel)))
        del init, ref_leaves, yard_leaves
        if mdir:
            _, lp = _loop_run(case, cfg, device, make_mesh(devices=[0], device_type="cuda"),
                              model_dir=mdir)
            t = time.perf_counter()
            ok = lp.restore()
            rec["restore_s"] = time.perf_counter() - t
            same = ok and lp.state.step == steps and all(
                torch.equal(a.detach(), b) for a, b in zip(tree_leaves(lp.state.params), whole))
            rec["restored_step"] = lp.state.step
            rec["restore_equal"] = bool(same)
            rec["restore_opt_equal"] = _same_tensors(lp.tx.state_dict(), whole_opt)
            del lp
            shutil.rmtree(mdir, ignore_errors=True)
        if not (all(math.isfinite(x) for x in rec["losses"])
                and loss_rel <= loss_tol
                and rel_whole <= min(DIST_VS_YARDSTICK * yard_whole, case["change_cap"])
                and max(rel) <= DIST_VS_YARDSTICK * max(yard_rel)
                and rec.get("restore_equal", True) and rec.get("restore_opt_equal", True)):
            raise AssertionError(
                f"dist[{case['label']}] vs one process: loss rel {loss_rel} (tol "
                f"{loss_tol}; the yardstick's {yard_loss_rel}), change rel L2 "
                f"{rel_whole} and worst leaf "
                f"{rec['param_change_rel_l2_worst']} against {DIST_VS_YARDSTICK} x the "
                f"yardstick's {yard_whole} (cap {case['change_cap']}) and "
                f"{max(yard_rel)}, restore {rec.get('restore_equal')}, optimizer state "
                f"{rec.get('restore_opt_equal')}")
    del whole, whole_opt
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _whole_opt(loop):
    """``loop``'s optimizer state with each of its chunked tensors
    gathered whole over the loop's mesh: what a one-process restore of
    its checkpoint holds."""
    from kubeflow_controller_tpu_torch.dataplane import train as dtrain
    from kubeflow_controller_tpu_torch.parallel import sharding

    return dtrain.with_opt_tensors(loop.tx.state_dict(), {
        key: sharding.gather_full(t, spec, loop.mesh)
        for key, spec, t in loop.optimizer_chunks()})


def _gang_restore(loop, device):
    """The gang's restore of its own checkpoint at its mesh (C11): this
    rank's chunks (parameters, moments and step counts) copied to the
    host (with gloo's cached pinned staging buffers handed back first:
    two ranks' copies of llama3_70b_1l are 35.5 GB of the machine's 96
    GiB; the card has no room for them beside both ranks' state), the
    state zeroed, ``restore()`` timed with the peak memory reset just
    before it, then every chunk held bit for bit against its copy.
    Returns the record's additions."""
    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves

    def tensors():
        opt = loop.tx.opt.state_dict()["state"]
        return tree_leaves(loop.state.params) + [
            opt[i][k] for i in sorted(opt) for k in sorted(opt[i])]

    torch._C._host_emptyCache()
    saved = [t.detach().to("cpu", copy=True) for t in tensors()]
    step = loop.state.step
    with torch.no_grad():
        for t in tensors():
            t.zero_()
    loop.state.step = 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ok = loop.restore()
    torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    now = tensors()
    same = (ok and loop.state.step == step and len(now) == len(saved)
            and all(torch.equal(a.detach(), b.to(a.device)) for a, b in zip(now, saved)))
    copies = sum(t.untyped_storage().nbytes() for t in saved)
    del saved
    return dict(restore_s=restore_s, restore_peak_gb=peak / 1e9, restore_equal=bool(same),
                restored_step=loop.state.step, restored_bytes=copies)


def _after_gang(case, recs, smi):
    """An ``after_gang`` layout's checks, in this process once the gang
    has gone (its one-process runs do not fit beside the gang on one
    card): the one-process run of the same batches, init and steps (the
    oracle) and its plain-attention yardstick, each timed with its peak
    memory above what was held before it (the oracle's parameters stay
    on the card), then a one-process restore of the gang's checkpoint
    (timed, its peak read the same way), whose parameters are the
    gang's: held against the
    oracle's as every layout's are (rank 0's losses within the case's
    tolerance; the change from the init within DIST_VS_YARDSTICK times
    the yardstick's and within the case's ``change_cap``, whole and worst
    leaf). The checkpoint is removed afterwards."""
    import gc
    import shutil

    import torch

    from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.parallel.mesh import make_mesh

    label = case["label"]
    device = torch.device("cuda:0")
    mdir = os.path.join(OUT_DIR, "dist_ckpt", label)
    cfg = _case_config(case["config"], max_seq=max(case["seq"], 128),
                       attn_impl=case.get("attn", "auto"))
    one = make_mesh(devices=[0], device_type="cuda")
    # The oracle's parameters stay on the card (llama3_70b_1l's 11.8 GB
    # beside the yardstick's 61 GB peak), each run's others go with its
    # loop: the yardstick is compared with the oracle as it ends.
    runs, oracle, ynum = {}, None, []
    for name, c in (("one_process", cfg), ("yardstick", cfg.replace(attn_impl="xla"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        t = time.perf_counter()
        losses, loop = _loop_run(case, c, device, one)
        torch.cuda.synchronize(device)
        runs[name] = dict(losses=losses, wall_s=time.perf_counter() - t,
                          peak_gb=(torch.cuda.max_memory_allocated(device) - held) / 1e9)
        leaves = [p.detach() for p in tree_leaves(loop.state.params)]
        if oracle is None:
            oracle = leaves
        else:
            ynum = [float((y - o).float().norm()) ** 2 for y, o in zip(leaves, oracle)]
        del loop, leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    _, lp = _loop_run(case, cfg, device, one, model_dir=mdir)
    t = time.perf_counter()
    ok = lp.restore()
    torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t
    restore_peak = torch.cuda.max_memory_allocated(device) - held
    restored_step = lp.state.step
    lp.tx.opt.state.clear()                  # the gang's moments: read, not compared
    gang = [p.detach() for p in tree_leaves(lp.state.params)]
    names = _leaf_names(tree_unflatten(lp.state.params, lp._full_shapes))
    init = tree_leaves(tfm.init_params(cfg, seed=0, device=device))
    num = [float((g - o).float().norm()) ** 2 for g, o in zip(gang, oracle)]
    den = [float((o - i).float().norm()) ** 2 for o, i in zip(oracle, init)]
    del lp, gang, init, oracle
    shutil.rmtree(mdir, ignore_errors=True)
    rel_whole = math.sqrt(sum(num) / sum(den))
    yard_whole = math.sqrt(sum(ynum) / sum(den))
    rel = [math.sqrt(n / max(d, 1e-60)) for n, d in zip(num, den)]
    yard_rel = [math.sqrt(n / max(d, 1e-60)) for n, d in zip(ynum, den)]
    gang_losses = recs[0]["losses"]
    ref_losses = runs["one_process"]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gang_losses, ref_losses))
    yard_loss_rel = max(abs(a - b) / abs(b)
                        for a, b in zip(runs["yardstick"]["losses"], ref_losses))
    loss_tol = case.get("loss_tol", DIST_LOSS_REL_TOL)
    worst = max(range(len(rel)), key=rel.__getitem__)
    rec = dict(one_process_losses=ref_losses, gang_losses=gang_losses, loss_rel=loss_rel,
               yardstick_losses=runs["yardstick"]["losses"],
               yardstick_loss_rel=yard_loss_rel, loss_tol=loss_tol,
               param_change_rel_l2=rel_whole,
               param_change_rel_l2_worst=(names[worst], rel[worst]),
               yardstick_rel_l2=yard_whole, yardstick_rel_l2_worst=max(yard_rel),
               change_cap=case["change_cap"],
               one_process_wall_s=runs["one_process"]["wall_s"],
               one_process_peak_gb=runs["one_process"]["peak_gb"],
               yardstick_wall_s=runs["yardstick"]["wall_s"],
               yardstick_peak_gb=runs["yardstick"]["peak_gb"],
               one_process_restore_s=restore_s, one_process_restore_peak_gb=restore_peak / 1e9,
               one_process_restored_step=restored_step)
    log(f"dist[{label}] after the gang (one process on cuda:0) {json.dumps(rec)} | {smi}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    if not (ok and restored_step == case["steps"]
            and all(math.isfinite(x) for x in gang_losses)
            and loss_rel <= loss_tol
            and rel_whole <= min(DIST_VS_YARDSTICK * yard_whole, case["change_cap"])
            and max(rel) <= DIST_VS_YARDSTICK * max(yard_rel)):
        raise AssertionError(
            f"dist[{label}] vs one process: restored {ok} at step {restored_step}, loss "
            f"rel {loss_rel} (tol {loss_tol}; the yardstick's {yard_loss_rel}), change "
            f"rel L2 {rel_whole} and worst leaf {rec['param_change_rel_l2_worst']} "
            f"against {DIST_VS_YARDSTICK} x the yardstick's {yard_whole} (cap "
            f"{case['change_cap']}) and {max(yard_rel)}")
    return rec


def _checkpoint_bytes(case) -> int:
    """The bytes of a layout's checkpoint: its fp32 parameters and AdamW
    moments."""
    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    cfg = _case_config(case["config"])
    return 12 * sum(math.prod(s) for s in tree_leaves(tfm.param_shapes(cfg)))


#: The serving phases' models: llama3_8b at full width and 4 of its 32
#: layers, mixtral_8x7b at full width and 8. Serving is host-bound (the
#: launches of one micro-step are a layer's times the depth), so its
#: seconds follow the depth: at all 32 layers the serving phases took 530
#: of the script's 1100 s on an H100 80GB HBM3 at 700 W, against the
#: script's limit of 1200 s; at 8 the whole script took 1116.2 s on a
#: slower host once the control plane's runs over the wire were added.
#: The logits phase and its profile keep all 32 layers.
SERVE_CONFIG = "llama3_8b_4l"
MOE_SERVE_CONFIG = "mixtral_8x7b_8l"
#: The configurations cut in depth: name -> (the configuration, its
#: layers). The serving phases' two above; for the gang's layouts
#: llama3_8b cut to 2 layers (its fp32 state at 32 layers is ~128 GB),
#: mixtral_8x7b to 1 (~750 GB at 32 layers; 27 GB at 1), llama3_70b to 1
#: (1.13 TB at 80 layers; 47.3 GB at 1), the flagship at full width to 4
#: or 8
#: (DIST_CASES says why); for the tp serving gang mixtral_8x7b and
#: llama3_70b at 2 (a rank holds its whole tree before it shards, two
#: ranks on one card, and its gathers and exchanges go through host
#: memory: TP_SERVE_CASES); for the control phase's gang the flagship
#: at 2 (two epochs of two ranks within the phase's time).
CUT_CONFIGS = {SERVE_CONFIG: ("llama3_8b", 4), MOE_SERVE_CONFIG: ("mixtral_8x7b", 8),
               "llama3_8b_2l": ("llama3_8b", 2), "mixtral_8x7b_1l": ("mixtral_8x7b", 1),
               "llama3_70b_1l": ("llama3_70b", 1), "flagship_8l": ("flagship", 8),
               "flagship_4l": ("flagship", 4),
               "mixtral_8x7b_2l": ("mixtral_8x7b", 2), "llama3_70b_2l": ("llama3_70b", 2),
               "flagship_2l": ("flagship", 2)}


def _case_config(name, **overrides):
    """``lm.model_config(name, **overrides)``, a :data:`CUT_CONFIGS` name
    at its depth."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm

    base, layers = CUT_CONFIGS.get(name, (name, None))
    if layers is not None:
        overrides = dict(overrides, n_layers=layers)
    return lm.model_config(base, **overrides)


def _register_cut_configs() -> None:
    """:data:`CUT_CONFIGS` by name in ``lm.CONFIGS`` of this process, for
    the entry points called with them (``serve`` in the serving phases,
    ``lm.train`` in a gang's rank)."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm

    for name in CUT_CONFIGS:
        lm.CONFIGS[name] = lambda name=name, **kw: _case_config(name, **kw)


def _dist_worker() -> int:
    """One rank of ``dist_phase``'s gang: join through
    ``initialize_from_env`` (the env a pod gets), probe the backend's
    collectives, run every layout they allow, write this rank's
    records."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubeflow_controller_tpu_torch.dataplane import dist as ddist

    spec = json.loads(os.environ["CHIP_SMOKE_DIST"])
    _register_cut_configs()
    ctx = ddist.initialize_from_env(backend=spec["backend"])
    device = ddist.local_device(ctx)
    probe = _dist_probe(device)
    out = {"rank": ctx.process_id, "device": str(device), "probe": probe, "cases": {}}
    cases = _dist_cases(spec.get("labels"))
    for i, case in enumerate(cases):
        if not case.get("after_gang"):
            case = dict(case, keep_one_process=any(
                _one_process_key(c) == _one_process_key(case) for c in cases[i + 1:]))
        missing = [n for n in case["needs"] if probe.get(n) is not True]
        if missing:
            out["cases"][case["label"]] = {"skipped": {n: probe.get(n) for n in missing}}
            continue
        out["cases"][case["label"]] = _dist_case(ctx, case, device)
        # Written after every case, so that a later case's failure keeps
        # the records of those before it.
        with open(os.path.join(spec["out"], f"rank{ctx.process_id}.json"), "w") as f:
            json.dump(out, f)
    ddist.destroy()
    return 0


def _dist_cases(labels=None):
    """:data:`DIST_CASES`, or those of ``labels`` (a shorter call)."""
    return [c for c in DIST_CASES if labels is None or c["label"] in labels]


def dist_phase(smi, labels=None):
    """A two-rank gang of ``python -c`` workers, each with the env the
    controller gives a pod (``JAX_COORDINATOR_ADDRESS`` on 127.0.0.1,
    ``JAX_NUM_PROCESSES=2``, ``JAX_PROCESS_ID``), entering through
    ``initialize_from_env`` and ``lm.train``: the flagship at full width
    and 4 of its 16 layers (8 at fsdp=2) at dp=2, fsdp=2 (writing a checkpoint a
    one-process loop restores) and tp=2, ``int8_fused`` at fsdp=2 and
    llama3_8b (2
    layers, B3/B4) at fsdp=2; the flagship at sp=2 (ring and gathered
    attention) and at pp=2 (all 16 layers; ``TrainLoop`` with the
    pipelined loss), and
    llama3_8b (2 layers) at sp=2, S=4096, ring; mixtral_8x7b (1 layer)
    at ep=2, tp=2 and sp=2, the flagship (4 of its 16 layers) with int8
    projections at tp=2 (``int8`` and ``int8_fused``: B7's split
    entries) and ``int8_fused`` with 8-bit AdamW at fsdp=2
    (checkpointed: the quantized moments restored by one process) and
    BERT-base at tp=2 through
    ``bert.train``; each against a one-process run (``labels``: only
    those layouts); first, llama3_70b at full width and 1 layer at
    fsdp=2, checkpointed and restored by the gang, its one-process runs
    and restore after the gang (:func:`_after_gang`). NCCL with
    a card a rank when there are two cards; gloo with both ranks on
    cuda:0 on one (NCCL refuses two ranks on one card). The kernels were
    built before the gang starts, so no two ranks build at once. Per
    layout and rank: step ms, peak memory against
    ``transformer_memory_plan``, launches a step."""
    import shutil

    import torch

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    log(f"dist: backend {backend}, {cards} card(s), 2 ranks on "
        f"{'cuda:0 and cuda:1' if cards >= 2 else 'cuda:0'}")
    from kubeflow_controller_tpu_torch.ops import _build

    _build.load()                       # built before any rank starts
    out = os.path.join(OUT_DIR, "dist")
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(os.path.join(OUT_DIR, "dist_ckpt"), ignore_errors=True)
    os.makedirs(out)
    # The after_gang layouts' checkpoints stay on disk until the gang has
    # gone; the others' are removed by rank 0 within their case.
    need = max([_checkpoint_bytes(c) for c in _dist_cases(labels) if c.get("after_gang")],
               default=0)
    free = shutil.disk_usage(OUT_DIR).free
    log(f"dist: {free / 1e9:.1f} GB free on the disk of {OUT_DIR}; the largest "
        f"checkpoint kept past its case takes {need / 1e9:.1f} GB")
    if need and free < 1.1 * need:
        raise AssertionError(f"dist: {free / 1e9:.1f} GB free cannot hold a "
                             f"{need / 1e9:.1f} GB checkpoint")
    torch.cuda.empty_cache()
    log(f"dist: this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB reserved on cuda:0")
    port = _free_port()
    spec = json.dumps({"backend": backend, "out": out, "labels": labels})
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   CHIP_SMOKE_DIST=spec, PYTHONPATH=ROOT)
        if cards < 2:
            # Two ranks share one card: each rank's allocator grows and
            # shrinks its segments rather than keeping freed blocks the
            # other rank needs (llama3_70b_1l.fsdp2 peaks at ~30 GiB a rank
            # at once on both, with ~7 GiB a rank left unusable otherwise).
            env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        p, f = _spawn_rank("_dist_worker", env,
                           os.path.join(out, f"rank{rank}.log"))
        procs.append(p)
        logs.append(f)
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                log(f"dist rank {r} rc={procs[r].returncode}:\n{f.read()[-6000:]}")
        raise AssertionError(f"dist: rank(s) {bad} failed")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"dist probe ({backend} on {ranks[0]['device']}): {json.dumps(ranks[0]['probe'])}")
    runs = {}
    for case in _dist_cases(labels):
        label = case["label"]
        recs = [rk["cases"][label] for rk in ranks]
        if "skipped" in recs[0]:
            log(f"dist[{label}] not run: {backend} on {cards} card(s) cannot run "
                f"{json.dumps(recs[0]['skipped'])} on CUDA tensors; this layout waits "
                "for a two-card machine (NCCL)")
            continue
        runs[label] = recs
        for rec in recs:
            log(f"dist[{label}] {backend} {cards} card(s) {json.dumps(rec)} | {smi}")
        r0 = recs[0]
        if case.get("after_gang"):
            r0 = dict(r0, loss_rel=float("nan"), param_change_rel_l2=float("nan"),
                      param_change_rel_l2_worst="after the gang", yardstick_rel_l2=float("nan"),
                      yardstick_rel_l2_worst=float("nan"))
        log(f"dist[{label}] summary ({backend}, {cards} card(s), 2 ranks): step ms "
            f"{[round(r['step_ms_median_steady'], 2) for r in recs]} (median of the "
            f"steps after the first, per rank), steps' peak GB "
            f"{[round(r['peak_steps_gb'], 3) for r in recs]} vs plan {r0['plan_gb']:.3f} (limit "
            f"{r0['peak_limit_gb']:.3f}), peak with the save {[round(r['peak_gb'], 3) for r in recs]}"
            f", launches a rank a step "
            f"{r0['launches_per_step']}, loss rel {r0['loss_rel']:.3g}, change rel L2 "
            f"{r0['param_change_rel_l2']:.4f} (worst {r0['param_change_rel_l2_worst']}) vs "
            f"yardstick {r0['yardstick_rel_l2']:.4f} (worst "
            f"{r0['yardstick_rel_l2_worst']:.4f})"
            + (f", restored step {r0['restored_step']} equal {r0['restore_equal']}"
               if "restore_equal" in r0 else "")
            + (f", save s {[round(r['save_s'], 2) for r in recs]} peak GB "
               f"{[round(r['save_peak_gb'], 3) for r in recs]} (limit "
               f"{[round(r['io_limit_gb'], 3) for r in recs]})" if "save_s" in r0 else "")
            + (f", the gang's restore s {[round(r['restore_s'], 2) for r in recs]} peak GB "
               f"{[round(r['restore_peak_gb'], 3) for r in recs]}" if case.get("after_gang")
               else "") + f" | {smi}")
    log(f"dist: {time.perf_counter() - t0:.1f} s of gang")
    for case in _dist_cases(labels):
        if case.get("after_gang") and case["label"] in runs:
            t = time.perf_counter()
            runs[case["label"]][0]["after_gang"] = _after_gang(case, runs[case["label"]], smi)
            log(f"dist[{case['label']}] after the gang: {time.perf_counter() - t:.1f} s")
    shutil.rmtree(os.path.join(OUT_DIR, "dist_ckpt"), ignore_errors=True)
    return runs


# -- tensor- and expert-parallel serving over a two-rank gang -----------------

#: The tp fleet's fault plan: a refused intake (prefill-0, rid 2), a refused
#: install (decode-0, rid 5), a payload lost in flight (rid 1) and an ACK
#: lost (rid 3, re-sent and deduplicated), each once.
TP_FLEET_PLAN = {"specs": [
    {"kind": "refuse_admit", "site": "engine.submit", "target": "prefill-0", "rid": 2,
     "max_fires": 1},
    {"kind": "refuse_admit", "site": "engine.admit_migrated", "target": "decode-0",
     "rid": 5, "max_fires": 1},
    {"kind": "drop_migration", "site": "router.migrate", "rid": 1, "max_fires": 1},
    {"kind": "drop_migration", "site": "router.migrate_ack", "rid": 3, "max_fires": 1}]}

#: The tp gang's cases, each served at tp=2 through the controller's env
#: (``initialize_from_env``): ``via`` "serve" through ``serve()``, "engine"
#: through ``ServingEngine``, "logits" a prefill and decode tail. Each is
#: held to a one-process run of the same requests: ``yardstick`` names a
#: run of the serve phase (its completions file), the prefix phase's
#: tier run (``_YARDSTICK``), or "rank0" (rank 0 runs it in the gang,
#: before the tp run). "gathered" must give its streams bit for bit;
#: "parallel" and the MoE runs may leave them only after a near-tie
#: (``SPEC_FLIP_GAP_OF_RMS``).
TP_SERVE_CASES = [
    dict(label=f"{SERVE_CONFIG}.parallel.bucketed", config=SERVE_CONFIG, via="serve",
         tp_compute="parallel", yardstick="fp", exact=False,
         serve_kw=dict(batch=16, slots=8, prompt_len=256, max_new_tokens=32,
                       block_size=16, prefill_mode="bucketed")),
    dict(label=f"{SERVE_CONFIG}.parallel.exact.spec", config=SERVE_CONFIG, via="serve",
         tp_compute="parallel", yardstick="tiled.spec", yardstick_run="spec", exact=True,
         serve_kw=dict(batch=16, slots=8, prompt_len=256, max_new_tokens=32,
                       block_size=16, speculative=True, draft_k=4, seed=0,
                       input_file="tiled_prompts.jsonl")),
    dict(label=f"{SERVE_CONFIG}.parallel.int8kv", config=SERVE_CONFIG, via="serve",
         tp_compute="parallel", yardstick="int8", exact=False,
         serve_kw=dict(batch=4, slots=8, prompt_len=256, max_new_tokens=32,
                       block_size=16, prefill_mode="bucketed", kv_quant="int8")),
    dict(label=f"{SERVE_CONFIG}.parallel.tier.int8kv", config=SERVE_CONFIG, via="engine",
         tp_compute="parallel", yardstick="tier.int8.on", exact=False, max_new=32),
    dict(label=f"{SERVE_CONFIG}.parallel.logits", config=SERVE_CONFIG, via="logits",
         tp_compute="parallel", yardstick="rank0"),
    dict(label="llama3_8b_2l.gathered", config="llama3_8b_2l", via="engine",
         tp_compute="gathered", yardstick="rank0", exact=False, n_requests=2,
         prompt_len=16, max_new=4,
         engine_kw=dict(n_slots=2, max_seq=32, prefill_mode="bucketed")),
    dict(label="llama3_8b_2l.gathered.logits", config="llama3_8b_2l", via="logits",
         tp_compute="gathered", yardstick="rank0", steps=1),
    dict(label="mixtral_8x7b_2l.int8.gathered", config="mixtral_8x7b_2l", quant="int8",
         via="engine", tp_compute="gathered", yardstick="rank0", exact=True, n_requests=4,
         prompt_len=256, max_new=8,
         engine_kw=dict(n_slots=4, max_seq=272, prefill_mode="exact")),
    dict(label="mixtral_8x7b_2l.int8.parallel", config="mixtral_8x7b_2l", quant="int8",
         via="engine", tp_compute="parallel", yardstick="rank0", exact=False,
         n_requests=4, prompt_len=48, max_new=8,
         engine_kw=dict(n_slots=4, max_seq=64, prefill_mode="bucketed")),
    dict(label="llama3_70b_2l.parallel", config="llama3_70b_2l", via="serve",
         tp_compute="parallel", yardstick="rank0", exact=True,
         serve_kw=dict(batch=4, slots=4, prompt_len=256, max_new_tokens=8,
                       block_size=16)),
    # The fleet over the gang: serve(disagg=True) at tp=2, each rank running
    # prefill-0 and decode-0 on its head group, held to the first 8 streams
    # of the single-engine parallel case above (its first 8 prompts), then
    # the same run under a fault plan.
    dict(label=f"{SERVE_CONFIG}.parallel.disagg", config=SERVE_CONFIG, via="serve",
         tp_compute="parallel", yardstick=f"tp:{SERVE_CONFIG}.parallel.bucketed",
         exact=False, fleet=True,
         serve_kw=dict(batch=8, slots=8, prompt_len=256, max_new_tokens=32,
                       block_size=16, disagg=True)),
    dict(label=f"{SERVE_CONFIG}.parallel.disagg.faults", config=SERVE_CONFIG, via="serve",
         tp_compute="parallel", yardstick=f"tp:{SERVE_CONFIG}.parallel.bucketed",
         exact=False, fleet=True, fault_plan=TP_FLEET_PLAN,
         serve_kw=dict(batch=8, slots=8, prompt_len=256, max_new_tokens=32,
                       block_size=16, disagg=True, fault_seed=0, watchdog_stale_s=30.0)),
]
#: What the plan's run books: each spec fires once; the lost ACK's re-send
#: is one dedup; the two lost hops are migration timeouts.
TP_FLEET_FIRES = {"faults.engine.submit.refuse_admit": 1.0,
                  "faults.engine.admit_migrated.refuse_admit": 1.0,
                  "faults.router.migrate.drop_migration": 1.0,
                  "faults.router.migrate_ack.drop_migration": 1.0,
                  "faults_total": 4.0, "migrate_dedups": 1.0, "migration_timeouts": 2.0}
#: The fleet summary keys a tp fleet case records (rank for rank).
TP_FLEET_KEYS = ("migrations", "pages_migrated", "migration_bytes", "migration_timeouts",
                 "migrate_dedups", "faults_injected", "faults_total")
#: Parallel logits (bf16) against one device's, relative L2 over the
#: vocabulary: each layer's two tp sums round the ranks' bf16 partials
#: where one device rounds its whole product once, an error of the order
#: of the kernel-vs-gather difference LOGITS_REL_L2_TOL bounds.
TP_LOGITS_REL_L2_TOL = LOGITS_REL_L2_TOL
TP_SERVE_TIMEOUT_S = 600


def _tp_cases(labels=None):
    return [c for c in TP_SERVE_CASES if labels is None or c["label"] in labels]


def _tp_requests(case, vocab):
    """The case's ``(rid, prompt)`` pairs: seeded prompts, or the
    yardstick's own."""
    import numpy as np

    if case["yardstick"] in _YARDSTICK:
        return [(i, np.asarray(p, np.int32))
                for i, p in enumerate(_YARDSTICK[case["yardstick"]]["prompts"])]
    rng = np.random.default_rng(17)
    return [(i, rng.integers(0, vocab, case["prompt_len"]).astype(np.int32))
            for i in range(case["n_requests"])]


class _EngineTap:
    """Inside the block, every ``ServingEngine`` step's completions, the
    last engine made and the ``FleetRouter`` steps taken (``serve()``
    keeps them to itself)."""

    def __enter__(self):
        from kubeflow_controller_tpu_torch.dataplane import router as rt
        from kubeflow_controller_tpu_torch.dataplane import serving_engine as se

        self.completions, self.engine, self.router_steps = [], None, 0
        self._cls, self._step, self._init = se.ServingEngine, se.ServingEngine.step, \
            se.ServingEngine.__init__
        self._router_step = rt.FleetRouter.step
        tap = self

        def router_step(router):
            tap.router_steps += 1
            return tap._router_step(router)

        rt.FleetRouter.step = router_step

        def init(eng, *a, **kw):
            tap._init(eng, *a, **kw)
            tap.engine = eng

        def step(eng):
            out = tap._step(eng)
            tap.completions.extend(out)
            return out

        self._cls.__init__, self._cls.step = init, step
        return self

    def __exit__(self, *exc):
        from kubeflow_controller_tpu_torch.dataplane import router as rt

        self._cls.__init__, self._cls.step = self._init, self._step
        rt.FleetRouter.step = self._router_step


def _tp_engine_record(eng, res, wall, launches, streams, device):
    """A rank's record of one served run."""
    import torch

    from kubeflow_controller_tpu_torch.parallel.sharding import serving_param_shardings

    rec = dict(streams=streams, launches=launches, wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               **{k: res[k] for k in (
                   "ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms", "tokens_per_sec",
                   "prefill_chunks", "spec_steps", "draft_accepted", "draft_proposed",
                   "spilled_pages", "rehydrate_hits", "requests", "tp",
                   "kv_hbm_per_device_mb", "moe_experts_per_shard", *TP_FLEET_KEYS)
                  if k in res},
               **{k: v for k, v in res.items() if k.startswith("faults.")})
    if eng is not None:
        rec["resident_weight_bytes"] = _weight_bytes(eng.params)
        rec["traffic_model_weight_bytes"] = eng._weights_model()[0]
        if eng._mesh is not None:
            # Each leaf's bytes over the ranks that split it.
            specs = serving_param_shardings(eng.cfg, eng._mesh, eng._w_quant)
            rec["expected_resident_bytes"] = _expected_bytes(eng.cfg, specs, eng.tp)
    return rec


def _expected_bytes(cfg, specs, tp):
    """A rank's bytes of a fresh serving tree (every leaf in the compute
    dtype but the router, drawn in the parameter dtype; int8 codes a byte
    each) stored by ``specs``: each leaf's whole bytes over the tp ranks
    that split it."""
    import torch

    from kubeflow_controller_tpu_torch.models import transformer as tfm
    from kubeflow_controller_tpu_torch.parallel.sharding import P, tp_dims

    item = torch.empty((), dtype=cfg.dtype).element_size()

    def part(shape, spec, size):
        return math.prod(shape) * size // (tp if tp_dims(spec, len(shape)) else 1)

    def walk(shape, spec, key=None):
        if isinstance(shape, dict):
            return sum(walk(shape[k], spec[k], k) for k in shape)
        if isinstance(spec, P):
            size = (torch.empty((), dtype=cfg.param_dtype).element_size()
                    if key == "w_router" else item)
            return part(shape, spec, size)
        scale = tuple(shape[:-2]) + (1, shape[-1])
        return part(shape, spec[0], 1) + part(scale, spec[1], item)

    return walk(tfm.param_shapes(cfg), specs)


def _tp_logits(cfg, params, mesh, tp_compute, rank, device, steps=4):
    """Two 256-token prompts admitted by ``prefill_into_paged``, then
    ``steps`` decode steps fed one device's argmax (rank 0 computes one
    device's run beside the mesh's; the other ranks take its tokens from
    the mesh's logits, which are the same bits on every rank): per step
    the relative L2 of the mesh's logits to one device's, whether their
    argmaxes agree and whether they are equal."""
    import numpy as np
    import torch

    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.parallel.sharding import shard_serving_params

    rng = np.random.default_rng(31)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, 256).astype(np.int32))
               .to(device)[None] for _ in range(2)]
    bs, mb = 16, 17
    chunks = shard_serving_params(cfg, params, mesh, gen.weight_quant(params))
    runs = [("mesh", mesh, chunks)] + ([("base", None, params)] if rank == 0 else [])
    caches, logits = {}, {}
    for mode, m, p in runs:
        cache = gen.init_paged_cache(cfg, 2, mb, 2 * mb, bs, device=device,
                                     tp=gen.tp_size(m))
        cache.tables = torch.arange(2 * mb, dtype=torch.int32, device=device).reshape(2, mb)
        rows = []
        for i, pr in enumerate(prompts):
            lg, cache = gen.prefill_into_paged(cfg, p, pr, cache, i, mesh=m,
                                               tp_compute=tp_compute)
            rows.append(lg)
        caches[mode], logits[mode] = cache, torch.cat(rows)
    out = []
    for step in range(steps + 1):
        if rank == 0:
            a, b = logits["mesh"].float(), logits["base"].float()
            out.append(dict(step=step, rel_l2=float((a - b).norm() / b.norm()),
                            argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()),
                            equal=bool(torch.equal(a, b)),
                            finite=bool(torch.isfinite(a).all())))
        if step == steps:
            break
        toks = logits["base" if rank == 0 else "mesh"].argmax(-1).to(torch.int32)
        if mesh is not None:
            # Every rank feeds rank 0's tokens (one device's argmax).
            import torch.distributed as dist

            dist.broadcast(toks, src=0)
        for mode, m, p in runs:
            logits[mode], caches[mode] = gen.decode_step_paged(
                cfg, p, toks[:, None], caches[mode], mesh=m, tp_compute=tp_compute)
    del chunks, caches
    return out


def _tp_case(ctx, case, device, mesh):
    """One case on this rank: the one-process yardstick first where rank
    0 runs it, then the tp run; returns this rank's record."""
    import gc

    import torch

    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    rank = ctx.process_id
    cfg = _case_config(case["config"])
    quant = case.get("quant", "")
    rec = {}
    t0 = time.perf_counter()
    if case["via"] == "serve":
        kw = dict(case["serve_kw"])
        if "input_file" in kw:
            kw["input_file"] = os.path.join(OUT_DIR, kw["input_file"])

        if case.get("fleet"):
            # Rank 0 alone writes the trace; each rank reads its own copy
            # of the plan.
            kw["trace"] = _tp_trace_path(case)
            if case.get("fault_plan"):
                kw["fault_plan"] = os.path.join(OUT_DIR, "tp_serve",
                                                f"{case['label']}.plan-{rank}.json")
                with open(kw["fault_plan"], "w") as f:
                    json.dump(case["fault_plan"], f)

        def run(**extra):
            from kubeflow_controller_tpu_torch.obs.telemetry import registry

            torch.cuda.reset_peak_memory_stats(device)
            agreed = registry().counter("agreed_broadcasts", "dataplane")
            b0 = agreed.value
            with _EngineTap() as tap:
                res, wall, launches = _counted(lambda: serve(
                    config=case["config"], quant=quant, device=str(device), **kw, **extra))
            streams = {c.rid: list(map(int, c.tokens)) for c in tap.completions}
            out = _tp_engine_record(tap.engine, res, wall, launches, streams, device)
            if case.get("fleet"):
                out.update(router_steps=tap.router_steps,
                           agreed_broadcasts=agreed.value - b0)
            del tap
            return out

        if case["yardstick"] == "rank0" and rank == 0:
            rec["one_process"] = run(ctx=ProcessContext())
            gc.collect()
            torch.cuda.empty_cache()
        rec.update(run(tp=2, tp_compute=case["tp_compute"]))
    else:
        params = gen.init_inference_params(cfg, seed=0, device=device, quant=quant)
        if case["via"] == "logits":
            rec["logits"] = _tp_logits(cfg, params, mesh, case["tp_compute"], rank, device,
                                       case.get("steps", 4))
        else:
            reqs = _tp_requests(case, cfg.vocab_size)
            ekw = {"prefill_mode": "bucketed", **(
                case.get("engine_kw") or _YARDSTICK[case["yardstick"]]["engine_kw"])}

            def run(m):
                torch.cuda.reset_peak_memory_stats(device)
                eng = ServingEngine(cfg, params, block_size=16, device=device, mesh=m,
                                    tp_compute=case["tp_compute"], **ekw)
                comps, wall, launches = _counted(lambda: eng.run(
                    [Request(rid=r, prompt=p, max_new_tokens=case["max_new"])
                     for r, p in reqs]))
                res = eng.stats.summary(wall_s=wall)
                streams = {c.rid: list(map(int, c.tokens)) for c in comps}
                return _tp_engine_record(eng, res, wall, launches, streams, device)

            if case["yardstick"] == "rank0" and rank == 0:
                rec["one_process"] = run(None)
            rec.update(run(mesh))
        del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["case_s"] = time.perf_counter() - t0
    return rec


def _tp_trace_path(case):
    return os.path.join(OUT_DIR, "tp_serve", f"{case['label']}.trace.json")


def _tp_fleet_hold(case, recs, n_layers):
    """A tp fleet case's books and launches, rank for rank: every rank's
    fleet summary and fault ledger the same (rank 0's decisions), the
    plan's fires exact; rank 0's trace with each rid's migration stitched
    (one install and one router hop a rid, an export for each attempt
    that reached one); B1 none, B6 the 8 prompts' chunks x the layers
    (prefill-0), B5 decode-0's dispatches (from rank 0's trace) x 4 x the
    layers, on every rank."""
    from kubeflow_controller_tpu_torch.obs.trace import load_chrome_trace

    label = case["label"]
    keys = [k for k in recs[0] if k in TP_FLEET_KEYS or k.startswith("faults.")]
    if any({k: rec.get(k) for k in keys} != {k: recs[0].get(k) for k in keys}
           for rec in recs[1:]):
        raise AssertionError(f"tp[{label}]: the ranks' fleet books differ: "
                             f"{[{k: rec.get(k) for k in keys} for rec in recs]}")
    kw = case["serve_kw"]
    n = kw["batch"]
    if recs[0]["migrations"] != n:
        raise AssertionError(f"tp[{label}]: {recs[0]['migrations']} migrations, want {n}")
    if case.get("fault_plan"):
        got = {k: recs[0].get(k) for k in TP_FLEET_FIRES}
        if got != TP_FLEET_FIRES:
            raise AssertionError(f"tp[{label}]: fires and books {got}, want {TP_FLEET_FIRES}")
    doc = load_chrome_trace(_tp_trace_path(case))
    per_rid = {}
    for e in doc["traceEvents"]:
        rid = e.get("args", {}).get("rid")
        if rid is not None and e["name"] in ("migrate_export", "migrate_install",
                                             "migrate"):
            per_rid.setdefault(rid, {}).setdefault(e["name"], 0)
            per_rid[rid][e["name"]] += 1
    want_rids = sorted(map(str, range(n)))
    exact = not case.get("fault_plan")
    if sorted(per_rid) != want_rids or any(
            v.get("migrate_install") != 1 or v.get("migrate") != 1
            or not v.get("migrate_export")
            or (exact and v.get("migrate_export") != 1) for v in per_rid.values()):
        raise AssertionError(f"tp[{label}]: rank 0's per-rid migration spans {per_rid}")
    dispatches = sum(1 for e in doc["traceEvents"]
                     if e.get("name") == "dispatch" and e.get("cat") == "dataplane")
    pages = -(-kw["prompt_len"] // kw["block_size"])
    chunks = n * pages
    # Every request ships its whole prompt (no prefix is shared); a rank
    # ships its head group and books whole pages. Under the plan the
    # refused install's request ships again; the lost ACK's re-send finds
    # its pages in the receiver's trie and ships pointers.
    shipped = chunks + (pages if case.get("fault_plan") else 0)
    page = _page_bytes(_case_config(case["config"]))
    if (recs[0]["pages_migrated"], recs[0]["migration_bytes"]) != (chunks, shipped * page):
        raise AssertionError(f"tp[{label}]: {recs[0]['pages_migrated']} pages installed, "
                             f"{recs[0]['migration_bytes']} B shipped; want {chunks}, "
                             f"{shipped * page}")
    want = {"flash_fwd": 0, "paged_chunk": chunks * n_layers,
            "paged_decode": dispatches * 4 * n_layers}
    for r, rec in enumerate(recs):
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"tp[{label}] rank {r}: launches {got}, want {want} "
                                 f"({dispatches} decode dispatches in rank 0's trace)")
    log(f"tp[{label}]: launches a rank {want} (predicted: B6 {chunks} chunks x "
        f"{n_layers}, B5 {dispatches} dispatches x 4 x {n_layers}); agreed broadcasts "
        f"{[rec['agreed_broadcasts'] for rec in recs]} over "
        f"{[rec['router_steps'] for rec in recs]} router steps "
        f"({recs[0]['agreed_broadcasts'] / max(1, recs[0]['router_steps'])} a step); "
        f"books {({k: recs[0].get(k) for k in keys})}; per-rid spans stitched on rank 0")


def _tp_probe(device):
    """Whether the gang's backend reduces and gathers bf16 tensors of
    ``device`` (the tp sums and gathers of the bf16 serving path)."""
    import torch
    import torch.distributed as dist

    out = {}
    x = torch.ones(8, device=device, dtype=torch.bfloat16)
    for name, fn in (("all_reduce_bf16", lambda: dist.all_reduce(x.clone())),
                     ("all_gather_into_tensor_bf16", lambda: dist.all_gather_into_tensor(
                         torch.empty(16, device=device, dtype=torch.bfloat16), x))):
        try:
            fn()
            torch.cuda.synchronize(device)
            out[name] = True
        except Exception as e:  # a probe: its finding is the answer
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def _tp_serve_worker() -> int:
    """One rank of ``tp_serve_phase``'s gang: join through
    ``initialize_from_env``, probe the bf16 collectives, serve every case,
    write this rank's records after each."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubeflow_controller_tpu_torch.dataplane import dist as ddist
    from kubeflow_controller_tpu_torch.parallel.mesh import serving_mesh

    spec = json.loads(os.environ["CHIP_SMOKE_TP"])
    _YARDSTICK.update(spec["yardsticks"])
    _register_cut_configs()
    ctx = ddist.initialize_from_env(backend=spec["backend"])
    device = ddist.local_device(ctx)
    torch.cuda.set_device(device)
    out = {"rank": ctx.process_id, "device": str(device), "probe": _tp_probe(device),
           "cases": {}}
    mesh = serving_mesh(2, device_type=device.type)
    for case in _tp_cases(spec.get("labels")):
        out["cases"][case["label"]] = _tp_case(ctx, case, device, mesh)
        with open(os.path.join(spec["out"], f"rank{ctx.process_id}.json"), "w") as f:
            json.dump(out, f)
    ddist.destroy()
    return 0


def _tp_check_launches(label, rec, n_layers, exact):
    """A rank's launches a layer a step: B5 whole decode micro-steps, B6
    one a layer a prefill chunk and verify step, B1 (exact prefill) one
    a layer an admission."""
    ln = rec["launches"]
    want_chunk = (rec["prefill_chunks"] + rec.get("spec_steps", 0)) * n_layers
    bad = (ln["paged_decode"] <= 0 or ln["paged_decode"] % n_layers
           or ln["paged_chunk"] != want_chunk
           or ln.get("flash_fwd", 0) != (rec["requests"] * n_layers if exact else 0))
    if bad:
        raise AssertionError(f"tp[{label}]: launches {ln}, want paged_chunk {want_chunk}, "
                             f"whole decode steps, flash_fwd admissions x {n_layers}")


def tp_serve_phase(smi, serve_runs, labels=None):
    """A two-rank gang that serves through the controller's env
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES=2``,
    ``JAX_PROCESS_ID``; gloo with both ranks on cuda:0 on one card, NCCL
    with a card a rank on two) every case of :data:`TP_SERVE_CASES`, all
    at full width: llama3_8b (``SERVE_CONFIG``, 4 layers) under ``"parallel"`` (bucketed,
    exact with lookup speculation, int8 KV, the prefix cache with the
    host tier over int8 pages, a logits tail), llama3_8b (2 layers)
    under ``"gathered"`` (streams and logits bit for bit), mixtral_8x7b
    (2 layers, int8 expert banks) in both modes and llama3_70b (2 of its
    80 layers) under ``"parallel"`` through ``serve()``. Per case and
    rank: B1/B5/B6 launches against the one-process run's, the resident
    weight bytes against the placement's and the traffic model's
    figures, peak memory, TTFT, TPOT and wall."""
    import shutil

    import torch

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    from kubeflow_controller_tpu_torch.ops import _build

    _build.load()                       # built before any rank starts
    out = os.path.join(OUT_DIR, "tp_serve")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    torch.cuda.empty_cache()
    log(f"tp serve: backend {backend}, {cards} card(s), 2 ranks; this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    port = _free_port()
    spec = json.dumps({"backend": backend, "out": out, "labels": labels,
                       "yardsticks": _YARDSTICK})
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   CHIP_SMOKE_TP=spec, PYTHONPATH=ROOT)
        if cards < 2:
            env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        p, f = _spawn_rank("_tp_serve_worker", env,
                           os.path.join(out, f"rank{rank}.log"))
        procs.append(p)
        logs.append(f)
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, TP_SERVE_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                log(f"tp serve rank {r} rc={procs[r].returncode}:\n{f.read()[-6000:]}")
        raise AssertionError(f"tp serve: rank(s) {bad} failed")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"tp serve: {time.perf_counter() - t0:.1f} s of gang; probe ({backend} on "
        f"{ranks[0]['device']}): {json.dumps(ranks[0]['probe'])}")
    records = {}
    for case in _tp_cases(labels):
        label = case["label"]
        recs = [rk["cases"][label] for rk in ranks]
        records[label] = recs
        _tp_hold(case, recs, serve_runs, smi, records)
    return records


def _tp_hold(case, recs, serve_runs, smi, records=None):
    """Hold one case's ranks to each other and to the one-process run
    (a fleet case: to an earlier case of the gang, ``records``)."""
    label = case["label"]
    cfg = _case_config(case["config"])
    n_layers = cfg.n_layers
    for r, rec in enumerate(recs):
        log(f"tp[{label}] rank {r} {json.dumps({k: v for k, v in rec.items() if k not in ('streams', 'one_process')})} | {smi}")
    if case["via"] == "logits":
        for step in recs[0]["logits"]:
            log(f"tp[{label}] step {step['step']}: rel L2 {step['rel_l2']} (tol "
                f"{TP_LOGITS_REL_L2_TOL}), argmax equal {step['argmax_equal']}, "
                f"equal {step['equal']}")
            if not step["finite"] or step["rel_l2"] > TP_LOGITS_REL_L2_TOL:
                raise AssertionError(f"tp[{label}]: logits {step}")
            if case["tp_compute"] == "gathered" and not step["equal"]:
                raise AssertionError(f"tp[{label}]: gathered logits are not one "
                                     f"device's bits: {step}")
        return
    if recs[1]["streams"] != recs[0]["streams"]:
        raise AssertionError(f"tp[{label}]: the ranks' completions differ")
    got = {int(k): v for k, v in recs[0]["streams"].items()}
    yard = case["yardstick"]
    if yard.startswith("tp:"):
        # The single-engine tp=2 case's streams of the same prompts.
        base = records[yard[3:]][0]
        want = {r: v for r, v in ((int(k), v) for k, v in base["streams"].items())
                if r in got}
        if sorted(got) != sorted(want):
            raise AssertionError(f"tp[{label}]: requests {sorted(got)} vs {sorted(want)}")
        _tp_fleet_hold(case, recs, n_layers)
        gaps = _first_divergence_gaps(_case_params(case), want, got,
                                      _stream_context(_tp_prompts(case, cfg), want), cfg)
        _check_near_ties(f"tp[{label}] vs {yard[3:]}", gaps, len(got))
        _drop_case_params()
        return
    if yard == "rank0":
        one = recs[0]["one_process"]
        want, one_launches = {int(k): v for k, v in one["streams"].items()}, one["launches"]
        log(f"tp[{label}] one process: {json.dumps({k: v for k, v in one.items() if k != 'streams'})} | {smi}")
    elif yard in _YARDSTICK:
        want = {int(k): v for k, v in _YARDSTICK[yard]["streams"].items()}
        one_launches = _YARDSTICK[yard]["launches"]
    else:
        want = {c["rid"]: c["completion"] for c in
                _read_completions(os.path.join(OUT_DIR, f"serve_{yard}.jsonl"))}
        one_launches = serve_runs[case.get("yardstick_run", yard)][1]
    if sorted(got) != sorted(want):
        raise AssertionError(f"tp[{label}]: requests {sorted(got)} vs {sorted(want)}")
    for r, rec in enumerate(recs):
        _tp_check_launches(f"{label} rank {r}", rec, n_layers, case["exact"])
        if rec.get("resident_weight_bytes") != rec.get("expected_resident_bytes"):
            raise AssertionError(
                f"tp[{label}] rank {r}: {rec.get('resident_weight_bytes')} weight bytes "
                f"resident, the placement stores {rec.get('expected_resident_bytes')}")
    per_rank = {k: [rec["launches"].get(k, 0) for rec in recs]
                for k in ("flash_fwd", "paged_decode", "paged_chunk")}
    log(f"tp[{label}] launches a rank {json.dumps(per_rank)} vs one process "
        f"{ {k: one_launches.get(k, 0) for k in per_rank} }; resident weight GB a rank "
        f"{[rec['resident_weight_bytes'] / 1e9 for rec in recs]} (traffic model's "
        f"weight bytes a step {recs[0]['traffic_model_weight_bytes'] / 1e9} GB)")
    if got == want:
        # The same streams are the same schedule: the same launches a rank.
        if not all(per_rank[k] == [one_launches.get(k, 0)] * 2 for k in per_rank):
            raise AssertionError(f"tp[{label}]: the streams are one process's but the "
                                 f"launches are not: {per_rank} vs {one_launches}")
        log(f"tp[{label}]: {len(got)} of {len(got)} streams equal one process's")
        return
    if case["tp_compute"] == "gathered" and not cfg.moe_experts:
        # Gathered dense serving is one device's arithmetic; a MoE model's
        # expert-parallel FFN sums in another order in either mode.
        raise AssertionError(f"tp[{label}]: gathered streams differ from one process's")
    prompts = _tp_prompts(case, cfg)
    gaps = _first_divergence_gaps(_case_params(case), want, got,
                                  _stream_context(prompts, want), cfg)
    _check_near_ties(f"tp[{label}] vs one process", gaps, len(got))
    _drop_case_params()


_CASE_PARAMS = {}


def _case_params(case):
    """The weights a case served (seed 0), drawn in this process."""
    from kubeflow_controller_tpu_torch.models import generate as gen

    if case["config"] == SERVE_CONFIG:
        return _llama()[1]
    key = (case["config"], case.get("quant", ""))
    if key not in _CASE_PARAMS:
        _CASE_PARAMS.clear()
        _CASE_PARAMS[key] = gen.init_inference_params(
            _case_config(case["config"]), seed=0, device="cuda", quant=key[1])
    return _CASE_PARAMS[key]


def _drop_case_params():
    _CASE_PARAMS.clear()
    _drop_llama()


def _tp_prompts(case, cfg):
    """Each request's prompt, by rid, as the served run had it."""
    import numpy as np

    if case["via"] == "engine":
        return {r: p for r, p in _tp_requests(case, cfg.vocab_size)}
    kw = case["serve_kw"]
    if "input_file" in kw:
        return dict(enumerate(r["prompt"] for r in _read_completions(
            os.path.join(OUT_DIR, kw["input_file"]))))
    rng = np.random.default_rng(0)
    return dict(enumerate(rng.integers(0, cfg.vocab_size, (kw["batch"], kw["prompt_len"]))))


# -- the control plane: the port's controller launching the port's trainer --

#: The Local job's steps (the flagship through ``lm.train``) and the
#: gang's: epoch 0 checkpoints at GANG_STEPS[0] and exits 137, epoch 1
#: resumes there and trains to GANG_STEPS[1].
CONTROL_LOCAL_STEPS = 5
CONTROL_GANG_STEPS = (2, 4)
CONTROL_GANG_CONFIG = "flagship_2l"
CONTROL_TIMEOUT_S = 600
#: The runs over the wire: ``remote.k8s`` trains as the Local job does
#: (the flagship, CONTROL_LOCAL_STEPS); ``remote.rest`` the flagship at 2
#: of its 16 layers, full width, for 2 steps. Each must reach Succeeded
#: within CONTROL_REMOTE_TIMEOUT_S of wall time.
CONTROL_REMOTE = {"remote.k8s": ("flagship", CONTROL_LOCAL_STEPS),
                  "remote.rest": ("flagship_2l", 2)}
CONTROL_REMOTE_TIMEOUT_S = 300
#: The remote runs' pod start delay (simulated seconds, which the ticker
#: makes wall seconds): the job's phases are read by polling the wire
#: every 20 ms, and with pods that start at once a Pending of a few ms
#: can fall between two reads.
CONTROL_REMOTE_START_S = 1.0


def _spawn_rank(entry, env, log_path):
    """Start ``python -c "import chip_smoke as c; raise
    SystemExit(c.<entry>())"`` from the repo root with ``env``, its
    output to ``log_path``; returns the process and its open log."""
    f = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; raise SystemExit(c.{entry}())"],
        cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT), f


def _free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _control_worker() -> int:
    """One rank of the control phase's gang: the env is the pod's (the
    controller's, with the coordinator on loopback); join through
    ``initialize_from_env``, report the step ``lm.train`` resumed from,
    train, leave the group and exit with the code the epoch scripts."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubeflow_controller_tpu_torch.dataplane import dist as ddist
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig

    spec = json.loads(os.environ["CHIP_SMOKE_CONTROL"])
    _register_cut_configs()
    ctx = ddist.initialize_from_env(backend="gloo")
    torch.cuda.set_device(ddist.local_device(ctx))
    m = lm.train(ctx, config=CONTROL_GANG_CONFIG, total_steps=spec["steps"],
                 per_data_shard_batch=8, seq_len=1024,
                 mesh_config=MeshConfig(fsdp=2))
    rec = {"epoch": spec["epoch"], "rank": ctx.process_id,
           "JAX_NUM_PROCESSES": os.environ["JAX_NUM_PROCESSES"],
           "world": torch.distributed.get_world_size(),
           "resumed_from": m["start_step"], "final_step": m["final_step"],
           "loss": m["loss"]}
    with open(os.path.join(spec["out"],
                           f"epoch{spec['epoch']}.rank{ctx.process_id}.json"), "w") as f:
        json.dump(rec, f)
    ddist.destroy()
    return spec["exit_code"]


def _control_job(name, model_dir, accelerator_type=None):
    from kubeflow_controller_tpu_torch.api import (
        Container, ObjectMeta, PodSpec, PodTemplateSpec, ReplicaSpec, ReplicaType,
        TPUJob, TPUJobSpec, TPUSliceSpec,
    )

    rs = ReplicaSpec(
        replica_type=ReplicaType.LOCAL,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name="trainer", image="trainer:latest",
            command=["python", "-m",
                     "kubeflow_controller_tpu_torch.dataplane.entrypoints.lm"])])))
    if accelerator_type:
        rs.replica_type = ReplicaType.WORKER
        rs.tpu = TPUSliceSpec(accelerator_type=accelerator_type)
    return TPUJob(metadata=ObjectMeta(name=name, namespace="default"),
                  spec=TPUJobSpec(model_dir=model_dir, replica_specs=[rs]))


def _control_summary(label, rt, job, phases, wall_s, smi):
    st = job.status
    rec = {"job": label, "phases": [p.value for p in phases],
           "restarts": st.restarts,
           "sim_submit_to_running_s": st.all_running_time - st.submit_time,
           "sim_submit_to_succeeded_s": st.completion_time - st.submit_time,
           "reconcile_syncs": rt.controller.sync_count,
           "noop_syncs": rt.controller.syncs_skipped_noop,
           "wall_s": wall_s}
    return rec


def _control_local(smi, failures):
    """A ``Local`` TPUJob whose pod runs ``lm.train(ProcessContext.from_env(
    pod env), config="flagship")`` in its ``run_fn`` thread on the card:
    Pending, Running (the first ticks do not wait on the workload, so
    the controller sees the pod run), Succeeded; the checkpoint in the
    injected ``TPUJOB_MODEL_DIR``; B1-B4's launches over the run those of
    the train phase's flagship a step times the steps."""
    import shutil
    import threading

    import torch

    from kubeflow_controller_tpu_torch.api.types import JobPhase
    from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
    from kubeflow_controller_tpu_torch.dataplane import dist as ddist
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.runtime import LocalRuntime

    mdir = os.path.join(OUT_DIR, "control", "local_ckpt")
    shutil.rmtree(mdir, ignore_errors=True)
    go, seen = threading.Event(), {}

    def run_fn(pod):
        env = dict(pod.spec.containers[0].env)
        seen["env"] = env
        torch.cuda.set_device(0)            # this thread's device
        go.wait()
        try:
            seen["metrics"] = lm.train(
                ProcessContext.from_env(env), config="flagship",
                total_steps=CONTROL_LOCAL_STEPS, per_data_shard_batch=16,
                seq_len=1024)
            torch.cuda.synchronize()
        finally:
            ddist.destroy()
        return 0

    policy = PodRunPolicy(start_delay=0, run_fn=run_fn, run_fn_join=0.0)
    rt = LocalRuntime(policy)
    phases = []

    def job():
        j = rt.get_job("default", "flagship")
        if j is not None and (not phases or phases[-1] != j.status.phase):
            phases.append(j.status.phase)
        return j

    t0 = time.perf_counter()
    _reset_launches()
    try:
        rt.submit(_control_job("flagship", mdir))
        rt.controller.drain()
        job()
        if not rt.run_until(lambda: job().status.phase == JobPhase.RUNNING,
                            max_steps=5):
            failures.append(f"control[local]: not Running: {phases}")
        policy.run_fn_join = CONTROL_TIMEOUT_S
        go.set()
        rt.run_until(lambda: job().is_done(), max_steps=20)
    finally:
        go.set()
        rt.stop()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    final = job()
    rec = _control_summary("local", rt, final, phases, wall_s, smi)
    want = _train_launches_want(launches, "flagship", CONTROL_LOCAL_STEPS)
    rec["launches"] = launches
    if [p.value for p in phases if p.value] != ["Pending", "Running", "Succeeded"]:
        failures.append(f"control[local]: phases {[p.value for p in phases]}")
    if launches != want:
        failures.append(f"control[local]: launches {launches} != {want}")
    env = seen.get("env", {})
    if env.get("TPUJOB_MODEL_DIR") != mdir:
        failures.append(f"control[local]: TPUJOB_MODEL_DIR {env.get('TPUJOB_MODEL_DIR')!r}")
    m = seen.get("metrics", {})
    if (m.get("final_step") != CONTROL_LOCAL_STEPS
            or not math.isfinite(m.get("loss", float("nan")))):
        failures.append(f"control[local]: metrics {m}")
    ckpt = os.path.join(mdir, str(CONTROL_LOCAL_STEPS), "index.pt")
    if not os.path.exists(ckpt):
        failures.append(f"control[local]: no checkpoint at {ckpt}")
    rec["loss"] = m.get("loss")
    rec["checkpoint"] = os.path.exists(ckpt)
    log(f"control[local] {json.dumps(rec)} | {smi}")
    shutil.rmtree(mdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def _control_gang(smi, failures):
    """A ``Worker`` TPUJob on a ``v5p-8`` slice (two hosts, two pods):
    each pod's ``run_fn`` starts one rank with the pod's env, the
    coordinator's cluster-DNS address put on loopback (no cluster DNS
    here), gloo with both ranks on cuda:0. The flagship at 2 layers,
    fsdp=2: epoch 0 checkpoints at step 2 and exits 137; the controller
    gang-restarts; epoch 1's two ranks resume from step 2 and train to
    step 4."""
    import shutil

    from kubeflow_controller_tpu_torch.api.types import JobPhase
    from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
    from kubeflow_controller_tpu_torch.ops import _build
    from kubeflow_controller_tpu_torch.runtime import LocalRuntime
    from kubeflow_controller_tpu_torch.tpu import naming

    _build.load()                       # built before any rank starts
    out = os.path.join(OUT_DIR, "control", "gang")
    mdir = os.path.join(OUT_DIR, "control", "gang_ckpt")
    for d in (out, mdir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(out)
    ports = {}

    def run_fn(pod):
        epoch = int(pod.metadata.labels[naming.LABEL_EPOCH])
        pid = pod.spec.containers[0].env["JAX_PROCESS_ID"]
        port = ports.setdefault(epoch, _free_port())
        env = dict(os.environ)
        env.update(pod.spec.containers[0].env)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", PYTHONPATH=ROOT,
            PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
            CHIP_SMOKE_CONTROL=json.dumps({
                "epoch": epoch, "out": out,
                "steps": CONTROL_GANG_STEPS[min(epoch, 1)],
                "exit_code": 137 if epoch == 0 else 0}))
        p, f = _spawn_rank("_control_worker", env,
                           os.path.join(out, f"epoch{epoch}.rank{pid}.log"))
        try:
            return p.wait(timeout=CONTROL_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()

    # As for the Local job: the first ticks do not wait on the ranks, so
    # the controller sees the gang run; then each tick waits for them.
    policy = PodRunPolicy(start_delay=0, run_fn=run_fn, run_fn_join=0.0)
    rt = LocalRuntime(policy)
    rt.cluster.slice_pool.add_pool("v5p-8", 1)
    phases = []

    def job():
        j = rt.get_job("default", "gang")
        if j is not None and (not phases or phases[-1] != j.status.phase):
            phases.append(j.status.phase)
        return j

    t0 = time.perf_counter()
    try:
        rt.submit(_control_job("gang", mdir, accelerator_type="v5p-8"))
        rt.run_until(lambda: job().status.phase == JobPhase.RUNNING,
                     max_steps=5)
        policy.run_fn_join = CONTROL_TIMEOUT_S
        rt.run_until(lambda: job().is_done(), max_steps=20)
    finally:
        rt.stop()
    wall_s = time.perf_counter() - t0
    final = job()
    rec = _control_summary("gang", rt, final, phases, wall_s, smi)
    ranks = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                r = json.load(f)
            ranks[(r["epoch"], r["rank"])] = r
    rec["ranks"] = [ranks[k] for k in sorted(ranks)]
    log(f"control[gang] {json.dumps(rec)} | {smi}")
    if (final.status.phase != JobPhase.SUCCEEDED or final.status.restarts != 1
            or JobPhase.RUNNING not in phases):
        failures.append(f"control[gang]: phase {final.status.phase.value}, "
                        f"restarts {final.status.restarts}")
    if set(ranks) != {(0, 0), (0, 1), (1, 0), (1, 1)}:
        for name in sorted(os.listdir(out)):
            if name.endswith(".log"):
                with open(os.path.join(out, name)) as f:
                    log(f"control[gang] {name}:\n{f.read()[-4000:]}")
        failures.append(f"control[gang]: ranks reported {sorted(ranks)}")
    else:
        for (epoch, rank), r in ranks.items():
            want_from = 0 if epoch == 0 else CONTROL_GANG_STEPS[0]
            if (r["JAX_NUM_PROCESSES"] != "2" or r["world"] != 2
                    or r["resumed_from"] != want_from
                    or r["final_step"] != CONTROL_GANG_STEPS[epoch]
                    or not math.isfinite(r["loss"])):
                failures.append(f"control[gang]: epoch {epoch} rank {rank}: {r}")
        for epoch in (0, 1):
            if ranks[(epoch, 0)]["loss"] != ranks[(epoch, 1)]["loss"]:
                failures.append(f"control[gang]: epoch {epoch} losses differ: "
                                f"{ranks[(epoch, 0)]['loss']} vs {ranks[(epoch, 1)]['loss']}")
    shutil.rmtree(mdir, ignore_errors=True)
    return rec


#: The serving job of ``control_phase``'s ``serve_drain`` case (the path
#: of tests/test_chaos.py's TestServingChaosDrain at SERVE_CONFIG): 8
#: of the serve phase's prompts in 8 slots, epoch 0 with budgets of 512
#: tokens preempted once every request holds SERVE_DRAIN_MIN_TOKENS,
#: epoch 1 the same prompts at 32 tokens to completion.
SERVE_DRAIN_REQUESTS = 8
SERVE_DRAIN_BUDGET = 512
SERVE_DRAIN_MIN_TOKENS = 8
SERVE_DRAIN_EPOCH1_TOKENS = 32
SERVE_DRAIN_WAIT_S = 300


def _control_serve_drain(smi, failures):
    """A ``Worker`` TPUJob on a ``v5p-8`` pool of 2 whose gang index 0
    drives one ``ServingEngine`` on the card (``SERVE_CONFIG``, bucketed
    prefill, pages of 16, 8 slots, ``attn_impl="kernel"``); index 1 only
    waits. Epoch 0 submits 8 prompts of 256 tokens with budgets of 512,
    steps until every request holds SERVE_DRAIN_MIN_TOKENS decoded
    tokens, steps no more until the preemption's stop, then drains with
    no grace and exits 137. This thread preempts the job's slice, sets the
    stop and restores the slice; the controller gang-restarts (backoff
    base 0.2); epoch 1 waits for the drain, resets the engine and serves
    the 8 prompts at 32 tokens to completion. Checks: Succeeded after a
    restart; epoch 0 every rid once with a typed reason and between
    SERVE_DRAIN_MIN_TOKENS and the budget's tokens, each a prefix of a
    fresh one-engine twin's stream (run first, on the same engine
    options) or off only after a near-tie; epoch 1 every rid at
    ``length`` with 32 tokens, the twin's streams under the same rule;
    per epoch (counts zeroed just before, read just after) B6 = 8
    requests x 16 chunks x the layers, B5 = the engine's decode
    dispatches (from its tracer) x 4 x the layers, B1 none."""
    import collections
    import threading

    import torch

    from kubeflow_controller_tpu_torch.api.types import JobPhase
    from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.obs.trace import Tracer
    from kubeflow_controller_tpu_torch.runtime import LocalRuntime
    from kubeflow_controller_tpu_torch.tpu import naming

    t0 = time.perf_counter()
    label = "control[serve_drain]"
    cfg, params = _llama()
    n_layers = cfg.n_layers
    prompts = _serve_prompts(cfg.vocab_size, SERVE_DRAIN_REQUESTS)
    kw = dict(n_slots=8, max_seq=256 + SERVE_DRAIN_BUDGET, attn_impl="kernel")
    twin_eng, _, _, twin = _engine_run(f"{label}.twin", smi, list(enumerate(prompts)),
                                       max_new=SERVE_DRAIN_EPOCH1_TOKENS, **kw)
    del twin_eng
    tracer = Tracer()
    engine = ServingEngine(cfg, params, prefill_mode="bucketed", block_size=16,
                           tracer=tracer, device="cuda", **kw)
    stop, decoded, drained = threading.Event(), threading.Event(), threading.Event()
    partial, full, epochs, errors = [], [], {}, []

    def dispatches():
        return sum(1 for sp in tracer.snapshot()
                   if sp.name == "dispatch" and sp.track == "dataplane")

    def begin():
        torch.cuda.synchronize()
        _reset_serve_launches()
        return time.perf_counter(), dispatches()

    def end(epoch, started):
        torch.cuda.synchronize()
        epochs[epoch] = {"wall_s": time.perf_counter() - started[0],
                         "dispatches": dispatches() - started[1],
                         "launches": _serve_launches()}

    def mid_decode():
        live = [s for s in engine.slots if s is not None]
        return (not engine.queue and len(live) == SERVE_DRAIN_REQUESTS
                and all(len(s.tokens) >= SERVE_DRAIN_MIN_TOKENS for s in live))

    def run_serving(pod):
        epoch = pod.metadata.labels[naming.LABEL_EPOCH]
        if pod.metadata.labels[naming.LABEL_INDEX] != "0":
            if epoch == "0":
                stop.wait(SERVE_DRAIN_WAIT_S)
                return 137
            return 0
        torch.cuda.set_device(0)            # this thread's device
        try:
            if epoch == "0":
                engine.reset()
                started = begin()
                for i, p in enumerate(prompts):
                    engine.submit(Request(rid=i, prompt=p,
                                          max_new_tokens=SERVE_DRAIN_BUDGET))
                while not mid_decode() and not engine.idle:
                    partial.extend(engine.step())
                decoded.set()
                stop.wait(SERVE_DRAIN_WAIT_S)
                partial.extend(engine.drain(grace_s=0.0))
                end(0, started)
                return 137                  # the preempted container's exit
            if not drained.wait(SERVE_DRAIN_WAIT_S):
                raise RuntimeError("epoch 0 never drained")
            engine.reset()
            started = begin()
            full.extend(engine.run([
                Request(rid=i, prompt=p, max_new_tokens=SERVE_DRAIN_EPOCH1_TOKENS)
                for i, p in enumerate(prompts)]))
            end(1, started)
            return 0
        except BaseException as e:
            errors.append(f"epoch {epoch}: {type(e).__name__}: {e}")
            raise
        finally:
            if epoch == "0":
                decoded.set()
                drained.set()

    rt = LocalRuntime(PodRunPolicy(start_delay=1, run_fn=run_serving))
    rt.cluster.slice_pool.add_pool("v5p-8", 2)
    rt.controller.opts.restart_backoff_base = 0.2
    rt.controller.opts.backoff_poll = 0.005
    phases = []

    def job():
        j = rt.get_job("default", "serve-drain")
        if j is not None and (not phases or phases[-1] != j.status.phase):
            phases.append(j.status.phase)
        return j

    t_job = time.perf_counter()
    try:
        rt.submit(_control_job("serve-drain", "", accelerator_type="v5p-8"))
        if not rt.run_until(lambda: job().status.phase == JobPhase.RUNNING, max_steps=20):
            failures.append(f"{label}: not Running: {phases}")
        if not decoded.wait(SERVE_DRAIN_WAIT_S):
            failures.append(f"{label}: epoch 0 never reached mid-decode")
        held = rt.cluster.slice_pool.holdings(job().metadata.uid)[0].name
        rt.cluster.preempt_slice(held)
        stop.set()                          # the kubelet's SIGTERM to the pod
        rt.cluster.slice_pool.restore(held)
        rt.run_until(lambda: job().is_done(), max_steps=2000)
    finally:
        stop.set()
        rt.stop()
    wall_s = time.perf_counter() - t_job
    final = job()
    rec = _control_summary("serve_drain", rt, final, phases, wall_s, smi)
    failures.extend(f"{label}: {e}" for e in errors)
    if final.status.phase != JobPhase.SUCCEEDED or final.status.restarts < 1:
        failures.append(f"{label}: phase {final.status.phase.value}, restarts "
                        f"{final.status.restarts}")
    # Epoch 0: every rid once, typed, mid-decode when preempted.
    counts = collections.Counter(c.rid for c in partial)
    if sorted(counts) != list(range(SERVE_DRAIN_REQUESTS)) or set(counts.values()) != {1}:
        failures.append(f"{label}: epoch 0 returned rids {dict(counts)}")
    for c in partial:
        if (c.finish_reason not in ("deadline", "shed", "length")
                or not SERVE_DRAIN_MIN_TOKENS <= len(c.tokens) < SERVE_DRAIN_BUDGET):
            failures.append(f"{label}: epoch 0 rid {c.rid}: {c.finish_reason}, "
                            f"{len(c.tokens)} tokens")
    # Epoch 1: every rid to its budget, the twin's streams.
    got = {c.rid: list(map(int, c.tokens)) for c in full}
    if (sorted(got) != list(range(SERVE_DRAIN_REQUESTS))
            or any(c.finish_reason != "length" for c in full)):
        failures.append(f"{label}: epoch 1 returned "
                        f"{[(c.rid, c.finish_reason, len(c.tokens)) for c in full]}")
    else:
        try:
            _check_streams(f"{label}.epoch1", got, range(SERVE_DRAIN_REQUESTS),
                           SERVE_DRAIN_EPOCH1_TOKENS, cfg.vocab_size)
            _near_tie_streams(f"{label}.epoch1 vs twin", twin, got, prompts)
            # Each partial a prefix of the twin's stream, as far as both go.
            n = {c.rid: min(len(c.tokens), SERVE_DRAIN_EPOCH1_TOKENS) for c in partial}
            _near_tie_streams(f"{label}.epoch0 vs twin",
                              {r: twin[r][:k] for r, k in n.items()},
                              {c.rid: list(map(int, c.tokens[:n[c.rid]])) for c in partial},
                              prompts)
        except AssertionError as e:
            failures.append(str(e))
    for epoch in (0, 1):
        ep = epochs.get(epoch)
        if ep is None:
            failures.append(f"{label}: epoch {epoch} did not run to its end")
            continue
        launches = ep["launches"]
        want = {k: 0 for k in launches}
        want.update(paged_chunk=SERVE_DRAIN_REQUESTS * 16 * n_layers,
                    paged_decode=ep["dispatches"] * 4 * n_layers)
        log(f"{label} epoch {epoch}: {ep['wall_s']:.2f} s, decode dispatches "
            f"{ep['dispatches']}, launches { {k: v for k, v in launches.items() if v} } "
            f"(want paged_chunk {want['paged_chunk']}, paged_decode "
            f"{ep['dispatches']} x 4 x {n_layers} = {want['paged_decode']}) | {smi}")
        if launches != want:
            failures.append(f"{label}: epoch {epoch} launches {launches} != {want}")
    rec["epochs"] = [{k: epochs[e][k] for k in ("wall_s", "dispatches")}
                     for e in sorted(epochs)]
    rec["epoch_launches"] = [epochs[e]["launches"] for e in sorted(epochs)]
    rec["launches"] = {k: sum(ep["launches"][k] for ep in epochs.values())
                       for k in _serve_launches()}
    rec["partials"] = sorted((c.rid, c.finish_reason, len(c.tokens)) for c in partial)
    rec["case_s"] = time.perf_counter() - t0
    log(f"{label} {json.dumps(rec)} | {smi}")
    del engine
    _drop_llama()
    return rec


def _train_launches_want(launches, config, steps):
    """The flash kernels' launches of ``steps`` steps of ``config`` (B16
    S1024, the fused backward): per layer and step rope_rotate 3,
    flash_fwd 2, flash_bwd_prep/fused/post 1 each; every other 0."""
    layers = _case_config(config).n_layers
    want = {k: 0 for k in launches}
    want.update({"rope_rotate": 3 * layers, "flash_fwd": 2 * layers,
                 "flash_bwd_prep": layers, "flash_bwd_fused": layers,
                 "flash_bwd_post": layers})
    return {k: v * steps for k, v in want.items()}


def _get_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _control_remote(smi, failures, label):
    """``label`` in CONTROL_REMOTE: a TPUJob reconciled only over HTTP.
    The port's ``RestServer`` (``k8s_mode`` for ``remote.k8s``) serves a
    ``FakeCluster(use_native_index=True)``, ticked by a wall-clock thread
    as ``tpujobctl apiserver`` does; a ``RemoteRuntime`` with 2 workers
    (the ``tpujobctl serve --cluster-url`` topology) reconciles it; the
    job is created through the runtime's wire client. Its pod's
    ``run_fn`` trains with ``lm.train(ProcessContext.from_env(pod env))``
    once the job was seen Running (as the Local job's does). Checked:
    Pending -> Running -> Succeeded within CONTROL_REMOTE_TIMEOUT_S, the
    injected ``TPUJOB_MODEL_DIR`` and the checkpoint there, the flash
    launches of the steps, the C++ queue, expectations and index, and
    (k8s) the job's Events read back from the apiserver as core/v1
    Events."""
    import shutil
    import threading

    import torch

    from kubeflow_controller_tpu_torch.api.types import JobPhase
    from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster, PodRunPolicy
    from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
    from kubeflow_controller_tpu_torch.dataplane import dist as ddist
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
    from kubeflow_controller_tpu_torch.native.objindex import NativeObjectIndex
    from kubeflow_controller_tpu_torch.native.queue import (
        NativeControllerExpectations, NativeRateLimitingQueue,
    )
    from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

    k8s = label == "remote.k8s"
    config, steps = CONTROL_REMOTE[label]
    name = label.replace(".", "-")
    mdir = os.path.join(OUT_DIR, "control", f"{name}_ckpt")
    shutil.rmtree(mdir, ignore_errors=True)
    go, seen = threading.Event(), {}

    def run_fn(pod):
        env = dict(pod.spec.containers[0].env)
        seen["env"] = env
        torch.cuda.set_device(0)            # this thread's device
        if not go.wait(CONTROL_REMOTE_TIMEOUT_S):
            return 1
        try:
            seen["metrics"] = lm.train(
                ProcessContext.from_env(env), config=config, total_steps=steps,
                per_data_shard_batch=16, seq_len=1024)
            torch.cuda.synchronize()
        finally:
            ddist.destroy()
        return 0

    # A use_native_index=True cluster raises if the C++ core does not
    # build or load: the phase fails, it does not run the Python index.
    # Its pods start CONTROL_REMOTE_START_S after they are scheduled, so
    # the job stays Pending long enough for the wire poll to see it.
    cluster = FakeCluster(default_policy=PodRunPolicy(
        start_delay=CONTROL_REMOTE_START_S, run_fn=run_fn, run_fn_join=0.0),
        use_native_index=True)
    server = RestServer(cluster, k8s_mode=k8s).start()
    stop = threading.Event()

    def ticker():
        while not stop.wait(0.05):
            cluster.tick(0.05)

    tick = threading.Thread(target=ticker, daemon=True, name="ticker")
    rt = RemoteRuntime(server.url, token="chip-smoke-token" if k8s else "", k8s=k8s)
    phases = []

    def job():
        j = rt.client.get_job("default", name)
        if j is not None and (not phases or phases[-1] != j.status.phase):
            phases.append(j.status.phase)
        return j

    def wait(pred, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return False

    t0 = time.perf_counter()
    _reset_launches()
    events = {}
    try:
        tick.start()
        rt.start(workers=2)
        rt.client.create_job(_control_job(name, mdir))
        if not wait(lambda: (j := job()) is not None
                    and j.status.phase == JobPhase.RUNNING, 60):
            failures.append(f"control[{label}]: not Running: {phases}")
        go.set()
        if not wait(lambda: (j := job()) is not None and j.is_done(),
                    CONTROL_REMOTE_TIMEOUT_S):
            failures.append(f"control[{label}]: not done within "
                            f"{CONTROL_REMOTE_TIMEOUT_S} s: {phases}")
        final = job()
        if k8s:
            events = _get_json(f"{server.url}/api/v1/namespaces/default/events")
        native = {"queue": type(rt.controller.queue).__name__,
                  "expectations": type(rt.controller.expectations).__name__,
                  "index": type(cluster.native_index).__name__}
        native_ok = (isinstance(rt.controller.queue, NativeRateLimitingQueue)
                     and isinstance(rt.controller.expectations,
                                    NativeControllerExpectations)
                     and isinstance(cluster.native_index, NativeObjectIndex))
    finally:
        go.set()
        rt.stop()
        stop.set()
        tick.join(timeout=CONTROL_REMOTE_TIMEOUT_S)
        server.stop()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    rec = _control_summary(label, rt, final, phases, wall_s, smi)
    want = _train_launches_want(launches, config, steps)
    rec.update(launches=launches, config=config, steps=steps, native=native,
               layers=_case_config(config).n_layers)
    if [p.value for p in phases if p.value] != ["Pending", "Running", "Succeeded"]:
        failures.append(f"control[{label}]: phases {[p.value for p in phases]}")
    if launches != want:
        failures.append(f"control[{label}]: launches {launches} != {want}")
    if not native_ok:
        failures.append(f"control[{label}]: not the C++ core: {native}")
    env = seen.get("env", {})
    if env.get("TPUJOB_MODEL_DIR") != mdir:
        failures.append(f"control[{label}]: TPUJOB_MODEL_DIR "
                        f"{env.get('TPUJOB_MODEL_DIR')!r}")
    m = seen.get("metrics", {})
    if (m.get("final_step") != steps
            or not math.isfinite(m.get("loss", float("nan")))):
        failures.append(f"control[{label}]: metrics {m}")
    ckpt = os.path.join(mdir, str(steps), "index.pt")
    if not os.path.exists(ckpt):
        failures.append(f"control[{label}]: no checkpoint at {ckpt}")
    if k8s:
        items = events.get("items", [])
        mine = [e for e in items if (e.get("involvedObject") or {}).get("name", "")
                .startswith(name)]
        bad = [e for e in items if e.get("apiVersion") != "v1"
               or e.get("kind") != "Event" or not e.get("reason")
               or not (e.get("metadata") or {}).get("name")]
        rec["events"] = sorted({(e["involvedObject"]["kind"], e["reason"])
                                for e in mine})
        if events.get("kind") != "EventList" or not mine or bad:
            failures.append(f"control[{label}]: events {events}")
    rec["loss"] = m.get("loss")
    rec["checkpoint"] = os.path.exists(ckpt)
    log(f"control[{label}] {json.dumps(rec)} | {smi}")
    shutil.rmtree(mdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def control_phase(smi):
    """The port's control plane (``runtime.LocalRuntime`` -> ``Controller``
    -> ``FakeCluster`` gang admission -> ``run_fn``) launching the port's
    trainer on the card: the flagship ``Local`` job; the same over the
    wire (``remote.k8s``: the strict Kubernetes wire, ``remote.rest``: the
    framework wire, each a ``RemoteRuntime`` against a ``RestServer``);
    then the two-host gang through a failure restart. Every check of every
    run; any that fails fails the phase."""
    failures = []
    t0 = time.perf_counter()
    runs = {"local": _control_local(smi, failures)}
    for label in CONTROL_REMOTE:
        runs[label] = _control_remote(smi, failures, label)
    runs["gang"] = _control_gang(smi, failures)
    runs["serve_drain"] = _control_serve_drain(smi, failures)
    log(f"control: {time.perf_counter() - t0:.1f} s | {smi}")
    if failures:
        for msg in failures:
            log(msg)
        raise AssertionError(f"control: {len(failures)} checks failed; "
                             f"first: {failures[0]}")
    return runs


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

    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "log.txt"), "w").close()
    # The memory gate's traces run on the host's cores beside the phases
    # before its own.
    aot = aot_start()
    try:
        return _phases(aot)
    finally:
        if aot[0].poll() is None:
            aot[0].kill()
            aot[0].wait()


def _phases(aot) -> int:
    """Every phase in order, then the kernels line and the last line."""
    import torch

    t0 = time.perf_counter()

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    _register_cut_configs()
    smi = phase("device", device_phase)
    recs = phase("paged kernels", kernel_phase)
    phase("two streams", two_stream_check)
    flash_recs = phase("flash kernels", flash_kernel_phase, smi)
    int8_recs = phase("int8 kernel", int8_kernel_phase, smi)
    runs = phase("serve", serve_phase, smi)
    int8_runs = phase("int8 serve", int8_serve_phase, smi, runs)
    moe_runs = phase("moe", moe_phase, smi)
    prefix_runs = phase("prefix", prefix_phase, smi)
    fleet_runs = phase("fleet", fleet_phase, smi)
    slot_runs = phase("slot path", slot_path_check, smi)
    forward_launches = phase("logits", logits_phase)
    train_runs = phase("train", train_phase, smi)
    phase("checkpoint", checkpoint_phase, smi)
    control_runs = phase("control", control_phase, smi)
    model_runs = phase("models", models_phase, smi)
    dist_runs = phase("dist", dist_phase, smi)
    tp_runs = phase("tp serve", tp_serve_phase, smi, runs)
    phase("aot", aot_phase, smi, aot)
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
        # Each sampling run's launches of this kernel, counted from zero
        # just before the run.
        line["kernels"][-1]["sampling_runs_launches"] = {
            run: runs[run][1][name] for run in
            ("sampled", "forks", "spec.sampled.oracle", "grammar")}
        # Each prefix-cache run's launches (prefix cache off and on, the
        # host tier off and on, int8, multi-turn, radix drafts).
        line["kernels"][-1]["prefix_runs_launches"] = {
            run: rec[1][name] for run, rec in prefix_runs.items()}
        # Each fleet run's launches (disaggregated traced, untraced and
        # int8, the one-engine twin, chaos, the rolling restart, the
        # prefix pull).
        line["kernels"][-1]["fleet_runs_launches"] = {
            run: rec[1][name] for run, rec in fleet_runs.items()}
        # The control plane's runs: the LMService's pods synced into a
        # fleet and served (fleet_phase's lmservice), and the preempted
        # serving job's two epochs (control_phase's serve_drain).
        line["kernels"][-1]["control_runs_launches"] = {
            "lmservice": fleet_runs["lmservice"][1][name],
            "serve_drain": [ep[name] for ep in control_runs["serve_drain"]["epoch_launches"]]}
        # The paged engine beside the slot path (slot_path_check).
        line["kernels"][-1]["slot_check_launches"] = slot_runs["paged"][name]
        # The weight-only int8 runs' launches (exact, bucketed with lookup
        # speculation, int8 KV).
        line["kernels"][-1]["int8_serve_launches"] = {
            run: rec[1][name] for run, rec in int8_runs.items()}
        # The mixtral_8x7b serve runs' launches (int8 weights).
        line["kernels"][-1]["moe_runs_launches"] = {
            run: rec[1][name] for run, rec in moe_runs.items()
            if isinstance(rec, tuple)}
        # One tp rank's share (tp=2: 4 of 8 KV heads) at llama3_8b's and
        # llama3_70b's serve shapes, and each rank's launches in each case
        # of the tp gang.
        tp_case = {"paged_decode": "decode", "paged_chunk": "prefill"}[name]
        line["kernels"][-1]["tp2"] = {
            shape: {k: recs[shape][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "parts")}
            for shape in (f"{tp_case}.bf16.tp2", f"{tp_case}.bf16.70b.tp2")}
        line["kernels"][-1]["tp_launches_per_rank"] = {
            label: [rec["launches"][name] for rec in rs]
            for label, rs in tp_runs.items() if "launches" in rs[0]}
        if name == "paged_chunk":
            # B6's verify entry: its launches on the speculative serve run
            # (one per layer per verify step) and its record at that
            # run's shape.
            v = recs["verify.bf16.serve"]
            line["kernels"][-1]["verify"] = {
                "launches": runs["spec"][1]["paged_chunk"],
                "shape": "verify.bf16.serve",
                **{k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "parts",
                                     "device_ms_by_kernel")}}
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
        if name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            # The MoE runs' launches: B1 in the mixtral serve runs' exact
            # prefill and in training; B3 and B4 in training (S=2048).
            line["kernels"][-1]["moe_runs_launches"] = {
                run: (rec[1] if isinstance(rec, tuple) else rec["launches"])[name]
                for run, rec in moe_runs.items()}
        if name in ("flash_fwd", "flash_bwd_fused"):
            # B1 and B2 in the control phase's runs: the Local job, and
            # the jobs reconciled over the strict Kubernetes wire and the
            # framework wire (the gang's ranks count in their processes).
            line["kernels"][-1]["control_runs_launches"] = {
                run: rec["launches"][name] for run, rec in control_runs.items()
                if "launches" in rec}
            # B1 and B2 under BERT-base (S=512, not causal, segment ids, no
            # rope): the entry point's launches, and the record at its
            # attention shape.
            line["kernels"][-1]["bert_runs_launches"] = {
                model_runs["bert"]["run"]: model_runs["bert"]["launches"][name]}
            b = flash_recs[(name, "bert_base")]
            line["kernels"][-1]["bert_base"] = {
                "shape": "bert_base", **{k: b[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "parts") if k in b}}
        if name == "flash_fwd":
            # B1 in transformer.forward over llama3_8b's 257 tokens (all
            # 32 layers): once a layer.
            line["kernels"][-1]["forward_launches"] = forward_launches["flash_fwd"]
            # B1 in the tp gang: exact admissions, every head (gathered)
            # or a rank's head group (parallel), a rank.
            line["kernels"][-1]["tp_launches_per_rank"] = {
                label: [rec["launches"]["flash_fwd"] for rec in rs]
                for label, rs in tp_runs.items() if "launches" in rs[0]}
            line["kernels"][-1]["sampling_runs_launches"] = {
                run: runs[run][1][name] for run in
                ("sampled", "forks", "spec.sampled.oracle", "grammar")}
            # B1 on the contiguous multi-turn path: turn 1's prefill.
            line["kernels"][-1]["prefix_runs_launches"] = {
                run: rec[1][name] for run, rec in prefix_runs.items()}
            line["kernels"][-1]["int8_serve_launches"] = {
                run: rec[1][name] for run, rec in int8_runs.items()}
            # B1 on the serving path: exact prefill, once per layer per
            # admission of the exact llama3_8b serve run, and its record
            # at that run's shape.
            p = flash_recs[(name, "llama3_8b.prefill")]
            line["kernels"][-1]["serve_exact"] = {
                "launches": runs["exact"][1]["flash_fwd"],
                "shape": "llama3_8b.prefill",
                **{k: p[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "parts",
                                     "device_ms_by_kernel")}}
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
        # The split entries (row scales from the caller, fp32 partials out)
        # at the flagship's tp=2 shapes, and their launches a rank a step
        # in the gang's layouts.
        "split_entry": {label: {k: int8_recs[label][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "prepass_ms", "parts")} for label in INT8_SPLIT_SHAPES},
        "split_entry_dist_launches_per_rank_step": {
            label: [rec["launches_per_step"].get("int8_matmul_f32", 0) for rec in recs]
            for label, recs in dist_runs.items()},
    })
    # Each rank's launches a step in the gang's layouts (dist_phase).
    for k in line["kernels"]:
        if k["name"] in _launches():
            k["dist_launches_per_rank_step"] = {
                label: [rec["launches_per_step"].get(k["name"], 0) for rec in recs]
                for label, recs in dist_runs.items()}
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
