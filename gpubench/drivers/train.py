"""Training: one ``TrainLoop`` (the model, its fp32 master weights and
AdamW's state) built on the benchmark's weights, driven from the seed
through its first steps in set-up (which warm every shape: each step's
batch has the same layout), then stepped for the window. Each step's
batch is new tokens over the run's packed-document layout, drawn on the
device; its loss is read on the host, so a step counts once it is
done. The first steps' losses, the first gradient as AdamW holds it and
the weights' change are checked against the plain reference's steps
from the same weights and batches."""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np
import torch

from gpubench.harness import serving as sv
from gpubench.harness import traffic as tr
from gpubench.harness import weights as wts
from gpubench.harness.context import Ctx, Outcome
from gpubench.harness.profiling import Slice, span
from gpubench.harness.records import Records
from gpubench.reference import decoder as ref

clock = time.perf_counter


def batch_fn(ctx: Ctx, segs: torch.Tensor):
    """Step ``k``'s batch: tokens from a generator of the step's own
    seed, the run's segment layout."""
    rows, width = segs.shape
    vocab = ctx.port["vocab_size"]

    def batch(k: int) -> Dict[str, torch.Tensor]:
        state = np.random.SeedSequence([int(ctx.seed) % 2 ** 64, 202, k])
        g = torch.Generator(device=ctx.device)
        g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        tok = torch.randint(0, vocab, (rows, width), generator=g, device=ctx.device,
                            dtype=torch.int64)
        return {"tokens": tok, "segment_ids": segs}

    return batch


#: Elements of a leaf whose first gradient is compared element by element
#: (a larger leaf is sampled, the same elements on both sides).
GRAD_SAMPLE = 1 << 22


def grad_sample(ctx: Ctx, name: str, numel: int):
    """The flat indices of leaf ``name`` whose first gradient is compared:
    all of a small leaf, else ``GRAD_SAMPLE`` drawn from the seed."""
    if numel <= GRAD_SAMPLE:
        return None
    state = np.random.SeedSequence([int(ctx.seed) % 2 ** 64, 303, wts.LEAVES.index(name)])
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.randint(0, numel, (GRAD_SAMPLE,), generator=g, device=ctx.device)


def _take(t: torch.Tensor, idx) -> torch.Tensor:
    flat = t.detach().reshape(-1)
    return (flat if idx is None else flat[idx]).float().cpu()


def grad_gap(prog: Dict[str, torch.Tensor], refg: Dict[str, torch.Tensor],
             numel: Dict[str, int], refn: Dict[str, float], keep) -> float:
    """The worst leaf's distance between the program's first gradient and
    the reference's, element by element (the L2 norm of the difference,
    over the compared elements and scaled up to the whole leaf), against
    the larger of that leaf's reference norm and the median leaf's."""
    med = statistics.median(refn[k] for k in keep)
    out = 0.0
    for k in keep:
        d = float((prog[k] - refg[k]).norm()) * (numel[k] / refg[k].numel()) ** 0.5
        out = max(out, d / max(refn[k], med))
    return out


def _gap(prog: Dict[str, float], refn: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    keys = [k for k in refn if keep is None or k in keep]
    med = statistics.median(refn[k] for k in keys)
    return max(abs(prog[k] - refn[k]) / max(refn[k], med) for k in keys)


def run(ctx: Ctx) -> Outcome:
    from kubeflow_controller_tpu_torch import optim
    from kubeflow_controller_tpu_torch.dataplane.train import TrainLoop, TrainLoopConfig
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    wl = ctx.cell.workload
    rows, seq = wl["batch"]["rows"], wl["batch"]["seq_len"]
    o = wl["optimizer"]
    n_ref = int(wl["reference_steps"])
    if ctx.control not in ("", "program_int8"):
        raise ValueError(f"training has no control {ctx.control!r}")
    quant = {"quant": "int8"} if ctx.control == "program_int8" else {}
    tcfg = tfm.TransformerConfig(**ctx.port, dtype=ctx.dtype, param_dtype=torch.float32,
                                 **wl["model"], **quant)
    layout = tr.packed_layout(ctx.cell.traffic, rows, seq, ctx.seed)
    docs = [tr.doc_lengths(r[:-1]) for r in layout]
    segs = torch.from_numpy(layout).to(ctx.device)
    batch = batch_fn(ctx, segs)
    opt = optim.AdamW(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"])
    loop = TrainLoop(lambda seed, device: wts.make(ctx.port, seed, device, torch.float32),
                     tfm.make_loss_fn(tcfg), opt,
                     TrainLoopConfig(total_steps=1 << 30, log_every=1 << 30),
                     seed=ctx.seed, device=ctx.device)
    leaves = wts.flat(loop.state.params)
    numel = {n: p.numel() for n, p in leaves.items()}
    prog: Dict = {"losses": []}
    for k in range(n_ref):
        prog["losses"].append(float(loop.step(batch(k))["loss"]))
        if k == 0:
            # m_1 = (1 - b1) g_1: the gradient as AdamW took it (a leaf it
            # never stepped holds no moment and reads 0)
            m1 = {n: opt.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                  for n, p in leaves.items()}
            prog["grad_norms"] = {n: float(m.norm()) / (1 - o["b1"]) for n, m in m1.items()}
            prog["grads"] = {n: _take(m, grad_sample(ctx, n, numel[n])) / (1 - o["b1"])
                             for n, m in m1.items()}
            del m1
    with torch.no_grad():
        prog["change_norms"] = {
            n: float((p - wts.leaf(ctx.port, n, ctx.seed, ctx.device, torch.float32)).norm())
            for n, p in leaves.items()}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    traced = ctx.trace
    if traced:
        Slice.warm()
    sl = Slice()
    ts = min(float(wl.get("trace_slice_s", 5)), ctx.seconds)
    s_from = (ctx.seconds - ts) / 2
    steps, slice_steps = 0, 0
    k = n_ref
    sv.settle()
    setup_s = clock() - ctx.t_start
    t0 = clock()
    while True:
        if traced and not sl.stopped and sl.prof is None and clock() >= t0 + s_from:
            sl.start()
        with span("batch.next", traced):
            b = batch(k)
        with span("train.step", traced):
            loss = loop.step(b)["loss"]
        float(loss)
        k += 1
        steps += 1
        slice_steps += sl.active
        if traced and sl.active and clock() >= t0 + s_from + ts:
            sl.stop()
        if clock() - t0 >= ctx.seconds:
            break
    elapsed = clock() - t0
    if sl.active:
        sl.stop()
    peak = sv.memory_peak()
    del loop, opt, leaves, b, loss
    sv.free()

    trace = sl.finish()
    t_ref = clock()
    w = wts.flat(wts.make(ctx.port, ctx.seed, ctx.device, torch.float32))
    ref_grads: Dict[str, torch.Tensor] = {}

    def first_grad(n: str, g: torch.Tensor) -> None:
        ref_grads[n] = _take(g, grad_sample(ctx, n, numel[n]))

    with ref.exact_fp32():
        r = ref.train_steps(ctx.port, w, batch, n_ref, o, first_grad=first_grad)
    with torch.no_grad():
        r["change_norms"] = {
            n: float((p - wts.leaf(ctx.port, n, ctx.seed, ctx.device, torch.float32)).norm())
            for n, p in w.items()}
    del w
    sv.free()
    ref_s = clock() - t_ref
    med = statistics.median(r["grad_norms"].values())
    moved = {n for n, g in r["grad_norms"].items() if g >= 1e-3 * med}
    checks = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], r["losses"])),
        "grad_norm_gap": _gap(prog["grad_norms"], r["grad_norms"]),
        "grad_gap": grad_gap(prog["grads"], ref_grads, numel, r["grad_norms"], moved),
        "change_norm_gap": _gap(prog["change_norms"], r["change_norms"], moved),
    }
    records = Records(cell=ctx.cell.name, port=ctx.port, peaks={}, window_s=elapsed,
                      trace=trace,
                      train={"rows": rows, "seq_len": seq, "docs": docs,
                             "slice_steps": slice_steps, "peak_bytes": peak})
    return Outcome(e2e={"train_samples_per_s": steps * rows / elapsed},
                   records=records, attempted=steps, failed=0, checks=checks,
                   memory_peak_bytes=peak, setup_s=setup_s,
                   extra={"steps": steps, "reference_s": ref_s, "losses": prog["losses"],
                          "reference_losses": r["losses"]})
