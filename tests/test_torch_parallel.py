"""Multi-process training of the port over a dp/fsdp/sp/tp/pp mesh against
the JAX package's ``TrainLoop`` on the same ``MeshConfig``.

One gang of four gloo processes (:func:`_worker_main`, started once for
the module) runs every case in turn; a case of two ranks runs beside
another on the other two. Each reads the same weights and global
batches (numpy, made here from seeds) and writes its per-step records
and its gathered parameters. Meanwhile this process runs the JAX loop
on a sub-mesh of the 8 virtual CPU devices (``tests/conftest.py``) of
the case's shape. Each test then holds one case to its reference:

* the tiny decoder (fp32) at dp=4, dp=2 x fsdp=2, fsdp=2 x tp=2 and
  tp=2, three AdamW steps (lr 1e-2, zero on the first): the loss at
  every step within ``LOSS_RTOL`` and every parameter after step 3
  within ``PARAM_ATOL`` — 4x the one-process parity test's
  (``test_torch_train.py::test_three_adamw_steps_match_optax``);
* the same decoder at tp=2 and fsdp=2 x tp=2 under plain SGD, where a
  parameter's change is its summed gradient (AdamW's step hardly moves
  when a gradient is scaled, so this is what catches a tp reduction
  that counts a replicated leaf's gradient twice or not at all): each
  change within 4x the one-process gradient bounds;
* ``lm.train`` on a token-bin corpus at dp=2 x tp=2 over the whole
  gang: the two tp ranks of a data shard train on the same rows (the
  stream of the shard's first rank), and the loss and parameters equal
  the JAX loop's on the global batch those streams make;
* ``quant="int8"`` at fsdp=2, three steps of plain SGD (so that each
  parameter's change is its summed gradient): the loss within 4x the
  one-process int8 bound (``test_torch_quant.py``) and each change within
  4x its gradient bound (relative L2: an int8 rounding that flips
  between the frameworks moves a gradient element by a quantum);
* MNIST at dp=2 (with evaluation), ResNet at dp=2 with grad_accum=2
  (BatchNorm's running statistics too), tiny_moe at fsdp=2 (SGD) and
  BERT at fsdp=2 (padded rows, so the ranks' masked counts differ), each
  within 4x its one-process test's bounds;
* a checkpoint written at fsdp=2 restores in one process to the
  gathered parameters exactly, resumes at dp=2 to where the JAX loop's
  uninterrupted fsdp=2 run ends, and serves with ``serve(model_dir=)``;
* the mesh as a ``DeviceMesh``, and DTensors built from each rank's
  chunks by ``placements`` equal to the whole tensors; the chunked loss
  under tp equal to the whole-sequence one;
* ``ring_mha`` at sp=4 (causal and not, GQA, segment ids, gradients)
  and at sp=2 x tp=2 against the JAX package's on the same mesh, at
  ``tests/test_ring.py``'s tolerances;
* ``gpipe`` at pp=2: identity stages keep the batch order, each stage's
  offset is added once, the batch must divide;
* the decoder (4 layers) at sp=2 with ring and with gathered attention
  (packed rows), and at pp=2 x tp=2 with 4 microbatches (plain and
  packed): its hidden state, loss and every leaf's gradient (one SGD
  step at lr 1 from the same weights) against the JAX package's on the
  same mesh and without one, at ``tests/test_pipeline.py``'s tolerances;
  int8 projections at pp=2 x fsdp=2 within the int8 bounds;
* three AdamW steps of ``TrainLoop`` at sp=2 with ring attention and at
  pp=2 x tp=2 against the JAX loop on the same ``MeshConfig``; the
  pp=2 x tp=2 run's checkpoint restores bit for bit in one process.
"""

import itertools
import json
import math
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu_torch import convert, optim
from kubeflow_controller_tpu_torch.dataplane import train as ttrain
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

LR = 1e-2
LOSS_RTOL = 4e-5                 # 4 x LOSS_RTOL of test_torch_train.py
PARAM_ATOL = 4 * LR / 1000       # 4 x its lr / 1000
INT8_LOSS_RTOL = 4 * 3e-4        # 4 x QUANT_TOL[fp32]["loss"] of test_torch_quant.py
INT8_LEAF_REL = 4 * 5e-2         # 4 x QUANT_TOL[fp32]["leaf"]
SGD_LR = 0.1
# MoE: test_torch_moe.py holds the one-process loss and every gradient
# within 1e-4; three SGD steps move a parameter by 3 lr times its
# gradient, so 4x that bound is 4 * 3 * SGD_LR * 1e-4.
MOE_LOSS_ATOL = 4e-4
MOE_PARAM_ATOL = 4 * 3 * SGD_LR * 1e-4
MNIST_RTOL = 4e-4                # 4 x test_eval_every_matches_jax_loop's 1e-4
RESNET_RTOL = 4e-4               # 4 x test_stateful_loop_..._matches_jax_loop's 1e-4
# SGD: test_torch_train.py holds each one-process gradient within
# rtol 1e-4 and atol 1e-5 of its leaf's largest element.
SGD_CHANGE_RTOL, SGD_CHANGE_ATOL_OF_MAX = 4 * 1e-4, 4 * 1e-5
B, S = 8, 32                     # the decoder's global batch and sequence
# tests/test_ring.py's and tests/test_pipeline.py's tolerances.
RING_ATOL, RING_GRAD_ATOL, RING_DECODER_ATOL = 2e-5, 5e-4, 2e-4
PIPE_FWD = dict(atol=2e-5, rtol=1e-5)
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD = dict(atol=3e-4, rtol=2e-3)
PP_M = 4                         # the pipeline's microbatches

# name -> (model, mesh config, ranks of the gang, extra)
CASES = {
    "dec_dp4": ("decoder", dict(dp=4), [0, 1, 2, 3], {}),
    "dec_dp2_fsdp2": ("decoder", dict(dp=2, fsdp=2), [0, 1, 2, 3], {}),
    "dec_fsdp2_tp2": ("decoder", dict(dp=1, fsdp=2, tp=2), [0, 1, 2, 3], {}),
    "dec_tp2": ("decoder", dict(dp=1, tp=2), [0, 1], {}),
    "dec_tp2_sgd": ("decoder", dict(dp=1, tp=2), [0, 1], {"sgd": True}),
    "dec_fsdp2_tp2_sgd": ("decoder", dict(dp=1, fsdp=2, tp=2), [0, 1, 2, 3], {"sgd": True}),
    "corpus_dp2_tp2": ("corpus", dict(dp=2, tp=2), [0, 1, 2, 3], {}),
    "dec_int8_fsdp2": ("decoder", dict(dp=1, fsdp=2), [2, 3], {"quant": "int8"}),
    "mnist_dp2": ("mnist", dict(dp=2), [0, 1], {}),
    "resnet_dp2": ("resnet", dict(dp=2), [2, 3], {}),
    "bert_fsdp2": ("bert", dict(dp=1, fsdp=2), [0, 1], {}),
    "moe_fsdp2": ("decoder", dict(dp=1, fsdp=2), [2, 3], {"config": "tiny_moe"}),
    "ckpt": ("ckpt", dict(dp=1, fsdp=2), [2, 3], {}),
    "ring_sp4": ("ring", dict(dp=1, sp=4), [0, 1, 2, 3], {}),
    "ring_sp2_tp2": ("ring", dict(dp=1, sp=2, tp=2), [0, 1, 2, 3], {}),
    "gpipe_pp2": ("gpipe", dict(pp=2, dp=1), [2, 3], {}),
    "grad_sp2_ring": ("grad", dict(dp=1, sp=2), [0, 1], {"attn": "ring", "pack": True}),
    "grad_sp2_gather": ("grad", dict(dp=1, sp=2), [2, 3], {"shard_seq": True, "pack": True}),
    "grad_pp2_tp2": ("grad", dict(pp=2, dp=1, tp=2), [0, 1, 2, 3], {"pp": PP_M}),
    "grad_pp2_tp2_packed": ("grad", dict(pp=2, dp=1, tp=2), [0, 1, 2, 3],
                            {"pp": PP_M, "pack": True}),
    "grad_int8_pp2_fsdp2": ("grad", dict(pp=2, dp=1, fsdp=2), [0, 1, 2, 3],
                            {"pp": PP_M, "quant": "int8", "remat": True}),
    "dec_sp2_ring": ("decoder", dict(dp=1, sp=2), [0, 1], {"attn": "ring"}),
    "dec_pp2_tp2": ("decoder", dict(pp=2, dp=1, tp=2), [0, 1, 2, 3], {"pp": PP_M}),
    "c11_fsdp2_tp2": ("c11", dict(dp=1, fsdp=2, tp=2), [0, 1, 2, 3], {}),
}
# Cases that run side by side (disjoint ranks), in order.
PHASES = [["dec_dp4"], ["dec_dp2_fsdp2"], ["dec_fsdp2_tp2"],
          ["dec_tp2", "dec_int8_fsdp2"], ["mnist_dp2", "resnet_dp2"],
          ["bert_fsdp2", "moe_fsdp2"], ["dec_tp2_sgd", "ckpt"], ["dec_fsdp2_tp2_sgd"],
          ["corpus_dp2_tp2"], ["ring_sp4"], ["ring_sp2_tp2"],
          ["grad_sp2_ring", "grad_sp2_gather"], ["grad_pp2_tp2"], ["grad_pp2_tp2_packed"],
          ["grad_int8_pp2_fsdp2"], ["dec_sp2_ring", "gpipe_pp2"], ["dec_pp2_tp2"],
          ["c11_fsdp2_tp2"]]


# -- the gang (no JAX here: the workers import this module) ---------------------

def _records(loop, batches, global_batch):
    seen = []
    data = ttrain.device_prefetch(iter(batches), "cpu",
                                  rows=loop.local_rows(global_batch))
    loop.run(data, on_metrics=lambda m: seen.append((m.step, m.loss, dict(m.extras))))
    return seen


def whole_state(loop):
    """``loop``'s whole parameters and optimizer state (gathered from
    every rank's chunks over its mesh), detached: what a one-device run
    of the same steps holds."""
    from kubeflow_controller_tpu_torch.parallel import sharding

    leaves = convert.tree_leaves(loop.state.params)
    opt = loop.tx.state_dict()
    if not loop.distributed:
        return convert.tree_unflatten(loop.state.params, [p.detach() for p in leaves]), opt
    params = convert.tree_unflatten(loop.state.params, [
        sharding.gather_full(p.detach(), s, loop.mesh) for p, s in zip(leaves, loop._specs)])
    return params, ttrain.with_opt_tensors(opt, {
        key: sharding.gather_full(t, spec, loop.mesh)
        for key, spec, t in loop.optimizer_chunks()})


def _whole(loop):
    params, _ = whole_state(loop)
    return convert.params_to_numpy(params)


def _decoder_loop(inp, mesh, quant="", config="tiny", total=3, model_dir="", sgd=False,
                  attn="auto", pp=0):
    """The decoder's loop: AdamW under the LM schedule, or plain SGD for
    int8, MoE and ``sgd`` (each parameter's change its summed gradient);
    ``attn="ring"`` splits the sequence over sp, ``pp`` runs the layer
    stack over pp in that many microbatches."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    cfg = getattr(ttf, f"{config}_config")(quant=quant, attn_impl=attn)
    tx = (optim.SGD(SGD_LR) if sgd or quant or config != "tiny"
          else optim.make_optimizer(LR, inp["dec_total"]))
    return ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.params_from_numpy(inp[f"{config}_params"], dev),
        loss_fn=ttf.make_loss_fn(cfg, pp_microbatches=pp), optimizer=tx,
        config=ttrain.TrainLoopConfig(total_steps=total, log_every=1),
        device="cpu", mesh=mesh, param_shardings=ttf.param_specs(cfg, pp=pp > 0),
        model_dir=model_dir)


def _pp_cfg(extra):
    """The 4-layer decoder of the sp and pp gradient cases."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    return ttf.tiny_config(n_layers=4, remat=extra.get("remat", False),
                           attn_impl=extra.get("attn", "auto"),
                           shard_seq=extra.get("shard_seq", False),
                           quant=extra.get("quant", ""))


def _run_grad(inp, mesh, root, extra):
    """One SGD step at lr 1 (each leaf's change is minus its gradient)
    from the 4-layer decoder's weights on the whole batch, and the hidden
    state before it (gathered over sp)."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf
    from kubeflow_controller_tpu_torch.parallel import sharding
    from kubeflow_controller_tpu_torch.parallel.collectives import seq_gather

    cfg, pp = _pp_cfg(extra), extra.get("pp", 0)
    batch = inp["pp_packed" if extra.get("pack") else "pp_batch"]
    loop = ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.params_from_numpy(inp["pp_params"], dev),
        loss_fn=ttf.make_loss_fn(cfg, pp_microbatches=pp), optimizer=optim.SGD(1.0),
        config=ttrain.TrainLoopConfig(total_steps=1, log_every=1), device="cpu",
        mesh=mesh, param_shardings=ttf.param_specs(cfg, pp=pp > 0))
    out = {}
    if tmesh.data_shards(mesh) == 1:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        seg = tb.get("segment_ids")
        seg = None if seg is None else seg[:, :-1]
        kw = dict(positions=None if seg is None else ttf.packed_positions(seg),
                  segment_ids=seg)
        with tmesh.use_mesh(mesh), torch.no_grad():
            params = convert.tree_unflatten(loop.state.params, loop._views())
            hidden = (ttf.forward_hidden_pp(cfg, params, tb["tokens"][:, :-1], pp, **kw)
                      if pp else ttf.forward_hidden(cfg, params, tb["tokens"][:, :-1], **kw))[0]
            out["hidden"] = seq_gather(hidden).numpy()
    # Each stage layer's slice gathered in the model has its gradient
    # reduced once in the step, however many ticks used it.
    calls, reduce_grad = [], sharding.reduce_grad

    def counted(g, spec, mesh, stage=False):
        calls.append(stage)
        return reduce_grad(g, spec, mesh, stage)

    sharding.reduce_grad = counted
    try:
        out["records"] = _records(loop, [batch], B)
    finally:
        sharding.reduce_grad = reduce_grad
    stacked = sum(o and bool(s) and s[0] == "pp" for o, s in zip(loop._in_model, loop._specs))
    out["stage_reduces"] = (sum(calls), stacked * cfg.n_layers // mesh.shape["pp"])
    out["grads"] = [p0 - p1 for p0, p1 in zip(convert.tree_leaves(inp["pp_params"]),
                                               convert.tree_leaves(_whole(loop)))]
    return out


def _run_ring(inp, mesh):
    """``ring_mha`` on this rank's slices (and, over tp, its heads) of the
    inputs; outputs and the gradients of ``sum(out ** 2)`` gathered
    whole."""
    from kubeflow_controller_tpu_torch.parallel.collectives import seq_gather, tp_gather
    from kubeflow_controller_tpu_torch.parallel.ring import ring_mha

    tp, ti = mesh.shape["tp"], mesh.coords["tp"]

    def mine(x):
        h, sl = x.shape[2] // tp, tmesh.seq_slice(mesh, x.shape[1])
        return torch.from_numpy(x[:, sl, ti * h:(ti + 1) * h]).requires_grad_(True)

    def whole(x):
        x = seq_gather(x.detach())
        return (torch.cat(list(tp_gather(x)), 2) if tp > 1 else x).numpy()

    out = {}
    with tmesh.use_mesh(mesh):
        for name, (q, k, v, seg, causal) in inp["ring"].items():
            if tp > 1 and name != "gqa_grad":
                continue
            ins = [mine(x) for x in (q, k, v)]
            sl = tmesh.seq_slice(mesh, q.shape[1])
            o = ring_mha(*ins, causal=causal,
                         segment_ids=None if seg is None else torch.from_numpy(seg[:, sl]))
            out[name] = whole(o)
            if name.endswith("grad"):
                (o ** 2).sum().backward()
                out[name + "s"] = [whole(x.grad) for x in ins]
    return out


def _run_gpipe(mesh):
    """The reference's three ``gpipe`` checks on this pp=2 mesh."""
    from kubeflow_controller_tpu_torch.parallel.pipeline import gpipe, pp_stage_count

    out = {"stages": pp_stage_count(mesh)}
    with tmesh.use_mesh(mesh):
        x = torch.arange(8 * 4 * 4, dtype=torch.float32).reshape(8, 4, 4)
        out["identity"] = gpipe(lambda p, m: m, (), x, 4, remat=False).numpy()
        consts = torch.tensor([1.0, 10.0])[mesh.coords["pp"]:mesh.coords["pp"] + 1]
        out["offset"] = gpipe(lambda c, m: m + c[0], consts, torch.zeros(4, 2, 2), 2,
                              remat=False).numpy()
        try:
            gpipe(lambda p, m: m, (), torch.zeros(6, 2, 2), 4)
            out["divide"] = ""
        except AssertionError as e:
            out["divide"] = str(e)
    return out


def _run_case(name, inp, meshes, root):
    """This rank's part of case ``name``; the case's first rank returns
    what the test compares."""
    from kubeflow_controller_tpu_torch.models import bert as tbert
    from kubeflow_controller_tpu_torch.models import mnist as tmnist
    from kubeflow_controller_tpu_torch.models import resnet as tresnet

    model, _, _, extra = CASES[name]
    mesh = meshes[name]
    if model == "c11":
        return _run_c11(inp, mesh, root)
    if model == "grad":
        return _run_grad(inp, mesh, root, extra)
    if model == "ring":
        return _run_ring(inp, mesh)
    if model == "gpipe":
        return _run_gpipe(mesh)
    if model == "decoder":
        mdir = os.path.join(root, "pp_model") if name == "dec_pp2_tp2" else ""
        loop = _decoder_loop(inp, mesh, model_dir=mdir, **extra)
        out = {"records": _records(loop, inp["dec_batches"], B), "params": _whole(loop)}
        if mdir and mesh.rank == int(mesh.devices.flat[0]):
            # The pp=2 x tp=2 checkpoint, restored by one process.
            one = _decoder_loop(inp, meshes["ckpt_one"], model_dir=mdir, **extra)
            out["restored_step"] = one.state.step if one.restore() else -1
            out["restored"] = convert.params_to_numpy(one.state.params)
        if name == "dec_tp2":
            # The chunked loss keeps its chunks under tp (vocab-parallel
            # in each): the same loss as the whole-sequence one.
            from kubeflow_controller_tpu_torch.models import transformer as ttf

            cfg = ttf.tiny_config()
            params = convert.tree_unflatten(loop.state.params, loop._views())
            batch = {"tokens": torch.from_numpy(inp["dec_batches"][0]["tokens"])}
            with tmesh.use_mesh(mesh), torch.no_grad():
                out["chunked"] = [float(ttf.next_token_loss(cfg, params, batch, loss_chunk=c)[0])
                                  for c in (0, 8)]
        return out
    if model == "corpus":
        return _run_corpus(inp, root, meshes[name].rank)
    if model == "mnist":
        tm = tmnist.MnistMLP(hidden=32)
        loop = ttrain.TrainLoop(
            init_fn=lambda seed, dev: convert.mnist_params_from_flax(inp["mnist_vars"], dev),
            loss_fn=tmnist.make_loss_fn(tm), optimizer=optim.adam(1e-3),
            eval_fn=tmnist.make_eval_fn(tm),
            config=ttrain.TrainLoopConfig(**inp["mnist_conf"]), device="cpu", mesh=mesh)
        seen = []
        loop.run(ttrain.device_prefetch(iter(inp["mnist_batches"]), "cpu",
                                        rows=loop.local_rows(16)),
                 on_metrics=lambda m: seen.append((m.step, m.loss, dict(m.extras))),
                 eval_iter=iter(inp["mnist_eval"]))
        return {"records": seen, "params": _whole(loop)}
    if model == "resnet":
        tm = tresnet.resnet_tiny()
        loop = ttrain.TrainLoop(
            init_fn=lambda seed, dev: convert.resnet_params_from_flax(
                inp["resnet_params"], inp["resnet_stats"], dev),
            loss_fn=tresnet.make_loss_fn(tm),
            optimizer=optim.SGD(0.05, momentum=0.9, nesterov=True),
            config=ttrain.TrainLoopConfig(total_steps=3, log_every=1, grad_accum=2),
            stateful=True, device="cpu", mesh=mesh)
        seen = _records(loop, inp["resnet_batches"], 8)
        params, stats = convert.resnet_params_to_flax(
            whole_state(loop)[0], loop.state.model_state)
        return {"records": seen, "params": params, "stats": stats}
    if model == "bert":
        cfg = tbert.bert_tiny_config()
        loop = ttrain.TrainLoop(
            init_fn=lambda seed, dev: convert.params_from_numpy(inp["bert_params"], dev),
            loss_fn=tbert.make_loss_fn(cfg),
            optimizer=optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, LR, 1, 3),
                                  weight_decay=0.01),
            config=ttrain.TrainLoopConfig(total_steps=3, log_every=1), device="cpu",
            mesh=mesh, param_shardings=tbert.param_specs(cfg))
        return {"records": _records(loop, inp["bert_batches"], 4), "params": _whole(loop)}
    # The checkpoint: two steps at fsdp=2 into a model dir, then the
    # first rank alone restores it, then both resume at dp=2 to step 4.
    mdir = os.path.join(root, "ckpt_model")
    loop = _decoder_loop(inp, mesh, total=2, model_dir=mdir)
    first = _records(loop, inp["dec_batches4"][:2], B)
    saved = _whole(loop)
    out = None
    if mesh.rank == int(mesh.devices.flat[0]):
        one = _decoder_loop(inp, meshes["ckpt_one"], total=2, model_dir=mdir)
        assert one.restore()
        out = {"saved": saved, "restored": convert.params_to_numpy(one.state.params),
               "restored_step": one.state.step}
    resumed = _decoder_loop(inp, meshes["ckpt_dp2"], total=4, model_dir=mdir)
    second = _records(resumed, inp["dec_batches4"][2:], B)
    if out is not None:
        out.update(records=first + second, params=_whole(resumed),
                   start_step=resumed.start_step)
    return out


class WholeLeafCounter:
    """Inside the block, records every tensor an operator makes (not a
    view or an in-place result) whose shape is one of ``shapes`` (whole
    sharded leaves), every call of ``sharding.gather_full``, and the
    keyword arguments of every ``torch.load``."""

    def __init__(self, shapes):
        self.shapes = {tuple(s) for s in shapes}
        self.made, self.gathers, self.loads = [], 0, []

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        from kubeflow_controller_tpu_torch.parallel import sharding

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not any(r.alias_info for r in func._schema.returns):
                    counter.made += [str(func) for t in tree_leaves(out)
                                     if isinstance(t, torch.Tensor)
                                     and tuple(t.shape) in counter.shapes]
                return out

        def gather_full(*a, **k):
            self.gathers += 1
            return self._gather_full(*a, **k)

        def load(f, *a, **k):
            self.loads.append((os.path.basename(str(f)), k.get("map_location"),
                               k.get("mmap", False)))
            return self._load(f, *a, **k)

        self._sharding, self._gather_full, self._load = sharding, sharding.gather_full, torch.load
        sharding.gather_full, torch.load = gather_full, load
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._sharding.gather_full, torch.load = self._gather_full, self._load

    def record(self):
        return {"made": self.made, "gathers": self.gathers, "loads": self.loads}


def sharded_shapes(loop):
    """The whole shapes of ``loop``'s leaves that its mesh shards, but
    those that are also some leaf's chunk shape here (at fsdp=2 x tp=2
    the tiny decoder's ``w_down`` chunk is ``[2, 64, 32]``, ``wk``'s
    whole shape): a tensor of one of these shapes is a whole leaf."""
    from kubeflow_controller_tpu_torch.parallel import sharding

    chunks = {tuple(p.shape) for p in convert.tree_leaves(loop.state.params)}
    return [shape for shape, s in zip(loop._full_shapes, loop._specs)
            if sharding.is_sharded(s, loop.mesh, len(shape)) and tuple(shape) not in chunks]


def _run_c11(inp, mesh, root):
    """Two AdamW steps at fsdp=2 x tp=2, then a save and a restore into a
    fresh loop on the same mesh, each under a :class:`WholeLeafCounter`;
    then a third step and a background save (``wait=False``), whose
    thread alone must leave the checkpoint committed (no
    ``wait_for_save`` before each rank lists the steps). The first rank
    returns every rank's records, whether it writes the index, whether
    the restored chunks (parameters, moments, counts) equal the saved
    ones bit for bit, and the steps each rank saw committed."""
    import torch.distributed as dist

    mdir = os.path.join(root, "c11_model")
    loop = _decoder_loop(inp, mesh, total=2, model_dir=mdir)
    rows = loop.local_rows(B)
    for batch in inp["dec_batches"][:2]:
        loop.step({"tokens": torch.from_numpy(batch["tokens"][rows])})
    shapes = sharded_shapes(loop)
    with WholeLeafCounter(shapes) as saving:
        loop.save()
    fresh = _decoder_loop(inp, mesh, total=2, model_dir=mdir)
    with WholeLeafCounter(shapes) as restoring:
        restored = fresh.restore()

    def tensors(lp):
        opt = lp.tx.state_dict()["opt"]["state"]
        return list(convert.tree_leaves(lp.state.params)) + [
            opt[i][k] for i in sorted(opt) for k in sorted(opt[i])]

    same = restored and fresh.state.step == 2 and all(
        torch.equal(a, b) for a, b in zip(tensors(fresh), tensors(loop)))
    loop.step({"tokens": torch.from_numpy(inp["dec_batches"][2]["tokens"][rows])})
    loop.save(wait=False)
    loop._saver.join()
    committed = ttrain.checkpoint_steps(mdir)
    loop.wait_for_save()
    mine = {"rank": mesh.rank, "writer": loop._writer(), "save": saving.record(),
            "restore": restoring.record(), "bit_for_bit": bool(same),
            "n_sharded": len(shapes), "committed_in_background": committed}
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=mesh.group(*tmesh.AXES))
    return {"ranks": every, "files": sorted(os.listdir(os.path.join(mdir, "2")))}


def _run_corpus(inp, root, rank):
    """``lm.train`` over the whole gang at dp=2 x tp=2 on the corpus: each
    rank writes the tokens it trained on; the first returns the losses
    and the gathered parameters."""
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm as tlm

    seen, losses, kept = [], [], []
    real_step = ttrain.TrainLoop.step

    def step(loop, batch):
        kept[:] = [loop]
        seen.append(batch["tokens"].numpy().copy())
        out = real_step(loop, batch)
        losses.append(float(out["loss"]))
        return out

    ttrain.TrainLoop.step = step
    try:
        tlm.train(ProcessContext(num_processes=4, process_id=rank), config="tiny",
                  total_steps=3, per_data_shard_batch=inp["corpus_per_shard"], seq_len=S,
                  learning_rate=LR, mesh_config=tmesh.MeshConfig(dp=2, tp=2),
                  data_file=os.path.join(root, "corpus.bin"), device="cpu")
    finally:
        ttrain.TrainLoop.step = real_step
    torch.save(seen, os.path.join(root, f"corpus-tokens-{rank}.pt"))
    return {"losses": losses, "params": _whole(kept[0])}


def _check_device_mesh(mesh, root, rank):
    """The mesh as a ``DeviceMesh`` and each spec's DTensor placements:
    a DTensor built from this rank's chunk (``local_shard``) and
    ``placements(spec)`` reassembles the whole tensor, as
    ``gather_full`` does."""
    from torch.distributed.tensor import DTensor

    from kubeflow_controller_tpu_torch.parallel import sharding

    dm = mesh.device_mesh
    out = {"coordinate": list(dm.get_coordinate()), "coords": [mesh.coords[a] for a in tmesh.AXES]}
    full = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for spec in (sharding.P(None, "fsdp", "tp"), sharding.P(None, ("fsdp", "tp")),
                 sharding.P("tp", None, "fsdp")):
        local = sharding.local_shard(full, spec, mesh)
        dt = DTensor.from_local(local, dm, sharding.placements(spec, mesh, 3),
                                shape=full.shape, stride=full.stride())
        out[repr(spec)] = bool(torch.equal(dt.full_tensor(), full)
                               and torch.equal(sharding.gather_full(local, spec, mesh), full))
    with open(os.path.join(root, f"device_mesh-{rank}.json"), "w") as f:
        json.dump(out, f)


def _worker_main(root, rank, port):
    """One rank of the gang: build every case's mesh (all ranks, same
    order), then run the phases."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    meshes = {name: tmesh.make_mesh(tmesh.MeshConfig(**kw), devices=ranks)
              for name, (_, kw, ranks, _) in CASES.items()}
    meshes["ckpt_one"] = tmesh.make_mesh(tmesh.MeshConfig(), devices=[rank])
    meshes["ckpt_dp2"] = tmesh.make_mesh(tmesh.MeshConfig(dp=2), devices=[2, 3])
    _check_device_mesh(meshes["dec_fsdp2_tp2"], root, rank)
    timings = {}
    for phase in PHASES:
        for name in phase:
            if rank not in CASES[name][2]:
                continue
            t0 = time.perf_counter()
            out = _run_case(name, inp, meshes, root)
            timings[name] = time.perf_counter() - t0
            if rank == CASES[name][2][0]:
                torch.save(out, os.path.join(root, f"{name}.pt"))
        dist.barrier()
    with open(os.path.join(root, f"timing-{rank}.json"), "w") as f:
        json.dump(timings, f)
    dist.destroy_process_group()


# -- the references (JAX) -------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    """Weights drawn by the port's own inits (from seeds, as numpy; the
    JAX side takes them as they are, ResNet's in flax's layout) and the
    JAX package's data streams."""
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
    from kubeflow_controller_tpu.models import bert as jbert
    from kubeflow_controller_tpu.models import mnist as jmnist
    from kubeflow_controller_tpu.models import resnet as jresnet
    from kubeflow_controller_tpu_torch.models import bert as tbert
    from kubeflow_controller_tpu_torch.models import mnist as tmnist
    from kubeflow_controller_tpu_torch.models import resnet as tresnet
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    tc = ttf.tiny_config()
    moe_params = convert.params_to_numpy(ttf.init_params(ttf.tiny_moe_config(), seed=4,
                                                         device="cpu"))
    rng = np.random.default_rng(1)
    pp_tokens = rng.integers(1, tc.vocab_size, (B, S + 1)).astype(np.int32)
    pp_segs = np.concatenate([np.full((B, 16), 1), np.full((B, 12), 2),
                              np.zeros((B, S + 1 - 28))], axis=1).astype(np.int32)
    dec_batches4 = list(itertools.islice(jlm.synthetic_lm(tc.vocab_size, B, S, seed=7), 4))
    rparams, rstats = convert.resnet_params_to_flax(*tresnet.resnet_tiny().init(2, "cpu"))
    bcfg = jbert.bert_tiny_config()
    bert_batches = []
    for seed in range(3):
        b = next(jbert.synthetic_mlm_batch(bcfg, 4, 32, seed=seed))
        b["attention_mask"][1, 20:] = 0       # padded tails: the ranks'
        b["attention_mask"][2, 9:] = 0        # masked counts differ
        b["mlm_mask"] = b["mlm_mask"] * b["attention_mask"]
        bert_batches.append(b)
    return {
        "tiny_params": convert.params_to_numpy(ttf.init_params(tc, seed=3, device="cpu")),
        # lm.train's init (seed 0) and its corpus: the rows of each data
        # shard drawn by JAX's stream under the seed of the shard's
        # first rank (0 and 2 at dp=2 x tp=2).
        "lm_params": convert.params_to_numpy(ttf.init_params(tc, seed=0, device="cpu")),
        "corpus": np.random.default_rng(5).integers(0, tc.vocab_size, 4096).astype(np.uint16),
        "corpus_per_shard": 2,
        "tiny_moe_params": moe_params,
        "dec_total": 3,
        "dec_batches": dec_batches4[:3],
        "dec_batches4": dec_batches4,
        "mnist_vars": {"params": convert.params_to_numpy(
            tmnist.MnistMLP(hidden=32).init(0, "cpu"))},
        "mnist_batches": list(itertools.islice(jmnist.synthetic_mnist(16, uint8=True), 4)),
        "mnist_eval": list(itertools.islice(jmnist.synthetic_mnist(16, seed=1, uint8=True), 4)),
        "mnist_conf": dict(total_steps=4, log_every=1, eval_every=2, eval_batches=2),
        "resnet_params": rparams, "resnet_stats": rstats,
        "resnet_batches": list(itertools.islice(
            jresnet.synthetic_imagenet(8, 16, 10, seed=3, uint8=True), 3)),
        "bert_params": convert.params_to_numpy(
            tbert.init_params(tbert.bert_tiny_config(), seed=1, device="cpu")),
        "bert_batches": bert_batches,
        "pp_params": convert.params_to_numpy(ttf.init_params(
            ttf.tiny_config(n_layers=4), seed=1, device="cpu")),
        "pp_batch": {"tokens": pp_tokens},
        "pp_packed": {"tokens": pp_tokens, "segment_ids": pp_segs},
        "ring": _ring_inputs(),
    }


def _qkv(b=2, s=32, h=4, kv_h=4, d=16, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kv_h, kv_h))


def _ring_inputs():
    """``tests/test_ring.py``'s inputs: name -> (q, k, v, segment ids,
    causal); the ``*grad`` ones are also differentiated."""
    seg = np.array([[0] * 16 + [1] * 16, [0] * 8 + [1] * 24], np.int32)
    return {"causal": (*_qkv(), None, True), "noncausal": (*_qkv(), None, False),
            "gqa": (*_qkv(kv_h=2), None, True), "seg": (*_qkv(), seg, True),
            "grad": (*_qkv(s=16), None, True), "gqa_grad": (*_qkv(kv_h=2), None, True)}


def _jax_records(loop, batches, **kw):
    seen = []
    loop.run(iter(batches), on_metrics=lambda m: seen.append((m.step, m.loss, dict(m.extras))),
             **kw)
    return seen


def _jax_ring(inp, kw):
    """The JAX package's ``ring_mha`` on a mesh of ``kw``: outputs, and
    the gradients of ``sum(out ** 2)`` for the ``*grad`` inputs."""
    import jax
    import jax.numpy as jnp
    from kubeflow_controller_tpu.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_controller_tpu.parallel.ring import ring_mha

    mesh = make_mesh(MeshConfig(**kw), jax.devices()[:math.prod(kw.values())])
    out = {}
    with jax.set_mesh(mesh):
        for name, (q, k, v, seg, causal) in inp["ring"].items():
            if kw.get("tp", 1) > 1 and name != "gqa_grad":
                continue
            seg = None if seg is None else jnp.asarray(seg)

            def f(q, k, v, seg=seg, causal=causal):
                return ring_mha(q, k, v, causal=causal, segment_ids=seg)

            out[name] = np.asarray(jax.jit(f)(q, k, v))
            if name.endswith("grad"):
                g = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2)))(q, k, v)
                out[name + "s"] = [np.asarray(x) for x in g]
    return out


def _jax_decoder_grads(inp, extra, kw=None):
    """The JAX package's loss, gradients and hidden state of the 4-layer
    decoder on the case's batch: on a mesh of ``kw`` (pipelined with
    ``extra["pp"]``), or without a mesh and pipeline when ``kw`` is
    None."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu.parallel.mesh import MeshConfig, batch_sharding, make_mesh

    pp = extra.get("pp", 0) if kw else 0
    jc = jtf.tiny_config(n_layers=4, remat=extra.get("remat", False),
                         quant=extra.get("quant", ""))
    if kw:
        jc = jc.replace(attn_impl=extra.get("attn", "auto"),
                        shard_seq=extra.get("attn") == "ring" or extra.get("shard_seq", False))
    batch = {k: jnp.asarray(v) for k, v in
             inp["pp_packed" if extra.get("pack") else "pp_batch"].items()}
    seg = batch.get("segment_ids")
    seg = None if seg is None else seg[:, :-1]
    pos = None if seg is None else jtf.packed_positions(seg)

    def hidden(p, b):
        toks = b["tokens"][:, :-1]
        if pp:
            return jtf.forward_hidden_pp(jc, p, toks, pp, positions=pos, segment_ids=seg)[0]
        return jtf.forward_hidden(jc, p, toks, positions=pos, segment_ids=seg)[0]

    def loss(p, b):
        return jtf.next_token_loss(jc, p, b, pp_microbatches=pp)[0]

    params = inp["pp_params"]
    if kw is None:
        lval, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
        h = jax.jit(hidden)(params, batch)
    else:
        mesh = make_mesh(MeshConfig(**kw), jax.devices()[:math.prod(kw.values())])
        with jax.set_mesh(mesh):
            params = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                                  params, jtf.param_specs(jc, pp=pp > 0))
            batch = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
            lval, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
            h = jax.jit(hidden)(params, batch)
    return {"loss": float(lval), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "hidden": np.asarray(h)}


def _jax_reference(name, inp, total=None):
    import jax
    import optax
    from jax.sharding import NamedSharding
    from kubeflow_controller_tpu.dataplane import train as jtrain
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
    from kubeflow_controller_tpu.models import bert as jbert
    from kubeflow_controller_tpu.models import mnist as jmnist
    from kubeflow_controller_tpu.models import resnet as jresnet
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu.parallel.mesh import MeshConfig, make_mesh

    model, kw, ranks, extra = CASES[name]
    if model == "ring":
        return _jax_ring(inp, kw)
    if model in ("gpipe", "c11"):
        return {}
    if model == "grad":
        return _jax_decoder_grads(inp, extra, kw)
    mesh = make_mesh(MeshConfig(**kw), jax.devices()[:len(ranks)])

    def specs(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree)

    if model == "corpus":
        jc = jtf.tiny_config()
        loop = jtrain.TrainLoop(
            mesh=mesh, init_fn=lambda rng: inp["lm_params"], loss_fn=jtf.make_loss_fn(jc),
            optimizer=jlm._make_optimizer(LR, 3, False),
            config=jtrain.TrainLoopConfig(total_steps=3, log_every=1),
            param_shardings=specs(jtf.param_specs(jc)))
        return {"records": _jax_records(loop, inp["corpus_batches"]),
                "params": jax.device_get(loop.state.params)}

    if model in ("decoder", "ckpt"):
        config = extra.get("config", "tiny")
        attn, pp = extra.get("attn", "auto"), extra.get("pp", 0)
        jc = getattr(jtf, f"{config}_config")(quant=extra.get("quant", ""), attn_impl=attn,
                                              shard_seq=attn == "ring")
        steps = 4 if model == "ckpt" else 3
        sgd = extra.get("sgd") or extra.get("quant") or config != "tiny"
        loop = jtrain.TrainLoop(
            mesh=mesh, init_fn=lambda rng: inp[f"{config}_params"],
            loss_fn=(jtf.make_loss_fn(jc) if not pp else
                     lambda p, b, rng: jtf.next_token_loss(jc, p, b, pp_microbatches=pp)),
            optimizer=(optax.sgd(SGD_LR) if sgd else
                       jlm._make_optimizer(LR, inp["dec_total"], False)),
            config=jtrain.TrainLoopConfig(total_steps=steps, log_every=1),
            param_shardings=specs(jtf.param_specs(jc, pp=pp > 0)))
        batches = inp["dec_batches4"] if model == "ckpt" else inp["dec_batches"]
        return {"records": _jax_records(loop, batches),
                "params": jax.device_get(loop.state.params)}
    if model == "mnist":
        jm = jmnist.MnistMLP(hidden=32)
        loop = jtrain.TrainLoop(
            mesh=mesh, init_fn=lambda rng: inp["mnist_vars"], loss_fn=jmnist.make_loss_fn(jm),
            optimizer=optax.adam(1e-3), eval_fn=jmnist.make_eval_fn(jm),
            config=jtrain.TrainLoopConfig(**inp["mnist_conf"]))
        return {"records": _jax_records(loop, inp["mnist_batches"],
                                        eval_iter=iter(inp["mnist_eval"])),
                "params": jax.device_get(loop.state.params)}
    if model == "resnet":
        jm = jresnet.resnet_tiny()
        loop = jtrain.TrainLoop(
            mesh=mesh, init_fn=lambda rng: (inp["resnet_params"], inp["resnet_stats"]),
            loss_fn=jresnet.make_loss_fn(jm),
            optimizer=optax.sgd(0.05, momentum=0.9, nesterov=True),
            config=jtrain.TrainLoopConfig(total_steps=3, log_every=1, grad_accum=2),
            stateful=True)
        return {"records": _jax_records(loop, inp["resnet_batches"]),
                "params": jax.device_get(loop.state.params),
                "stats": jax.device_get(loop.state.model_state)}
    cfg = jbert.bert_tiny_config()
    loop = jtrain.TrainLoop(
        mesh=mesh, init_fn=lambda rng: inp["bert_params"], loss_fn=jbert.make_loss_fn(cfg),
        optimizer=optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, 3),
                              weight_decay=0.01),
        config=jtrain.TrainLoopConfig(total_steps=3, log_every=1),
        param_shardings=specs(jbert.param_specs(cfg)))
    return {"records": _jax_records(loop, inp["bert_batches"]),
            "params": jax.device_get(loop.state.params)}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Start the gang, compute every JAX reference while it runs, then
    collect both."""
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm

    root = str(tmp_path_factory.mktemp("torch_parallel"))
    inp = _inputs()
    torch.save(inp, os.path.join(root, "inputs.pt"))
    path = os.path.join(root, "corpus.bin")
    inp["corpus"].tofile(path)
    per = inp["corpus_per_shard"]
    streams = [jlm.token_bin_lm(path, 2 * per, S, seed=seed) for seed in (0, 2)]
    inp["corpus_batches"] = [
        {"tokens": np.concatenate([next(st)["tokens"][d * per:(d + 1) * per]
                                   for d, st in enumerate(streams)])}
        for _ in range(3)]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + TESTS + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = ("import sys, test_torch_parallel as t; "
            "t._worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, root, str(r), str(port)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        # The JAX loops compile in threads of their own, side by side; the
        # gradient cases share the two references without a mesh.
        with ThreadPoolExecutor(3) as pool:
            dense = pool.map(lambda pack: _jax_decoder_grads(inp, {"pack": pack}), (False, True))
            refs = dict(zip(CASES, pool.map(lambda n: _jax_reference(n, inp), CASES)))
            refs["dense"], refs["dense_packed"] = dense
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = {name: torch.load(os.path.join(root, f"{name}.pt"), weights_only=False)
           for name in CASES}
    got["device_mesh"] = []
    for r in range(4):
        with open(os.path.join(root, f"device_mesh-{r}.json")) as f:
            got["device_mesh"].append(json.load(f))
    got["corpus_tokens"] = [
        torch.load(os.path.join(root, f"corpus-tokens-{r}.pt"), weights_only=False)
        for r in range(4)]
    got["root"] = root
    return inp, got, refs


def _leaves(tree):
    import jax

    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_params(got, want, atol=PARAM_ATOL, of_max=False, skip=()):
    import jax

    flat = _leaves(want)
    mine = convert.tree_leaves(got)
    assert len(mine) == len(flat)
    for (path, w), g in zip(flat, mine):
        name = jax.tree_util.keystr(path)
        if name in skip:
            continue
        w = np.asarray(w)
        tol = atol * float(np.abs(w).max()) if of_max else atol
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=tol, err_msg=name)


def _assert_losses(got, want, rtol, extras=()):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gl, ge), (_, wl, we) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=rtol)
        assert set(ge) == set(we)
        for k in extras:
            if k in we:
                np.testing.assert_allclose(ge[k], we[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", ["dec_dp4", "dec_dp2_fsdp2", "dec_fsdp2_tp2", "dec_tp2",
                                  "dec_sp2_ring", "dec_pp2_tp2"])
def test_decoder_layouts_match_jax_loop(gang, name):
    _, got, refs = gang
    _assert_losses(got[name]["records"], refs[name]["records"], LOSS_RTOL,
                   extras=("accuracy", "perplexity"))
    _assert_params(got[name]["params"], refs[name]["params"])


@pytest.mark.parametrize("name", ["dec_tp2_sgd", "dec_fsdp2_tp2_sgd"])
def test_decoder_tp_layouts_under_sgd_match_jax_loop(gang, name):
    """Under SGD each parameter's change is lr times its summed gradient,
    so a gradient over- or under-counted over tp shows in full."""
    import jax

    inp, got, refs = gang
    _assert_losses(got[name]["records"], refs[name]["records"], LOSS_RTOL)
    for (path, w), g, p0 in zip(_leaves(refs[name]["params"]),
                                convert.tree_leaves(got[name]["params"]),
                                convert.tree_leaves(inp["tiny_params"])):
        dw, dg = np.asarray(w) - p0, np.asarray(g) - p0
        assert np.abs(dw).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(dg, dw, rtol=SGD_CHANGE_RTOL,
                                   atol=SGD_CHANGE_ATOL_OF_MAX * float(np.abs(dw).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_lm_train_on_a_corpus_gives_tp_ranks_the_same_rows(gang):
    """The corpus stream is seeded by data shard: ranks 0 and 1 (tp) of
    shard 0 train on the same rows, as do ranks 2 and 3 of shard 1, the
    shards' rows differ, and the run equals the JAX loop on the global
    batch of the shards' streams."""
    inp, got, refs = gang
    toks = got["corpus_tokens"]
    per = inp["corpus_per_shard"]
    assert len(toks[0]) == 3
    for step in range(3):
        np.testing.assert_array_equal(toks[0][step], toks[1][step])
        np.testing.assert_array_equal(toks[2][step], toks[3][step])
        assert not np.array_equal(toks[0][step], toks[2][step])
        want = inp["corpus_batches"][step]["tokens"]
        np.testing.assert_array_equal(np.concatenate([toks[0][step], toks[2][step]]), want)
        assert want.shape == (2 * per, S + 1)
    g, w = got["corpus_dp2_tp2"], refs["corpus_dp2_tp2"]
    np.testing.assert_allclose(g["losses"], [r[1] for r in w["records"]], rtol=LOSS_RTOL)
    _assert_params(g["params"], w["params"])


def test_int8_decoder_at_fsdp2_matches_jax_loop(gang):
    import jax

    inp, got, refs = gang
    _assert_losses(got["dec_int8_fsdp2"]["records"], refs["dec_int8_fsdp2"]["records"],
                   INT8_LOSS_RTOL)
    for (path, w), g, p0 in zip(_leaves(refs["dec_int8_fsdp2"]["params"]),
                                convert.tree_leaves(got["dec_int8_fsdp2"]["params"]),
                                convert.tree_leaves(inp["tiny_params"])):
        dw, dg = np.asarray(w) - p0, np.asarray(g) - p0
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel <= INT8_LEAF_REL, (jax.tree_util.keystr(path), rel)


def test_chunked_loss_under_tp_keeps_its_chunks(gang):
    _, got, _ = gang
    whole, chunked = got["dec_tp2"]["chunked"]
    np.testing.assert_allclose(chunked, whole, rtol=1e-6)


def test_moe_decoder_at_fsdp2_matches_jax_loop(gang):
    """tiny_moe over fsdp=2: the expert banks are gathered whole, the
    routing groups never straddle ranks (the JAX package aligns them to
    the data shards), and the aux losses average over the ranks."""
    _, got, refs = gang
    g, w = got["moe_fsdp2"], refs["moe_fsdp2"]
    assert [r[0] for r in g["records"]] == [1, 2, 3]
    for (_, gl, ge), (_, wl, we) in zip(g["records"], w["records"]):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=MOE_LOSS_ATOL)
        assert set(ge) == set(we) >= {"moe_aux", "moe_drop_rate"}
        for k in ("moe_aux", "moe_drop_rate"):
            np.testing.assert_allclose(ge[k], we[k], rtol=0, atol=MOE_LOSS_ATOL, err_msg=k)
    _assert_params(g["params"], w["params"], atol=MOE_PARAM_ATOL)


def test_mnist_at_dp2_matches_jax_loop(gang):
    _, got, refs = gang
    g, w = got["mnist_dp2"], refs["mnist_dp2"]
    assert [r[0] for r in g["records"]] == [1, 2, 3, 4]
    assert "val_accuracy" in g["records"][-1][2]
    _assert_losses(g["records"], w["records"], MNIST_RTOL,
                   extras=("accuracy", "val_cross_entropy", "val_accuracy"))
    _assert_params(g["params"], w["params"]["params"], atol=MNIST_RTOL, of_max=True)


def test_resnet_at_dp2_matches_jax_loop_with_global_batch_norm(gang):
    """BatchNorm's statistics are the global batch's: the running
    statistics after 3 steps equal the JAX loop's (where GSPMD reduces
    over the batch's shards), with grad_accum=2 (each rank's rows of
    each microbatch, the statistics threading through them in order)."""
    _, got, refs = gang
    g, w = got["resnet_dp2"], refs["resnet_dp2"]
    _assert_losses(g["records"], w["records"], RESNET_RTOL)
    _assert_params(g["stats"], w["stats"], atol=RESNET_RTOL, of_max=True)
    _assert_params(g["params"], w["params"], atol=RESNET_RTOL, of_max=True)


def test_bert_at_fsdp2_matches_jax_loop(gang):
    """Padded rows give the two ranks different masked counts; the loss
    is the global batch's masked mean all the same. The key bias is held
    as ``test_torch_models.py`` holds it (its gradient is fp32 noise)."""
    _, got, refs = gang
    g, w = got["bert_fsdp2"], refs["bert_fsdp2"]
    _assert_losses(g["records"], w["records"], LOSS_RTOL, extras=("mlm_accuracy",))
    _assert_params(g["params"], w["params"], skip=("['layers']['bk']",))
    assert np.abs(g["params"]["layers"]["bk"]).max() <= 3 * LR


def test_fsdp2_checkpoint_restores_in_one_process_and_resumes_at_dp2(gang):
    """The fsdp=2 checkpoint (each rank's chunks) restores at any world
    size: one process restores the gathered parameters bit for bit, a
    dp=2 gang resumes from it to where the uninterrupted JAX fsdp=2 run
    ends, and ``serve(model_dir=...)`` serves its latest step."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve

    _, got, refs = gang
    g, w = got["ckpt"], refs["ckpt"]
    assert g["restored_step"] == 2 and g["start_step"] == 2
    for a, b in zip(convert.tree_leaves(g["restored"]), convert.tree_leaves(g["saved"])):
        np.testing.assert_array_equal(a, b)
    _assert_losses(g["records"], w["records"], LOSS_RTOL)
    _assert_params(g["params"], w["params"])
    out = serve(config="tiny", batch=2, slots=2, prompt_len=9, max_new_tokens=2,
                model_dir=os.path.join(got["root"], "ckpt_model"), device="cpu")
    assert out["restored_step"] == 4


def test_c11_save_and_restore_gather_no_whole_sharded_leaf(gang):
    """C11: at fsdp=2 x tp=2 no rank, the writer of the index included,
    makes a tensor of a whole sharded leaf's shape while it saves or
    restores, and none calls ``gather_full``: each rank writes the
    chunks it is the first to hold and reads its own region back from
    the memory-mapped chunk files (``torch.load(mmap=True)`` on the
    host). The restored parameters, moments and counts equal the saved
    ones bit for bit. A background save over the mesh is committed by
    its threads alone: each rank lists its step once its save thread
    ends, before any ``wait_for_save``."""
    _, got, _ = gang
    g = got["c11_fsdp2_tp2"]
    ranks = g["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert [r["writer"] for r in ranks] == [True, False, False, False]
    assert g["files"] == ["chunks-0.pt", "chunks-1.pt", "chunks-2.pt", "chunks-3.pt",
                          "index.pt"]
    for r in ranks:
        assert r["n_sharded"] >= 6 and r["bit_for_bit"], r
        assert r["committed_in_background"] == [2, 3], r
        for phase in ("save", "restore"):
            rec = r[phase]
            assert rec["made"] == [] and rec["gathers"] == 0, (r["rank"], phase, rec)
        loads = r["restore"]["loads"]
        chunk_loads = [x for x in loads if x[0].startswith("chunks-")]
        assert chunk_loads and all(x[1:] == ("cpu", True) for x in chunk_loads), loads
        assert ("index.pt", "cpu", False) in loads
        assert r["save"]["loads"] == []


def test_mesh_is_a_device_mesh_and_specs_are_dtensor_placements(gang):
    """Each rank's ``DeviceMesh`` coordinate is its mesh coordinate, and a
    DTensor of its chunks under ``placements(spec)`` is the whole tensor."""
    _, got, _ = gang
    for rank in got["device_mesh"]:
        assert rank["coordinate"] == rank["coords"]
        assert all(v for k, v in rank.items() if k.startswith("P("))


# -- sequence and pipeline parallelism ---------------------------------------------

@pytest.mark.parametrize("name", ["ring_sp4", "ring_sp2_tp2"])
def test_ring_mha_matches_jax_ring_on_the_same_mesh(gang, name):
    """At sp=4: causal and not, GQA, segment ids, and the gradients; at
    sp=2 x tp=2 (the six-axis regression of ``test_ring.py``, each rank
    holding its slice and its tp heads): GQA and its gradients."""
    _, got, refs = gang
    g, w = got[name], refs[name]
    assert set(g) == set(w) and len(w) == (8 if name == "ring_sp4" else 2)
    for key, want in w.items():
        if key.endswith("grads"):
            for a, b in zip(g[key], want):
                np.testing.assert_allclose(a, b, atol=RING_GRAD_ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(g[key], want, atol=RING_ATOL, err_msg=key)


def test_ring_without_a_mesh_is_dense_attention():
    """No mesh (or sp=1): ``ring_mha`` is ``mha_xla``, as the JAX
    package's falls back."""
    import jax.numpy as jnp
    from kubeflow_controller_tpu.parallel.ring import ring_mha as jring
    from kubeflow_controller_tpu_torch.ops.attention import mha_xla
    from kubeflow_controller_tpu_torch.parallel.ring import ring_mha

    q, k, v, seg, _ = _ring_inputs()["seg"]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ring_mha(tq, tk, tv, segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, mha_xla(tq, tk, tv, segment_ids=torch.from_numpy(seg)).numpy())
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            segment_ids=jnp.asarray(seg)))
    np.testing.assert_allclose(got, want, atol=RING_ATOL)
    with tmesh.use_mesh(tmesh.make_mesh()):
        np.testing.assert_array_equal(ring_mha(tq, tk, tv).numpy(), mha_xla(tq, tk, tv).numpy())


def test_gpipe_keeps_batch_order_adds_each_stage_once_and_needs_divisible_batch(gang):
    """``test_pipeline.py``'s three checks of the schedule at pp=2:
    identity stages are a delay line that keeps the batch's order, a
    stage constant is added once per stage (every microbatch visits
    every stage once), and a batch that does not divide into the
    microbatches is refused."""
    _, got, _ = gang
    g = got["gpipe_pp2"]
    assert g["stages"] == 2
    np.testing.assert_array_equal(g["identity"], np.arange(8 * 4 * 4, dtype=np.float32)
                                  .reshape(8, 4, 4))
    np.testing.assert_array_equal(g["offset"], np.full((4, 2, 2), 11.0, np.float32))
    assert "must divide into 4 microbatches" in g["divide"]


@pytest.mark.parametrize("name", ["grad_sp2_ring", "grad_sp2_gather", "grad_pp2_tp2",
                                  "grad_pp2_tp2_packed"])
def test_decoder_hidden_loss_and_gradients_match_jax(gang, name):
    """The decoder's hidden state, loss and every leaf's gradient on the
    case's mesh against the JAX package's on the same mesh (ring
    attention, the sequence gathered for attention, the GPipe schedule)
    and without a mesh or a pipeline; ring attention's hidden state at
    ``test_ring.py``'s decoder bound."""
    inp, got, refs = gang
    g = got[name]
    fwd = dict(atol=RING_DECODER_ATOL) if "ring" in name else PIPE_FWD
    dense = refs["dense_packed" if CASES[name][3].get("pack") else "dense"]
    assert [r[0] for r in g["records"]] == [1]
    for label, w in (("layout", refs[name]), ("no mesh", dense)):
        np.testing.assert_allclose(g["hidden"], w["hidden"], err_msg=label, **fwd)
        np.testing.assert_allclose(g["records"][0][1], w["loss"], rtol=PIPE_LOSS_RTOL,
                                   err_msg=label)
        assert len(g["grads"]) == len(w["grads"])
        for i, (a, b) in enumerate(zip(g["grads"], w["grads"])):
            assert np.abs(b).max() > 0, (label, i)
            np.testing.assert_allclose(a, b, err_msg=f"{label} leaf {i}", **PIPE_GRAD)


def test_int8_decoder_over_pp_matches_jax_pipeline(gang):
    """int8 projections over pp=2 x fsdp=2 (B7's path inside each stage
    on the card): the loss within the int8 bound of the fsdp case and
    each leaf's gradient within its relative L2 bound."""
    _, got, refs = gang
    g, w = got["grad_int8_pp2_fsdp2"], refs["grad_int8_pp2_fsdp2"]
    np.testing.assert_allclose(g["records"][0][1], w["loss"], rtol=INT8_LOSS_RTOL)
    for i, (a, b) in enumerate(zip(g["grads"], w["grads"])):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= INT8_LEAF_REL, (i, rel)
    # Over fsdp each stage layer's gradient is reduced once a step, not
    # once a tick.
    done, once = g["stage_reduces"]
    assert once > 0 and done == once, (done, once)


def test_pp2_checkpoint_restores_in_one_process(gang):
    """The pp=2 x tp=2 loop's checkpoint (each rank's chunks: a stage's
    layers, a tp shard) restores in one process to the gathered
    parameters bit for bit."""
    _, got, _ = gang
    g = got["dec_pp2_tp2"]
    assert g["restored_step"] == 3
    for a, b in zip(convert.tree_leaves(g["restored"]), convert.tree_leaves(g["params"])):
        np.testing.assert_array_equal(a, b)


def test_moe_is_refused_on_the_pipeline_path_with_the_reference_message():
    import jax
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    cfg = ttf.tiny_moe_config()
    with pytest.raises(NotImplementedError) as want:
        jtf.forward_hidden_pp(jtf.tiny_moe_config(), None, jax.numpy.zeros((4, 8), "int32"), 2)
    with pytest.raises(NotImplementedError, match="dense") as got:
        ttf.forward_hidden_pp(cfg, ttf.init_params(cfg, device="cpu"),
                              torch.zeros((4, 8), dtype=torch.int64), 2)
    assert str(got.value) == str(want.value)


def test_this_process_runs_one_intra_op_thread():
    """The JAX references and the checks here run beside the gang and
    other xdist workers on one intra-op thread (set at this module's
    import; ``tests/test_torch_import.py`` says why)."""
    assert torch.get_num_threads() == 1
