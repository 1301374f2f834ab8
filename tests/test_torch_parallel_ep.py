"""The rest of training parallelism against the JAX package: expert
parallelism, MoE and int8 projections over tp and sp, 8-bit AdamW on
sharded leaves, BERT over tp, and the int8 scales of a split
contraction (C10).

One gang of four gloo processes (:func:`_worker_main`, started once for
the module, beside ``test_torch_parallel.py``'s) runs every case in
turn; a case of two ranks runs beside another on the other two. Each
reads the same weights and batches (numpy, made here from seeds) and
writes what its test compares. Meanwhile this process runs the JAX
package on sub-meshes of the 8 virtual CPU devices (``tests/conftest.py``)
of each case's shape. The tests:

* tiny_moe's forward logits at fsdp=2 x ep=2 and ep=2 x tp=2 against
  the JAX package's ``forward`` on the same mesh, at
  ``tests/test_moe.py``'s ``atol=2e-4``;
* three SGD steps of ``TrainLoop`` for tiny_moe at ep=2 x fsdp=2, tp=2,
  sp=2 with ring attention and sp=2 with the sequence gathered, against
  the JAX loop on the same ``MeshConfig``: the loss, ``moe_aux`` and
  ``moe_drop_rate`` each step and every parameter's change within
  ``test_torch_parallel.py``'s MoE bounds (4x the one-process ones);
  int8 experts at ep=2 x tp=2 within the int8 bounds;
* the int8 and ``int8_fused`` decoders at tp=2 (d_model 128, where the
  fused route takes every projection but wk/wv, the row-parallel ones
  through its split entries) within the int8 bounds;
* 8-bit AdamW at fsdp=2 x tp=2: three updates of the decoder's leaves on
  the same gradients as the JAX package's ``adamw8bit`` on the whole
  leaves, m codes and scales bit for bit, v codes within one code (C5),
  and the checkpoint restored by one process bit for bit;
* BERT at tp=2 and fsdp=2 x tp=2 on padded rows, three AdamW steps,
  within ``test_torch_parallel.py``'s BERT bounds;
* C10: ``int8_matmul``'s weight gradient at dp=2 x fsdp=2, one rank's
  rows scaled by 100, equal to ``jax.grad`` of the JAX package's
  ``int8_matmul`` on the global arrays within one quantum of the global
  scales;
* (no gang) ``moe_group`` of a rank's tokens against the JAX package's
  shard-aligned group of the global tokens at ep=2 and ep=4.
"""

import itertools
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_parallel as base
from kubeflow_controller_tpu_torch import convert, optim
from kubeflow_controller_tpu_torch.dataplane import train as ttrain
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

TESTS, ROOT = base.TESTS, base.ROOT
B, S = base.B, base.S
SGD_LR = base.SGD_LR
FWD_ATOL = 2e-4                  # tests/test_moe.py's ep-sharded forward
FWD_TOKENS = (4, 16)             # its tokens' shape
INT8_WIDE = dict(d_model=128, d_ff=256)
# Int8 experts: the aux loss and drop rate within two of the 512 routing
# decisions of a step (an input one int8 quantum apart between the
# frameworks may flip a near-tie).
INT8_MOE_METRIC_ATOL = 2 / 512

# name -> (what, mesh config, ranks of the gang, extra)
CASES = {
    "moe_fsdp2_ep2": ("decoder", dict(dp=1, fsdp=2, ep=2), [0, 1, 2, 3],
                      {"config": "tiny_moe", "forward": True}),
    "moe_ep2_tp2_fwd": ("forward", dict(dp=1, ep=2, tp=2), [0, 1, 2, 3], {}),
    "moe_tp2": ("decoder", dict(dp=1, tp=2), [0, 1], {"config": "tiny_moe"}),
    "moe_sp2_ring": ("decoder", dict(dp=1, sp=2), [2, 3],
                     {"config": "tiny_moe", "attn": "ring"}),
    "moe_sp2_gather": ("decoder", dict(dp=1, sp=2), [0, 1],
                       {"config": "tiny_moe", "shard_seq": True}),
    "int8_tp2": ("decoder", dict(dp=1, tp=2), [2, 3], {"quant": "int8", "wide": True}),
    "int8_fused_tp2": ("decoder", dict(dp=1, tp=2), [0, 1],
                       {"quant": "int8_fused", "wide": True}),
    "bert_tp2": ("bert", dict(dp=1, tp=2), [2, 3], {}),
    "bert_fsdp2_tp2": ("bert", dict(dp=1, fsdp=2, tp=2), [0, 1, 2, 3], {}),
    "moe_int8_ep2_tp2": ("decoder", dict(dp=1, ep=2, tp=2), [0, 1, 2, 3],
                         {"config": "tiny_moe", "quant": "int8"}),
    "opt8_fsdp2_tp2": ("opt8", dict(dp=1, fsdp=2, tp=2), [0, 1, 2, 3], {}),
    "c10_dp2_fsdp2": ("c10", dict(dp=2, fsdp=2), [0, 1, 2, 3], {}),
}
# Cases that run side by side (disjoint ranks), in order.
PHASES = [["c10_dp2_fsdp2"], ["moe_fsdp2_ep2"], ["moe_ep2_tp2_fwd"],
          ["moe_tp2", "moe_sp2_ring"], ["moe_sp2_gather", "int8_tp2"],
          ["int8_fused_tp2", "bert_tp2"], ["bert_fsdp2_tp2"], ["moe_int8_ep2_tp2"],
          ["opt8_fsdp2_tp2"]]


# -- the gang (no JAX here: the workers import this module) ---------------------

def _data_gather(x, mesh):
    """This rank's rows of a batch-major tensor joined with the other
    data ranks' (their rows are contiguous, in data-rank order)."""
    from kubeflow_controller_tpu_torch.parallel.collectives import gather_dim

    n = tmesh.data_shards(mesh)
    return x if n == 1 else gather_dim(x.contiguous(), 0, mesh.group(*tmesh.DATA_AXES), n)


def _config(extra):
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    kw = INT8_WIDE if extra.get("wide") else {}
    return getattr(ttf, f"{extra.get('config', 'tiny')}_config")(
        quant=extra.get("quant", ""), attn_impl=extra.get("attn", "auto"),
        shard_seq=extra.get("attn") == "ring" or extra.get("shard_seq", False), **kw)


def _params_key(extra):
    return "wide_params" if extra.get("wide") else f"{extra.get('config', 'tiny')}_params"


def _forward_logits(inp, mesh, cfg, params):
    """The whole batch's logits ``[4, 16, V]`` of the forward: each rank
    its rows (and under tp its vocab shard), gathered."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf
    from kubeflow_controller_tpu_torch.parallel.collectives import tp_gather

    toks = torch.from_numpy(inp["fwd_tokens"])
    rows = torch.from_numpy(tmesh.batch_rows(mesh, toks.shape[0]))
    with tmesh.use_mesh(mesh), torch.no_grad():
        hidden, _ = ttf.forward_hidden(cfg, params, toks[rows])
        logits = hidden @ ttf._head(cfg, params)
        logits = torch.cat(list(tp_gather(logits)), -1)
        return _data_gather(logits, mesh).numpy()


def _decoder_loop(inp, mesh, extra, total=3):
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    cfg = _config(extra)
    key = _params_key(extra)
    return ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.params_from_numpy(inp[key], dev),
        loss_fn=ttf.make_loss_fn(cfg), optimizer=optim.SGD(SGD_LR),
        config=ttrain.TrainLoopConfig(total_steps=total, log_every=1),
        device="cpu", mesh=mesh, param_shardings=ttf.param_specs(cfg)), cfg


def _run_opt8(inp, mesh, meshes, root):
    """Three 8-bit AdamW updates of the tiny decoder's chunks at fsdp=2
    x tp=2 on given gradients (each rank its chunk of them), saved
    through the loop; the mesh's first rank restores the checkpoint in
    one process."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf
    from kubeflow_controller_tpu_torch.parallel import sharding

    cfg = ttf.tiny_config()
    mdir = os.path.join(root, "opt8_model")
    loop = ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.params_from_numpy(inp["tiny_params"], dev),
        loss_fn=ttf.make_loss_fn(cfg), optimizer=optim.make_optimizer(base.LR, 3, True),
        config=ttrain.TrainLoopConfig(total_steps=3), device="cpu", mesh=mesh,
        param_shardings=ttf.param_specs(cfg), model_dir=mdir)
    for grads in inp["opt8_grads"]:
        chunks = [sharding.local_shard(torch.from_numpy(g), s, mesh)
                  for g, s in zip(convert.tree_leaves(grads), loop._specs)]
        loop.tx.update(loop.state.params, convert.tree_unflatten(loop.state.params, chunks))
    loop.state.step = 3
    params, opt = loop._whole_state()
    loop.save()
    if mesh.rank != int(mesh.devices.flat[0]):
        return None
    one = ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.params_from_numpy(inp["tiny_params"], dev),
        loss_fn=ttf.make_loss_fn(cfg), optimizer=optim.make_optimizer(base.LR, 3, True),
        config=ttrain.TrainLoopConfig(total_steps=3), device="cpu",
        mesh=meshes["one"], param_shardings=ttf.param_specs(cfg), model_dir=mdir)
    assert one.restore()
    return {"params": convert.params_to_numpy(params), "opt": opt,
            "restored": convert.params_to_numpy(one.state.params),
            "restored_opt": one.tx.state_dict(), "restored_step": one.state.step}


def _run_c10(inp, mesh):
    """``int8_matmul(x, w)`` on this rank's rows of the global ``x`` under
    the data mesh, the loss ``sum(y * c)`` over them; the weight's
    gradient summed over the ranks."""
    import torch.distributed as dist

    from kubeflow_controller_tpu_torch.ops.quant import int8_matmul

    n, r = tmesh.data_shards(mesh), mesh.axis_index(*tmesh.DATA_AXES)
    x, w, c = (torch.from_numpy(inp["c10"][k]) for k in ("x", "w", "c"))
    per = x.shape[0] // n
    rows = slice(r * per, (r + 1) * per)
    w = w.clone().requires_grad_(True)
    with tmesh.use_mesh(mesh):
        (int8_matmul(x[rows], w) * c[rows]).sum().backward()
    g = w.grad.clone()
    dist.all_reduce(g, group=mesh.group(*tmesh.DATA_AXES))
    return {"dw": g.numpy()}


def _run_case(name, inp, meshes, root):
    """This rank's part of case ``name``; the case's first rank returns
    what the test compares."""
    from kubeflow_controller_tpu_torch.models import bert as tbert

    what, _, _, extra = CASES[name]
    mesh = meshes[name]
    if what == "c10":
        return _run_c10(inp, mesh)
    if what == "opt8":
        return _run_opt8(inp, mesh, meshes, root)
    if what == "forward":
        loop, cfg = _decoder_loop(inp, mesh, {"config": "tiny_moe"}, total=0)
        params = convert.tree_unflatten(loop.state.params, loop._views())
        return {"logits": _forward_logits(inp, mesh, cfg, params)}
    if what == "bert":
        cfg = tbert.bert_tiny_config()
        loop = ttrain.TrainLoop(
            init_fn=lambda seed, dev: convert.params_from_numpy(inp["bert_params"], dev),
            loss_fn=tbert.make_loss_fn(cfg),
            optimizer=optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, base.LR, 1, 3),
                                  weight_decay=0.01),
            config=ttrain.TrainLoopConfig(total_steps=3, log_every=1), device="cpu",
            mesh=mesh, param_shardings=tbert.param_specs(cfg))
        return {"records": base._records(loop, inp["bert_batches"], 4),
                "params": base._whole(loop)}
    loop, cfg = _decoder_loop(inp, mesh, extra)
    out = {}
    if extra.get("forward"):
        params = convert.tree_unflatten(loop.state.params, loop._views())
        out["logits"] = _forward_logits(inp, mesh, cfg, params)
    out.update(records=base._records(loop, inp["dec_batches"], B), params=base._whole(loop))
    return out


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
    meshes["one"] = tmesh.make_mesh(tmesh.MeshConfig(), devices=[rank])
    for phase in PHASES:
        for name in phase:
            if rank not in CASES[name][2]:
                continue
            out = _run_case(name, inp, meshes, root)
            if rank == CASES[name][2][0]:
                torch.save(out, os.path.join(root, f"{name}.pt"))
        dist.barrier()
    dist.destroy_process_group()


# -- the references (JAX) -------------------------------------------------------

def _opt8_grads(params, steps=3):
    """``test_torch_optim8.py``'s gradients: many orders of magnitude a
    row (v spans a wide log range), scattered exact zeros."""
    out = []
    for step in range(steps):
        rng = np.random.default_rng(100 + step)

        def draw(a):
            g = rng.standard_normal(a.shape).astype(np.float32)
            g *= (10.0 ** rng.uniform(-6, 0, a.shape[:-1] + (1,))).astype(np.float32)
            g[rng.random(a.shape) < 0.05] = 0.0
            return g

        out.append(convert.tree_unflatten(params, [draw(a) for a in convert.tree_leaves(params)]))
    return out


def _bert_batches():
    """``test_torch_parallel.py``'s padded MLM batches: the ranks' masked
    counts differ."""
    from kubeflow_controller_tpu.models import bert as jbert

    out = []
    for seed in range(3):
        b = next(jbert.synthetic_mlm_batch(jbert.bert_tiny_config(), 4, 32, seed=seed))
        b["attention_mask"][1, 20:] = 0
        b["attention_mask"][2, 9:] = 0
        b["mlm_mask"] = b["mlm_mask"] * b["attention_mask"]
        out.append(b)
    return out


def _inputs():
    """The weights ``test_torch_parallel.py`` draws (the port's inits,
    from seeds, as numpy), the wider decoder of the int8 cases, the JAX
    package's data streams, 8-bit AdamW's gradients and C10's arrays."""
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
    from kubeflow_controller_tpu_torch.models import bert as tbert
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    tc = ttf.tiny_config()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((128, 64)).astype(np.float32)
    x[32:64] *= 100.0            # the second data rank's rows
    tiny = convert.params_to_numpy(ttf.init_params(tc, seed=3, device="cpu"))
    return {
        "tiny_params": tiny,
        "tiny_moe_params": convert.params_to_numpy(
            ttf.init_params(ttf.tiny_moe_config(), seed=4, device="cpu")),
        "wide_params": convert.params_to_numpy(ttf.init_params(
            ttf.tiny_config(**INT8_WIDE), seed=3, device="cpu")),
        "dec_batches": list(itertools.islice(jlm.synthetic_lm(tc.vocab_size, B, S, seed=7), 3)),
        "fwd_tokens": np.random.default_rng(1).integers(
            0, tc.vocab_size, FWD_TOKENS).astype(np.int32),
        "bert_params": convert.params_to_numpy(
            tbert.init_params(tbert.bert_tiny_config(), seed=1, device="cpu")),
        "bert_batches": _bert_batches(),
        "opt8_grads": _opt8_grads(tiny),
        "c10": {"x": x, "w": (rng.standard_normal((64, 48)) / 8).astype(np.float32),
                "c": rng.standard_normal((128, 48)).astype(np.float32)},
    }


def _jax_mesh(kw):
    import jax
    from kubeflow_controller_tpu.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**kw), jax.devices()[:math.prod(kw.values())])


def _jax_config(extra):
    from kubeflow_controller_tpu.models import transformer as jtf

    kw = INT8_WIDE if extra.get("wide") else {}
    return getattr(jtf, f"{extra.get('config', 'tiny')}_config")(
        quant=extra.get("quant", ""), attn_impl=extra.get("attn", "auto"),
        shard_seq=extra.get("attn") == "ring" or extra.get("shard_seq", False), **kw)


def _jax_forward(inp, kw, params):
    """The JAX package's ``forward`` logits on the mesh of ``kw``, as
    ``tests/test_moe.py`` shards them."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from kubeflow_controller_tpu.models import transformer as jtf

    cfg = jtf.tiny_moe_config()
    mesh = _jax_mesh(kw)
    sharded = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
                           params, jtf.param_specs(cfg))
    with jax.set_mesh(mesh):
        toks = jax.device_put(inp["fwd_tokens"], NamedSharding(mesh, JP(("dp", "fsdp", "ep"))))
        return np.asarray(jax.jit(lambda p, t: jtf.forward(cfg, p, t))(sharded, toks))


def _jax_opt8(inp):
    """The JAX package's ``adamw8bit`` (the LM entry point's) on the whole
    leaves: three updates on the same gradients."""
    import jax
    import optax
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm

    params = inp["tiny_params"]
    tx = jlm._make_optimizer(base.LR, 3, True)
    state = tx.init(params)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    for grads in inp["opt8_grads"]:
        updates, state = update(grads, state, params)
        params = jax.device_get(apply(params, updates))
    return {"params": params, "m": jax.device_get(state.m), "v": jax.device_get(state.v)}


def _jax_c10(inp):
    import jax
    import jax.numpy as jnp
    from kubeflow_controller_tpu.ops import quant as jq

    x, w, c = (jnp.asarray(inp["c10"][k]) for k in ("x", "w", "c"))
    dw = jax.jit(jax.grad(lambda w: (jq.int8_matmul(x, w) * c).sum()))(w)
    # The quantum of each dw element: its row scale of x.T and column
    # scale of the cotangent, over the whole token axis.
    sx = np.abs(inp["c10"]["x"]).max(0) / 127.0
    sc = np.abs(inp["c10"]["c"]).max(0) / 127.0
    return {"dw": np.asarray(dw), "quantum": sx[:, None] * sc[None, :]}


def _jax_reference(name, inp):
    import jax
    import optax
    from jax.sharding import NamedSharding
    from kubeflow_controller_tpu.dataplane import train as jtrain
    from kubeflow_controller_tpu.models import bert as jbert
    from kubeflow_controller_tpu.models import transformer as jtf

    what, kw, ranks, extra = CASES[name]
    if what == "c10":
        return _jax_c10(inp)
    if what == "opt8":
        return _jax_opt8(inp)
    if what == "forward":
        return {"logits": _jax_forward(inp, kw, inp["tiny_moe_params"])}
    mesh = _jax_mesh(kw)

    def specs(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree)

    if what == "bert":
        cfg = jbert.bert_tiny_config()
        loop = jtrain.TrainLoop(
            mesh=mesh, init_fn=lambda rng: inp["bert_params"], loss_fn=jbert.make_loss_fn(cfg),
            optimizer=optax.adamw(optax.warmup_cosine_decay_schedule(0.0, base.LR, 1, 3),
                                  weight_decay=0.01),
            config=jtrain.TrainLoopConfig(total_steps=3, log_every=1),
            param_shardings=specs(jbert.param_specs(cfg)))
        return {"records": base._jax_records(loop, inp["bert_batches"]),
                "params": jax.device_get(loop.state.params)}
    jc = _jax_config(extra)
    key = _params_key(extra)
    loop = jtrain.TrainLoop(
        mesh=mesh, init_fn=lambda rng: inp[key], loss_fn=jtf.make_loss_fn(jc),
        optimizer=optax.sgd(SGD_LR), config=jtrain.TrainLoopConfig(total_steps=3, log_every=1),
        param_shardings=specs(jtf.param_specs(jc)))
    out = {}
    if extra.get("forward"):
        out["logits"] = _jax_forward(inp, kw, inp[key])
    out.update(records=base._jax_records(loop, inp["dec_batches"]),
               params=jax.device_get(loop.state.params))
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Start the gang, compute every JAX reference while it runs, then
    collect both."""
    root = str(tmp_path_factory.mktemp("torch_parallel_ep"))
    inp = _inputs()
    torch.save(inp, os.path.join(root, "inputs.pt"))
    port = base._free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + TESTS + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = ("import sys, test_torch_parallel_ep as t; "
            "t._worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, root, str(r), str(port)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        with ThreadPoolExecutor(3) as pool:
            refs = dict(zip(CASES, pool.map(lambda n: _jax_reference(n, inp), CASES)))
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = {name: torch.load(os.path.join(root, f"{name}.pt"), weights_only=False)
           for name in CASES}
    return inp, got, refs


def _assert_moe_run(g, w, params0, loss_tol, metric_atol, change):
    """Each step's loss within ``loss_tol`` (``assert_allclose`` keywords)
    and MoE metrics within ``metric_atol``; every parameter's change
    from ``params0`` by ``change(got, want, name)``."""
    import jax

    assert [r[0] for r in g["records"]] == [1, 2, 3]
    for (_, gl, ge), (_, wl, we) in zip(g["records"], w["records"]):
        np.testing.assert_allclose(gl, wl, **loss_tol)
        assert set(ge) == set(we) >= {"moe_aux", "moe_drop_rate"}
        for k in ("moe_aux", "moe_drop_rate"):
            np.testing.assert_allclose(ge[k], we[k], rtol=0, atol=metric_atol, err_msg=k)
    for (path, wp), gp, p0 in zip(base._leaves(w["params"]),
                                  convert.tree_leaves(g["params"]),
                                  convert.tree_leaves(params0)):
        name = jax.tree_util.keystr(path)
        dw, dg = np.asarray(wp) - p0, np.asarray(gp) - p0
        assert np.abs(dw).max() > 0, name
        change(dg, dw, name)


@pytest.mark.parametrize("name", ["moe_fsdp2_ep2", "moe_ep2_tp2_fwd"])
def test_moe_forward_over_ep_matches_jax(gang, name):
    """tiny_moe's logits with the experts over ep (each rank holds half
    of them; the dispatched tokens go to them by all-to-all) beside fsdp
    and beside tp (each expert's SwiGLU column- and row-parallel),
    against the JAX package's on the same mesh at ``test_moe.py``'s
    bound."""
    _, got, refs = gang
    g, w = got[name]["logits"], refs[name]["logits"]
    assert g.shape == w.shape == FWD_TOKENS + (256,)
    np.testing.assert_allclose(g, w, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", ["moe_fsdp2_ep2", "moe_tp2", "moe_sp2_ring",
                                  "moe_sp2_gather"])
def test_moe_decoder_layouts_match_jax_loop(gang, name):
    """Three SGD steps (each parameter's change is its summed gradient):
    experts over ep beside fsdp (an expert leaf's gradient summed over
    the loss ranks but ep, divided by all of them), over tp, and over sp
    (ring attention, or q/k/v gathered; the routed FFN on the sequence
    gathered over sp); the loss, aux loss and drop rate each step."""
    inp, got, refs = gang

    def change(dg, dw, name):
        np.testing.assert_allclose(dg, dw, rtol=0, atol=base.MOE_PARAM_ATOL, err_msg=name)

    _assert_moe_run(got[name], refs[name], inp["tiny_moe_params"],
                    dict(rtol=0, atol=base.MOE_LOSS_ATOL), base.MOE_LOSS_ATOL, change)


def test_int8_experts_over_ep_and_tp_match_jax_loop(gang):
    """Int8 experts at ep=2 x tp=2: each expert's products through
    ``maybe_quant_dot`` on the slots the all-to-all brought (their token
    scales over dp and fsdp, the split contraction's over tp): the loss
    within the int8 bound and each leaf's change within its relative L2
    bound."""
    inp, got, refs = gang

    def change(dg, dw, name):
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel <= base.INT8_LEAF_REL, (name, rel)

    _assert_moe_run(got["moe_int8_ep2_tp2"], refs["moe_int8_ep2_tp2"],
                    inp["tiny_moe_params"], dict(rtol=base.INT8_LOSS_RTOL),
                    INT8_MOE_METRIC_ATOL, change)


@pytest.mark.parametrize("name", ["int8_tp2", "int8_fused_tp2"])
def test_int8_decoder_at_tp2_matches_jax_loop(gang, name):
    """Int8 projections over tp=2 (d_model 128): a column-parallel
    projection's scales are local, a row-parallel one's span the
    tp-split contraction (MAX over tp) and its fp32 partials are summed
    over tp before the one rounding; ``int8_fused`` judges ``fusable``
    on the logical shapes, as the JAX package does. Three SGD steps: the
    loss within the int8 bound, each leaf's change within its relative
    L2 bound."""
    import jax

    inp, got, refs = gang
    base._assert_losses(got[name]["records"], refs[name]["records"], base.INT8_LOSS_RTOL)
    for (path, w), g, p0 in zip(base._leaves(refs[name]["params"]),
                                convert.tree_leaves(got[name]["params"]),
                                convert.tree_leaves(inp["wide_params"])):
        dw, dg = np.asarray(w) - p0, np.asarray(g) - p0
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel <= base.INT8_LEAF_REL, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("name", ["bert_tp2", "bert_fsdp2_tp2"])
def test_bert_over_tp_matches_jax_loop(gang, name):
    """BERT over tp (the vocabulary-split embedding's lookup and tied
    MLM head, ``mlm_dense`` gathered over tp before its norm, the biases
    of the column-parallel projections over tp) and over fsdp x tp, on
    padded rows: the loss and accuracy each step and the parameters after
    three AdamW steps within ``test_torch_parallel.py``'s BERT bounds."""
    _, got, refs = gang
    g, w = got[name], refs[name]
    base._assert_losses(g["records"], w["records"], base.LOSS_RTOL, extras=("mlm_accuracy",))
    base._assert_params(g["params"], w["params"], skip=("['layers']['bk']",))
    assert np.abs(g["params"]["layers"]["bk"]).max() <= 3 * base.LR


def test_8bit_adamw_on_sharded_leaves_matches_jax_and_restores(gang):
    """8-bit AdamW on the decoder's chunks at fsdp=2 x tp=2 (last axes
    split over tp, fsdp and both): the row statistics and the size
    threshold are the whole leaf's, so the gathered m codes and scales
    equal the JAX package's bit for bit, v codes within one code (C5)
    and its log range as ``test_torch_optim8.py`` holds it, and the
    parameters within its bound; the checkpoint (gathered by the mesh's
    first rank) restores in one process bit for bit."""
    from kubeflow_controller_tpu.ops import optim8 as jo8

    _, got, refs = gang
    g, w = got["opt8_fsdp2_tp2"], refs["opt8_fsdp2_tp2"]
    quantized = 0
    for i, (wm, wv) in enumerate(zip(convert.tree_leaves(w["m"]),
                                     convert.tree_leaves(w["v"]))):
        tm, tv = g["opt"]["m"][i], g["opt"]["v"][i]
        if isinstance(wm, jo8.QLeafM):
            quantized += 1
            np.testing.assert_array_equal(tm["q"].numpy(), np.asarray(wm.q), err_msg=str(i))
            np.testing.assert_array_equal(tm["scale"].numpy(), np.asarray(wm.scale),
                                          err_msg=str(i))
            diff = np.abs(tv["q"].numpy().astype(int) - np.asarray(wv.q).astype(int))
            assert diff.max() <= 1, i
            np.testing.assert_allclose(tv["lo"].numpy(), np.asarray(wv.lo), rtol=1e-6)
            np.testing.assert_allclose(tv["rng"].numpy(), np.asarray(wv.rng), rtol=1e-5)
        else:
            assert set(tm) == {"t"}
            np.testing.assert_allclose(tm["t"].numpy(), np.asarray(wm), rtol=1e-6,
                                       atol=1e-6 * np.abs(np.asarray(wm)).max())
    assert quantized >= 8
    for a, b in zip(convert.tree_leaves(g["params"]), convert.tree_leaves(w["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4 * base.LR)
    assert g["restored_step"] == 3
    for a, b in zip(convert.tree_leaves(g["restored"]), convert.tree_leaves(g["params"])):
        np.testing.assert_array_equal(a, b)
    assert g["restored_opt"]["count"] == g["opt"]["count"] == 3
    for key in ("m", "v"):
        for mine, saved in zip(g["restored_opt"][key], g["opt"][key]):
            assert set(mine) == set(saved)
            for k in mine:
                assert torch.equal(mine[k], saved[k]), (key, k)


def test_int8_weight_gradient_scales_span_the_data_ranks(gang):
    """C10: a projection's weight gradient contracts over the tokens, which
    the data ranks split; its int8 scales are the abs-max over every
    rank's tokens, as the JAX package takes them on the global arrays. With
    one rank's rows 100x the others', the sum of the ranks' dw equals
    ``jax.grad`` of the JAX ``int8_matmul`` on the whole batch within one
    quantum of the global scales (a rank's own scales would quantize the
    small rows' tokens 100x finer)."""
    _, got, refs = gang
    g, w = got["c10_dp2_fsdp2"]["dw"], refs["c10_dp2_fsdp2"]
    err = np.abs(g - w["dw"]) / w["quantum"]
    assert err.max() <= 1.0, err.max()


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_group_is_the_jax_shard_aligned_group(ep, monkeypatch):
    """The JAX package picks the routing group from the global token count
    with shard alignment over the data axes (its ``_moe_ffn`` under a
    mesh of ``ep`` data shards, traced, the group read where it
    dispatches); the
    port's ``moe_group`` of a rank's token count gives the same group,
    so each rank's groups are the global groups its rows hold. Counts and
    group sizes where the unaligned largest divisor differs are among
    them."""
    import jax
    import jax.numpy as jnp
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    seen = []
    dispatch = jtf._moe_dispatch_einsum

    def spy(cfg, x, picks, G, group, E, cap):
        seen.append(group)
        return dispatch(cfg, x, picks, G, group, E, cap)

    monkeypatch.setattr(jtf, "_moe_dispatch_einsum", spy)
    monkeypatch.setattr(jtf, "_mesh_axis_size", lambda *names: ep)
    lp = {"w_router": jnp.zeros((8, 4)), "w_gate": jnp.zeros((4, 8, 8)),
          "w_up": jnp.zeros((4, 8, 8)), "w_down": jnp.zeros((4, 8, 8))}
    checked = differs = 0
    for rows, seq, size in ((ep, 48, 32), (ep, 40, 24), (2 * ep, 36, 1024),
                            (ep, 100, 64), (3 * ep, 20, 45), (ep, 1024, 1024)):
        n = rows * seq
        cfg = jtf.tiny_moe_config(d_model=8, moe_group_size=size)
        seen.clear()
        jax.eval_shape(lambda h, cfg=cfg: jtf._moe_ffn(cfg, lp, h),
                       jax.ShapeDtypeStruct((rows, seq, 8), jnp.float32))
        assert seen == [ttf.moe_group(n // ep, size)], (rows, seq, size, seen)
        checked += 1
        differs += seen[0] != ttf.moe_group(n, size)
    assert checked == 6 and differs >= 2


def test_this_process_runs_one_intra_op_thread():
    """The JAX references and the checks here run beside the gang and
    other xdist workers on one intra-op thread."""
    assert torch.get_num_threads() == 1
