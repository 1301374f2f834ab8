"""The port's mesh, placements and memory plan against the JAX package's,
with no training and no collective.

Meshes are built in this one process: either with no process group (a
world of one) or, to see the mesh as each rank of an n-rank world sees
it, under torch's fake process group (``FakeStore``), which creates the
groups but runs no collective. The JAX side uses the 8 virtual CPU
devices of ``tests/conftest.py``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from kubeflow_controller_tpu.parallel import mesh as jmesh
from kubeflow_controller_tpu.parallel import memory as jmemory
from kubeflow_controller_tpu.parallel import sharding as jsharding
from kubeflow_controller_tpu_torch.dataplane import dist as tdist
from kubeflow_controller_tpu_torch.parallel import memory as tmemory
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh
from kubeflow_controller_tpu_torch.parallel import sharding as tsharding

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

LAYOUT_SIZES = (-1, 1, 2, 4, 8)


def _configs():
    """Every MeshConfig with dp in LAYOUT_SIZES and the other axes in
    {1, 2, 4} whose fixed axes hold at most 8 devices."""
    out = []
    for dp, fsdp, ep, sp, tp, pp in itertools.product(
            LAYOUT_SIZES, (1, 2, 4), (1, 2), (1, 2), (1, 2, 4), (1, 2)):
        if fsdp * ep * sp * tp * pp <= 8:
            out.append(dict(dp=dp, fsdp=fsdp, ep=ep, sp=sp, tp=tp, pp=pp))
    return out


def _resolve(cls, kw, n):
    try:
        return cls(**kw).resolve(n)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", range(1, 9))
def test_resolve_and_its_errors_match_jax(n):
    for kw in _configs():
        assert _resolve(tmesh.MeshConfig, kw, n) == _resolve(jmesh.MeshConfig, kw, n), kw


class _FakeWorld:
    """A world of ``size`` ranks seen from ``rank``: torch's fake process
    group (groups are created, no collective runs)."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank

    def __enter__(self):
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=self.size)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


def _jax_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


LAYOUTS = [(dict(dp=8), 8), (dict(dp=2, fsdp=4), 8), (dict(fsdp=2, tp=2), 4),
           (dict(dp=1, tp=2), 2), (dict(pp=2, fsdp=2, tp=2), 8),
           (dict(fsdp=2, ep=2, sp=2), 8)]


@pytest.mark.parametrize("kw,n", LAYOUTS, ids=[
    "-".join(f"{k}{v}" for k, v in kw.items()) for kw, _ in LAYOUTS])
def test_rank_coordinates_groups_and_rows_match_jax(kw, n):
    """Per rank: its position in the grid equals the device's in the JAX
    mesh over ``jax.devices()[:n]``, each axis group holds the ranks of
    its row, and its batch rows (grad_accum 1 and 2) equal the indices
    ``batch_sharding`` gives its device."""
    cfg = tmesh.MeshConfig(**kw)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**kw), jax.devices()[:n])
    ids = _jax_ids(jm)
    B = 8 * jmesh.data_shards(jm)
    want_rows = jmesh.batch_sharding(jm).devices_indices_map((B,))
    micro = jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, jmesh.batch_sharding(jm).spec[0]))
    want_micro = micro.devices_indices_map((2, B // 2))
    for rank in range(n):
        with _FakeWorld(n, rank):
            tm = tmesh.make_mesh(cfg)
            assert tm.shape == dict(jm.shape)
            np.testing.assert_array_equal(tm.devices, ids)
            pos = np.argwhere(ids == rank)[0]
            assert tm.coords == dict(zip(tmesh.AXES, (int(p) for p in pos)))
            for axis in tmesh.AXES:
                g = tm.group(axis)
                if jm.shape[axis] == 1:
                    assert g is None
                    continue
                row = np.moveaxis(ids, tmesh.AXES.index(axis), -1)[
                    tuple(p for i, p in enumerate(pos) if i != tmesh.AXES.index(axis))]
                assert dist.get_process_group_ranks(g) == [int(r) for r in row]
            dev = next(d for d in jax.devices()[:n] if d.id == rank)
            sl = want_rows[dev][0]
            np.testing.assert_array_equal(tmesh.batch_rows(tm, B), np.arange(B)[sl])
            rows2 = tmesh.batch_rows(tm, B, grad_accum=2)
            want2 = np.arange(B).reshape(2, B // 2)[want_micro[dev]].reshape(-1)
            np.testing.assert_array_equal(rows2, want2)


@pytest.mark.parametrize("kw,n", LAYOUTS, ids=[
    "-".join(f"{k}{v}" for k, v in kw.items()) for kw, _ in LAYOUTS])
def test_row_source_is_the_first_rank_holding_the_same_rows(kw, n):
    """``row_source``: the lowest rank whose batch rows are this rank's
    (the rank itself where no tp, sp or pp rank shares them), so that a
    stream seeded by it gives a data shard's ranks the same rows."""
    cfg = tmesh.MeshConfig(**kw)
    rows = {}
    for rank in range(n):
        with _FakeWorld(n, rank):
            tm = tmesh.make_mesh(cfg)
            rows[rank] = (tuple(tmesh.batch_rows(tm, 8 * tmesh.data_shards(tm))),
                          tmesh.row_source(tm))
    for rank, (mine, src) in rows.items():
        assert src == min(r for r, (other, _) in rows.items() if other == mine)
        if kw.get("tp", 1) == kw.get("sp", 1) == kw.get("pp", 1) == 1:
            assert src == rank


def test_multislice_rank_order_matches_jax():
    """Two slices of four: the dp axis is slice-major, with ranks grouped
    by their slice ids (here interleaved, as a scheduler may number
    them) and, without ids, split evenly in rank order as the JAX
    package does on the CPU."""
    cfg = dict(dp=4, tp=2)
    jm = jmesh.make_multislice_mesh(jmesh.MeshConfig(**cfg), 2, jax.devices()[:8])
    with _FakeWorld(8, 0):
        tm = tmesh.make_multislice_mesh(tmesh.MeshConfig(**cfg), 2)
        np.testing.assert_array_equal(tm.devices, _jax_ids(jm))
        ids = [r % 2 for r in range(8)]
        tm2 = tmesh.make_multislice_mesh(tmesh.MeshConfig(**cfg), 2, slice_ids=ids)
        assert set(tm2.devices[0, :2].reshape(-1)) == {0, 2, 4, 6}
        for bad, msg in ((dict(tp=8), "divisible by num_slices"), (dict(pp=2), "pp=1")):
            with pytest.raises(ValueError, match=msg):
                tmesh.make_multislice_mesh(tmesh.MeshConfig(**bad), 2)
            with pytest.raises(ValueError, match=msg):
                jmesh.make_multislice_mesh(jmesh.MeshConfig(**bad), 2, jax.devices()[:8])


def test_world_of_one_without_a_process_group():
    """No process group: make_mesh is a world of one rank and every
    group is None; the serving mesh of tp > 1 ranks cannot form in a
    world of one, and says so as the JAX package's does."""
    assert not dist.is_initialized()
    m = tmesh.make_mesh(tmesh.MeshConfig())
    assert m.size == 1 and m.coords == dict.fromkeys(tmesh.AXES, 0)
    assert all(m.group(a) is None for a in tmesh.AXES)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(tmesh.MeshConfig(tp=2))
    assert tmesh.serving_mesh(1) is None
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        tmesh.serving_mesh(2)


def test_initialize_from_env_single_process_makes_no_group():
    ctx = tdist.initialize_from_env({"JAX_NUM_PROCESSES": "1"})
    assert ctx.num_processes == 1 and not dist.is_initialized()
    tdist.require_process_group(ctx)
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        tdist.require_process_group(tdist.ProcessContext(num_processes=2))
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        tdist.initialize_from_env({"JAX_NUM_PROCESSES": "2"}, device="cpu")


def _jspecs_flat(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same_spec(port, ref):
    return tuple(port) == tuple(ref)


@pytest.mark.parametrize("name", ["tiny", "tiny_moe", "llama3_8b", "tied"])
def test_decoder_param_specs_match_jax(name):
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    kw = {"tie_embeddings": True} if name == "tied" else {}
    base = "tiny" if name == "tied" else name
    jc = getattr(jtf, f"{base}_config")(**kw)
    tc = getattr(ttf, f"{base}_config")(**kw)
    for pp in (False, True):          # pp: the layer axis over the stages
        want = _jspecs_flat(jtf.param_specs(jc, pp=pp))
        got = tsharding.spec_leaves(ttf.param_specs(tc, pp=pp))
        assert len(got) == len(want)
        assert all(_same_spec(g, w) for g, w in zip(got, want)), (pp, got, want)
    shapes = jax.tree.leaves(jax.eval_shape(lambda: jtf.init_params(jc, jax.random.key(0))))
    assert [tuple(s) for s in tsharding.spec_leaves(ttf.param_shapes(tc))] == [
        tuple(s.shape) for s in shapes]
    if name in ("tiny", "tiny_moe"):
        drawn = ttf.init_params(tc, device="cpu")
        from kubeflow_controller_tpu_torch.convert import tree_leaves
        assert [tuple(t.shape) for t in tree_leaves(drawn)] == [
            tuple(s) for s in tsharding.spec_leaves(ttf.param_shapes(tc))]


def test_bert_param_specs_match_jax():
    from kubeflow_controller_tpu.models import bert as jbert
    from kubeflow_controller_tpu_torch.models import bert as tbert

    want = _jspecs_flat(jbert.param_specs(jbert.bert_tiny_config()))
    got = tsharding.spec_leaves(tbert.param_specs(tbert.bert_tiny_config()))
    assert len(got) == len(want) and all(_same_spec(g, w) for g, w in zip(got, want))


def _jax_fsdp_mesh(fsdp):
    return jmesh.make_mesh(jmesh.MeshConfig(dp=-1, fsdp=fsdp), jax.devices()[:8])


def _fake_fsdp_mesh(fsdp):
    return tmesh.make_mesh(tmesh.MeshConfig(dp=-1, fsdp=fsdp))


@pytest.mark.parametrize("fsdp", [1, 2, 4, 8])
def test_infer_param_sharding_matches_jax_for_mnist_and_resnet50(fsdp):
    """The fsdp heuristic on MNIST's MLP and ResNet-50's tree: each leaf
    shards the same logical dimension as in the JAX package (ResNet's
    OIHW kernels read in flax's HWIO order, ties included)."""
    from kubeflow_controller_tpu.models import mnist as jmnist
    from kubeflow_controller_tpu.models import resnet as jresnet
    from kubeflow_controller_tpu_torch.convert import tree_leaves
    from kubeflow_controller_tpu_torch.models import mnist as tmnist
    from kubeflow_controller_tpu_torch.models import resnet as tresnet

    jm = _jax_fsdp_mesh(fsdp)
    with _FakeWorld(8, 0):
        tm = _fake_fsdp_mesh(fsdp)
        # MNIST: the same layout ([in, out] kernels).
        jv = jax.eval_shape(lambda: jmnist.MnistMLP().init(jax.random.key(0),
                                                             jax.numpy.zeros((1, 784))))
        want = [s.spec for s in jax.tree.leaves(jsharding.infer_param_sharding(jv["params"], jm))]
        tp = tmnist.MnistMLP().init(0, "cpu")
        got = tsharding.spec_leaves(tsharding.infer_param_sharding(tp, tm))
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
        # ResNet-50.
        jparams = jax.eval_shape(jresnet.make_init_fn(jresnet.resnet50(), 224),
                                 jax.random.key(0))[0]
        want = jax.tree.leaves(jsharding.infer_param_sharding(jparams, jm))
        tparams, _ = tresnet.resnet50().init(0, "cpu")
        leaves = tree_leaves(tparams)
        got = tsharding.spec_leaves(tsharding.infer_param_sharding(
            tparams, tm, reference_axes=tresnet.flax_axes))
        n_sharded = 0
        for t, g, w in zip(leaves, got, want):
            order = tresnet.flax_axes(t) or tuple(range(t.ndim))
            g = list(g) + [None] * (t.ndim - len(g))
            w = list(w.spec) + [None] * (t.ndim - len(w.spec))
            assert [g[order[j]] for j in range(t.ndim)] == w
            n_sharded += any(g)
        assert (n_sharded > 0) == (fsdp > 1)


def test_placements_and_local_shards():
    """``placements``: one DTensor placement per mesh axis; two axes on
    one dimension nest in mesh order, as ``local_shard`` cuts them."""
    from torch.distributed.tensor import Replicate, Shard

    t = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    spec = tsharding.P(None, ("fsdp", "tp"))
    for rank in range(4):
        with _FakeWorld(4, rank):
            m = tmesh.make_mesh(tmesh.MeshConfig(dp=1, fsdp=2, tp=2))
            pl = tsharding.placements(spec, m, 2)
            assert pl == [Replicate(), Replicate(), Shard(1), Replicate(),
                          Replicate(), Shard(1)]
            torch.testing.assert_close(tsharding.local_shard(t, spec, m),
                                       t[:, 2 * rank:2 * rank + 2])
            torch.testing.assert_close(
                tsharding.local_shard(t, tsharding.P("tp", "fsdp"), m),
                t.reshape(2, 2, 2, 4)[m.coords["tp"], :, m.coords["fsdp"]])
            with pytest.raises(NotImplementedError, match="mesh order"):
                tsharding.local_shard(t, tsharding.P(None, ("tp", "fsdp")), m)
    assert tuple(tsharding.logical_to_mesh(("embed", None, "fsdp", "batch"))) == tuple(
        jsharding.logical_to_mesh(("embed", None, "fsdp", "batch")))


CHUNK_SPECS = [tsharding.P(), tsharding.P("fsdp"), tsharding.P(None, "tp"),
               tsharding.P(("fsdp", "tp")), tsharding.P("pp", "fsdp", "tp"),
               tsharding.P("ep", None, ("sp", "tp"))]


@pytest.mark.parametrize("kw,n", LAYOUTS, ids=[
    "-".join(f"{k}{v}" for k, v in kw.items()) for kw, _ in LAYOUTS])
def test_checkpoint_chunks_tile_each_leaf_once(kw, n):
    """A checkpoint's geometry (C11): on every rank ``chunk_box`` is the
    region ``local_shard`` cuts; ``chunk_writers`` names each distinct
    chunk once (the rank at coordinate 0 on the axes that do not shard
    the leaf, so a replicated leaf is the first rank's), and
    ``fill_box`` rebuilds from those chunks the whole leaf and any
    rank's region, without reading a chunk that does not overlap it."""
    t = torch.arange(8 * 4 * 8, dtype=torch.float32).reshape(8, 4, 8)

    def region(box):
        return t[tuple(slice(lo, hi) for lo, hi in box)]

    for rank in range(n):
        with _FakeWorld(n, rank):
            m = tmesh.make_mesh(tmesh.MeshConfig(**kw))
            for spec in CHUNK_SPECS:
                box = tsharding.chunk_box(t.shape, spec, m)
                mine = tsharding.local_shard(t, spec, m)
                assert torch.equal(region(box), mine), (spec, rank)
                writers = tsharding.chunk_writers(t.shape, spec, m)
                boxes = [b for _, b in writers]
                assert len(set(boxes)) == len(boxes) and box in boxes
                assert sum(region(b).numel() for b in boxes) == t.numel()
                for r, b in writers:
                    coords = dict(zip(tmesh.AXES, np.argwhere(m.devices == r)[0]))
                    sharding_axes = {a for axes in tsharding.effective(spec, m, 3) for a in axes}
                    assert not any(coords[a] for a in tmesh.AXES if a not in sharding_axes)
                read = []
                pieces = [(b, lambda b=b: read.append(b) or region(b)) for b in boxes]
                whole = ((0, 8), (0, 4), (0, 8))
                assert torch.equal(tsharding.fill_box(torch.empty_like(t), whole, pieces), t)
                read.clear()
                got = tsharding.fill_box(torch.empty_like(mine), box, pieces)
                assert torch.equal(got, mine) and read == [box], (spec, rank, read)
                assert tsharding.whole_shape(mine.shape, spec, m) == tuple(t.shape)


def test_opt_state_specs_follow_their_parameters():
    """Moments shaped as their parameter's chunk take its spec; step
    counts and other shapes are replicated."""
    specs = [tsharding.P("fsdp", None), tsharding.P(None, "tp")]
    shapes = [(4, 3), (3, 3)]
    state = {0: {"step": torch.tensor(2.0), "exp_avg": torch.zeros(4, 3)},
             1: {"momentum_buffer": torch.zeros(3, 3), "scale": torch.zeros(3, 1)}}
    got = tsharding.opt_state_specs(state, shapes, specs)
    assert got == {0: {"step": (), "exp_avg": specs[0]},
                   1: {"momentum_buffer": specs[1], "scale": ()}}


MEM_CASES = [("flagship", dict(dp=2), 16, 1024), ("flagship", dict(fsdp=2), 16, 1024),
             ("flagship", dict(tp=2), 16, 1024), ("llama3_8b", dict(fsdp=2), 2, 2048),
             ("llama3_8b", dict(dp=2, fsdp=16, tp=4), 256, 8192),
             ("tiny_moe", dict(fsdp=2, ep=2), 8, 64)]


@pytest.mark.parametrize("name,axes,batch,seq", MEM_CASES,
                         ids=[f"{c[0]}-{'-'.join(f'{k}{v}' for k, v in c[1].items())}"
                              for c in MEM_CASES])
def test_transformer_memory_plan_matches_jax_byte_for_byte(name, axes, batch, seq):
    from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
    from kubeflow_controller_tpu.models import transformer as jtf
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    jc = (jtf.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=16, n_heads=8,
                                n_kv_heads=8, d_ff=4096, max_seq=1024)
          if name == "flagship" else jlm.CONFIGS[name]())
    tc = getattr(ttf, f"{name}_config")()
    want = jmemory.transformer_memory_plan(jc, axes, batch, seq)
    got = tmemory.transformer_memory_plan(tc, axes, batch, seq)
    assert got.rows() == want.rows()
    assert got.fits(80) == want.fits(80)
    assert tmemory.sharded_leaf_bytes((7, 8), 4, ("fsdp", "tp"), {"fsdp": 2, "tp": 4}) == \
        jmemory.sharded_leaf_bytes((7, 8), 4, ("fsdp", "tp"), {"fsdp": 2, "tp": 4})


def test_memory_plan_with_pp_counts_a_stages_layers():
    """``pp=True`` places the parameters by ``param_specs(cfg, pp=True)``:
    a stage stores its block of layers and the whole embedding, head and
    final norm (the JAX package's plan has no pp placement); the other
    terms are the plan without it."""
    from kubeflow_controller_tpu_torch.models import transformer as ttf

    cfg = ttf.flagship_config()
    base = tmemory.transformer_memory_plan(cfg, {"pp": 2}, 16, 1024)
    got = tmemory.transformer_memory_plan(cfg, {"pp": 2}, 16, 1024, pp=True)
    shapes = ttf.param_shapes(cfg)
    layer_bytes = sum(4 * int(np.prod(s)) for s in shapes["layers"].values())
    assert base.params - got.params == layer_bytes // 2
    assert (got.grads, got.opt_state) == (got.params, 2 * got.params)
    assert (got.activations, got.logits) == (base.activations, base.logits)
