"""The port's MNIST, ResNet and BERT models and their entry points held
against the JAX package on the CPU.

Weights come from the JAX package's flax or functional init and cross
as numpy arrays (``convert.mnist_params_from_flax``,
``resnet_params_from_flax``, ``params_from_numpy``); inputs are drawn
with numpy from fixed seeds. Everything runs in fp32, where the two
frameworks differ only in the order they reduce the same products
(measured: logits within 1e-6, BatchNorm statistics within 5e-7), so
the tolerances are LOGITS_ATOL = 1e-5, STATS_ATOL = 1e-5, LOSS_RTOL =
1e-5, and gradients within 1e-5 of each leaf's largest element (rtol
1e-4). After optimizer steps the differences grow with the learning
rate; those tests state their own.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.models import bert as jbert
from kubeflow_controller_tpu.models import mnist as jmnist
from kubeflow_controller_tpu.models import resnet as jresnet
from kubeflow_controller_tpu_torch import convert, optim
from kubeflow_controller_tpu_torch.dataplane.entrypoints import bert as tbert_entry
from kubeflow_controller_tpu_torch.dataplane.entrypoints import mnist as tmnist_entry
from kubeflow_controller_tpu_torch.dataplane.entrypoints import resnet as tresnet_entry
from kubeflow_controller_tpu_torch.models import bert as tbert
from kubeflow_controller_tpu_torch.models import mnist as tmnist
from kubeflow_controller_tpu_torch.models import resnet as tresnet

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

LOGITS_ATOL = 1e-5
STATS_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_close(got, want, atol_of_max=GRAD_ATOL_OF_MAX, rtol=GRAD_RTOL):
    """Leaf by leaf in sorted-key order (both packages' tree order)."""
    names = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(names, convert.tree_leaves(got)):
        w = np.asarray(w)
        # A leaf that is zero but for fp32 noise (BERT's key bias: softmax
        # ignores a shift of every key) is held to an absolute 1e-7.
        np.testing.assert_allclose(
            _np(g), w, rtol=rtol,
            atol=max(atol_of_max * float(np.abs(w).max()), 1e-7),
            err_msg=jax.tree_util.keystr(path))


# -- MNIST ----------------------------------------------------------------------

MNIST_MODELS = {"mlp": (jmnist.MnistMLP, tmnist.MnistMLP),
                "softmax": (jmnist.SoftmaxRegression, tmnist.SoftmaxRegression)}


def _mnist_pair(name, hidden=None):
    jcls, tcls = MNIST_MODELS[name]
    kw = {} if hidden is None or name == "softmax" else dict(hidden=hidden)
    jm, tm = jcls(**kw), tcls(**kw)
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((2, 784))))
    return jm, tm, variables, convert.mnist_params_from_flax(variables, "cpu")


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("name", sorted(MNIST_MODELS))
def test_mnist_logits_loss_and_eval_metrics_match_jax(name, uint8):
    """Logits, the loss with its accuracy and the eval metrics, on byte
    images (normalized on the device) and on float images."""
    jm, tm, variables, params = _mnist_pair(name, hidden=48)
    batch = next(jmnist.synthetic_mnist(16, seed=3, uint8=uint8))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(_np(tm.apply(params, tb["image"])),
                               np.asarray(jm.apply(variables, batch["image"])),
                               rtol=0, atol=LOGITS_ATOL)
    lj, mj = jmnist.make_loss_fn(jm)(variables, batch, None)
    lt, mt = tmnist.make_loss_fn(tm)(params, tb)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    assert float(mt["accuracy"]) == float(mj["accuracy"])
    ej = jmnist.make_eval_fn(jm)(variables, batch)
    et = tmnist.make_eval_fn(tm)(params, tb)
    assert set(et) == set(ej) == {"cross_entropy", "accuracy"}
    np.testing.assert_allclose(float(et["cross_entropy"]),
                               float(ej["cross_entropy"]), rtol=LOSS_RTOL)
    assert float(et["accuracy"]) == float(ej["accuracy"])


def test_mnist_normalize_is_bitwise_the_jitted_jax():
    """uint8 -> fp32 gives the bits the JAX package computes under
    ``jit``, where XLA turns ``/ 127.5 - 1`` into an FMA with the fp32
    reciprocal (C5; the eager division differs in 205 of 256 codes)."""
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(jmnist._normalize)(jnp.asarray(x)))
    got = tmnist._normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mnist_loss_gradients_match_jax():
    jm, tm, variables, params = _mnist_pair("mlp")
    batch = next(jmnist.synthetic_mnist(32, seed=4, uint8=True))
    gj = jax.grad(lambda v: jmnist.make_loss_fn(jm)(v, batch, None)[0])(variables)
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(params)]
    lt, _ = tmnist.make_loss_fn(tm)(params, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    grads = torch.autograd.grad(lt, leaves)
    _assert_trees_close(convert.tree_unflatten(params, grads), gj["params"])


def test_mnist_streams_and_idx_files_match_jax(tmp_path):
    """The synthetic stream is the JAX package's byte for byte; idx files
    written by the port read back the same through both packages, plain
    and gzipped, and ``mnist_from_data_dir`` finds them by their
    canonical names."""
    for uint8 in (True, False):
        js = jmnist.synthetic_mnist(8, seed=2, uint8=uint8)
        ts = tmnist.synthetic_mnist(8, seed=2, uint8=uint8)
        for _ in range(3):
            a, b = next(js), next(ts)
            for k in ("image", "label"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (30, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 30).astype(np.uint8)
    tmnist.write_idx(str(tmp_path / "train-images-idx3-ubyte.gz"), imgs)
    tmnist.write_idx(str(tmp_path / "train-labels-idx1-ubyte"), labels)
    for path, arr in (("train-images-idx3-ubyte.gz", imgs),
                      ("train-labels-idx1-ubyte", labels)):
        np.testing.assert_array_equal(jmnist.load_idx(str(tmp_path / path)), arr)
        np.testing.assert_array_equal(tmnist.load_idx(str(tmp_path / path)), arr)
    jd, td = jmnist.mnist_from_data_dir(str(tmp_path)), tmnist.mnist_from_data_dir(str(tmp_path))
    assert sorted(jd) == sorted(td) == ["train_images", "train_labels"]
    for k in jd:
        np.testing.assert_array_equal(jd[k], td[k])
    a = jmnist.idx_batches(jd["train_images"], jd["train_labels"], 7, seed=3)
    b = tmnist.idx_batches(td["train_images"], td["train_labels"], 7, seed=3)
    for _ in range(6):                     # across an epoch boundary
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["label"], y["label"])
    with pytest.raises(ValueError, match="exceeds dataset size"):
        next(tmnist.idx_batches(td["train_images"], td["train_labels"], 31))


def test_mnist_train_on_idx_files_reports_test_accuracy(tmp_path):
    """``train(data_dir)`` on idx files the port wrote (a learnable
    task: the synthetic teacher's labels): in-loop evaluation every
    ``total_steps // 5`` steps over the test split, and
    ``test_accuracy`` over all of it, above chance."""
    stream = tmnist.synthetic_mnist(600, seed=0, uint8=True)
    train, test = next(stream), next(stream)
    for split, batch in (("train", train), ("t10k", test)):
        tmnist.write_idx(str(tmp_path / f"{split}-images-idx3-ubyte"),
                         batch["image"].reshape(-1, 28, 28))
        tmnist.write_idx(str(tmp_path / f"{split}-labels-idx1-ubyte"),
                         batch["label"].astype(np.uint8))
    out = tmnist_entry.train(total_steps=30, batch_size=50, hidden=32,
                             data_dir=str(tmp_path), device="cpu")
    assert out["final_step"] == 30
    assert {"val_cross_entropy", "val_accuracy", "test_accuracy"} <= set(out)
    # Chance is 0.1; 600 samples of a 784-wide teacher task generalize
    # only so far (measured 0.23).
    assert out["test_accuracy"] > 0.15


# -- ResNet ---------------------------------------------------------------------

@functools.lru_cache(None)
def _flax_resnet_tiny(seed):
    """resnet_tiny's flax ``(params, batch_stats)`` as numpy (read only)."""
    jm = jresnet.resnet_tiny()
    return jax.device_get(jax.jit(jresnet.make_init_fn(jm, 16))(jax.random.key(seed)))


def _resnet_pair(seed=0, perturb=True):
    """resnet_tiny in both packages on the same weights; ``perturb`` moves
    the BN scales, biases and running statistics off their init values
    (the last BN of each block starts at scale 0, which would hide its
    path)."""
    jm = jresnet.resnet_tiny()
    params, stats = _flax_resnet_tiny(seed)
    if perturb:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params)
        stats = jax.tree.map(
            lambda x: (0.5 + rng.random(x.shape)).astype(np.float32), stats)
    tp, ts = convert.resnet_params_from_flax(params, stats, "cpu")
    return jm, tresnet.resnet_tiny(), params, stats, tp, ts


@pytest.mark.parametrize("size", [16, 17], ids=["even", "odd"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet_tiny_logits_and_batch_stats_match_jax(train, size):
    """Logits in train mode (batch statistics, and the new running
    statistics) and in eval mode (running statistics), on uint8 images of
    an even and an odd size (every stride-2 layer pads asymmetrically)."""
    jm, tm, params, stats, tp, ts = _resnet_pair()
    img = np.random.default_rng(size).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    variables = {"params": params, "batch_stats": stats}
    if train:
        lj, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, img)
    else:
        lj, upd = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, img), None
    lt, new = tm.apply(tp, ts, torch.from_numpy(img), train=train)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=LOGITS_ATOL)
    if train:
        _assert_trees_close(new, jax.device_get(upd["batch_stats"]),
                            atol_of_max=STATS_ATOL, rtol=0)
    else:
        assert new is None


@pytest.mark.parametrize("size,k,stride", [
    (16, 7, 2), (17, 7, 2), (8, 3, 2), (9, 3, 2), (9, 3, 1), (10, 1, 2),
])
def test_same_padding_matches_flax(size, k, stride):
    """flax's SAME padding (asymmetric under stride 2, on odd and even
    sizes) for the convolution and for the max pool (pads with -inf)."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tresnet.conv_same(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    pool = nn.max_pool(x - 10.0, (3, 3), (2, 2), padding="SAME")
    got = tresnet.max_pool_same(xt - 10.0)
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)), np.asarray(pool))


def test_resnet_uint8_wire_and_float_streams_match_jax():
    """``synthetic_imagenet`` byte for byte, uint8 and fp32; a uint8 image
    and its normalized fp32 copy give the same logits (the bytes are
    normalized in fp32 on the device)."""
    for uint8 in (True, False):
        a = next(jresnet.synthetic_imagenet(3, 12, 10, seed=4, uint8=uint8))
        b = next(tresnet.synthetic_imagenet(3, 12, 10, seed=4, uint8=uint8))
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    _, tm, _, _, tp, ts = _resnet_pair()
    img = next(tresnet.synthetic_imagenet(2, 12, 10, seed=1, uint8=True))["image"]
    # The jitted reference's normalization: one rounding of x * r - 1.
    as_float = torch.from_numpy(
        (img * np.float64(np.float32(1 / 127.5)) - 1.0).astype(np.float32))
    a, _ = tm.apply(tp, ts, torch.from_numpy(img), train=False)
    b, _ = tm.apply(tp, ts, as_float, train=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_resnet_batch_stats_after_three_stateful_steps_match_jax():
    """Three steps of the entry point's recipe (the stateful loss, SGD
    with Nesterov momentum 0.9 under warmup-cosine at lr 0.1) from the
    same weights: the loss each step, the BN running statistics and the
    parameters after. lr 0.1 lets fp32 reduction order grow over the
    steps: statistics within 1e-4 of each leaf's largest element,
    parameters within 1e-4 of theirs."""
    jm, tm, params, stats, tp, ts = _resnet_pair(perturb=False)
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 3)
    tx = optax.sgd(sched, momentum=0.9, nesterov=True)
    opt_state = tx.init(params)
    topt = optim.SGD(optim.warmup_cosine_decay_schedule(0.0, 0.1, 2, 3),
                     momentum=0.9, nesterov=True)
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    topt.init(tp)
    jloss, tloss = jresnet.make_loss_fn(jm), tresnet.make_loss_fn(tm)
    stream = jresnet.synthetic_imagenet(8, 16, 10, seed=2, uint8=True)

    @jax.jit
    def jstep(params, stats, opt_state, batch):
        (lj, (_, stats)), gj = jax.value_and_grad(
            lambda p: jloss(p, stats, batch, None), has_aux=True)(params)
        updates, opt_state = tx.update(gj, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, lj

    for _ in range(3):
        batch = next(stream)
        params, stats, opt_state, lj = jstep(params, stats, opt_state, batch)
        lt, (_, ts) = tloss(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(lt, leaves)
        topt.update(tp, convert.tree_unflatten(tp, grads))
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    jp, js = convert.resnet_params_to_flax(tp, ts)
    _assert_trees_close(js, jax.device_get(stats), atol_of_max=1e-4, rtol=0)
    _assert_trees_close(jp, jax.device_get(params), atol_of_max=1e-4, rtol=0)


def test_resnet_params_round_trip_through_flax_layout():
    _, _, params, stats, tp, ts = _resnet_pair()
    back_p, back_s = convert.resnet_params_to_flax(tp, ts)
    for a, b in zip(jax.tree.leaves(back_p), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(back_s), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)


def test_resnet_train_runs_on_cpu_and_moves_batch_stats():
    out = tresnet_entry.train(total_steps=2, per_chip_batch=4, image_size=16,
                              model=tresnet.resnet_tiny(), device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    assert out["images_per_sec_per_chip"] == out["images_per_sec"] > 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tresnet_entry.train(total_steps=2, model=tresnet.resnet_tiny())


# -- BERT -----------------------------------------------------------------------

def _bert_pair(**kw):
    cfg_j, cfg_t = jbert.bert_tiny_config(**kw), tbert.bert_tiny_config(**kw)
    params = jax.device_get(jbert.init_params(cfg_j, jax.random.key(0)))
    return cfg_j, cfg_t, params, convert.params_from_numpy(params, device="cpu")


def _padded_batch(cfg, b=3, s=32, seed=1):
    """An MLM batch whose rows 1 and 2 pad their tails."""
    batch = next(jbert.synthetic_mlm_batch(cfg, b, s, seed=seed))
    batch["attention_mask"][1, 20:] = 0
    batch["attention_mask"][2, 9:] = 0
    return batch


def test_bert_encode_matches_jax_with_padding_isolated():
    """``encode`` with padded rows: the hidden states equal the JAX
    package's, and in both packages the real tokens' states do not
    move when the pad tokens change (segment ids 1/0 keep them apart)."""
    cfg_j, cfg_t, params, tp = _bert_pair()
    batch = _padded_batch(cfg_j)
    hj = np.asarray(jbert.encode(cfg_j, params, batch["tokens"], batch["attention_mask"]))
    ht = _np(tbert.encode(cfg_t, tp, torch.from_numpy(batch["tokens"]),
                          torch.from_numpy(batch["attention_mask"])))
    np.testing.assert_allclose(ht, hj, rtol=0, atol=LOGITS_ATOL)
    other = batch["tokens"].copy()
    pad = batch["attention_mask"] == 0
    other[pad] = (other[pad] + 7) % cfg_j.vocab_size
    hj2 = np.asarray(jbert.encode(cfg_j, params, other, batch["attention_mask"]))
    ht2 = _np(tbert.encode(cfg_t, tp, torch.from_numpy(other),
                           torch.from_numpy(batch["attention_mask"])))
    real = ~pad
    np.testing.assert_allclose(ht2[real], ht[real], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hj2[real], hj[real], rtol=0, atol=1e-6)
    assert np.abs(ht2[pad] - ht[pad]).max() > 1e-3


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_bert_mlm_loss_and_gradients_match_jax(remat):
    cfg_j, cfg_t, params, tp = _bert_pair(remat=remat)
    batch = _padded_batch(cfg_j)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jbert.mlm_loss(cfg_j, p, batch), has_aux=True)(params)
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    lt, mt = tbert.mlm_loss(cfg_t, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    assert float(mt["mlm_accuracy"]) == float(mj["mlm_accuracy"])
    _assert_trees_close(convert.tree_unflatten(tp, grads), jax.device_get(gj))


def test_bert_int8_projections_match_jitted_jax():
    """``quant="int8"`` (the composed int8 path, as the JAX package
    trains it under ``jit``): the loss within 1e-5 relative."""
    cfg_j, cfg_t, params, tp = _bert_pair(quant="int8")
    batch = _padded_batch(cfg_j)
    lj, _ = jax.jit(functools.partial(jbert.mlm_loss, cfg_j))(params, batch)
    lt, _ = tbert.mlm_loss(cfg_t, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)


def test_bert_stream_matches_jax_and_train_runs_on_cpu():
    cfg_j, cfg_t = jbert.bert_tiny_config(), tbert.bert_tiny_config()
    a, b = jbert.synthetic_mlm_batch(cfg_j, 4, 24, seed=3), tbert.synthetic_mlm_batch(cfg_t, 4, 24, seed=3)
    for _ in range(2):
        x, y = next(a), next(b)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    out = tbert_entry.train(total_steps=2, per_data_shard_batch=2, seq_len=24,
                            cfg=cfg_t, device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    assert out["tokens_per_sec"] > 0 and "mlm_accuracy" in out
    # A mesh (refused until multi-process training was ported): dp and
    # fsdp train over a job's ranks, which one process cannot fill. tp
    # (refused until BERT over tp was ported) takes two steps (the fewest
    # its schedule takes) over a two-rank mesh under the fake process
    # group, where no collective runs, so
    # only the run is checked here (tests/test_torch_parallel_ep.py holds
    # BERT over tp to the JAX loop).
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig

    with pytest.raises(ValueError, match="not divisible"):
        tbert_entry.train(total_steps=1, cfg=cfg_t, mesh_config=MeshConfig(fsdp=2),
                          device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        out = tbert_entry.train(ProcessContext(num_processes=2, process_id=0),
                                total_steps=2, per_data_shard_batch=2, seq_len=24,
                                cfg=cfg_t, mesh_config=MeshConfig(tp=2), device="cpu")
    finally:
        dist.destroy_process_group()
    assert out["final_step"] == 2


def test_bert_three_adamw_steps_match_optax():
    """Three steps of the BERT entry point's optimizer (``adamw`` with
    weight decay 0.01 on every leaf under warmup-cosine, lr 1e-2 here)
    from the same weights on padded batches: the loss each step, and
    the parameters after within lr / 1000. The key bias is the
    exception: its gradient is zero but for fp32 noise (softmax ignores
    a shift of every key), and Adam's step divides by the gradient's
    own size, so each package moves it by up to lr a step in a
    direction of its own: the reference's bk gradient is checked to be
    within 16 fp32 epsilons of wk's each step, and both packages' bk
    are held to |bk| <= 3 lr."""
    cfg_j, cfg_t, params, tp = _bert_pair()
    lr = 1e-2
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 1, 3)
    tx = optax.adamw(sched, weight_decay=0.01)
    opt_state = tx.init(params)
    topt = optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, lr, 1, 3),
                       weight_decay=0.01)
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    topt.init(tp)

    @jax.jit
    def jstep(params, opt_state, batch):
        (lj, _), gj = jax.value_and_grad(
            lambda p: jbert.mlm_loss(cfg_j, p, batch), has_aux=True)(params)
        updates, opt_state = tx.update(gj, opt_state, params)
        g_bk, g_wk = (jnp.abs(gj["layers"][k]).max() for k in ("bk", "wk"))
        return optax.apply_updates(params, updates), opt_state, lj, g_bk, g_wk

    for seed in range(3):
        batch = _padded_batch(cfg_j, seed=seed)
        params, opt_state, lj, g_bk, g_wk = jstep(params, opt_state, batch)
        assert float(g_bk) <= 16 * np.finfo(np.float32).eps * float(g_wk), (g_bk, g_wk)
        lt, _ = tbert.mlm_loss(cfg_t, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        topt.update(tp, convert.tree_unflatten(tp, torch.autograd.grad(lt, leaves)))
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    for (path, b), a in zip(want, convert.tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        if name == "['layers']['bk']":
            assert np.abs(_np(a)).max() <= 3 * lr and np.abs(b).max() <= 3 * lr
            continue
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=lr / 1000,
                                   err_msg=name)
