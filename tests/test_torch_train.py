"""The port's training path (``kubeflow_controller_tpu_torch``: the LM
streams, the decoder's loss and gradients, the optimizer, ``TrainLoop``
and ``lm.train``) held against the JAX package on the CPU.

Weights come from the JAX package's ``init_params`` and cross as numpy
arrays (``convert.params_from_numpy``); batches come from each package's
own stream, which must be the same bytes. Most tests run in fp32 on the
CPU, where the two frameworks differ only in the order they reduce the
same products: losses agree to ~5e-7 and every gradient leaf to ~2e-6 of
its largest element (measured), so the tolerances below are LOSS_RTOL =
1e-5 and a gradient atol of 1e-5 of the leaf's largest element (with
rtol 1e-4 for the large elements). The bf16 tests state their own.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
from kubeflow_controller_tpu.models import transformer as jtf
from kubeflow_controller_tpu_torch import convert, optim
from kubeflow_controller_tpu_torch.dataplane import train as ttrain
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm as tlm
from kubeflow_controller_tpu_torch.models import transformer as ttf

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5

# head_dim 64 at S=256: the JAX package's flash path (interpret mode,
# default blocks -> one 256 tile, the fused backward) vs the port's.
FLASH_KW = dict(d_model=128, n_heads=2, n_kv_heads=1, max_seq=256)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _jax_params(cfg, seed=0):
    return jax.device_get(jtf.init_params(cfg, jax.random.key(seed)))


def _assert_grads_close(got, want, names):
    for n, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()),
            err_msg=n)


# -- streams ------------------------------------------------------------------

@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
def test_synthetic_lm_streams_are_byte_equal(pack):
    js = jlm.synthetic_lm(300, 3, 64, seed=5, pack=pack)
    ts = tlm.synthetic_lm(300, 3, 64, seed=5, pack=pack)
    for _ in range(4):
        a, b = next(js), next(ts)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_lm_pack_refuses_short_rows():
    for mod in (jlm, tlm):
        with pytest.raises(ValueError, match="seq_len >= 32"):
            next(mod.synthetic_lm(100, 1, 16, pack=True))


def _write_corpus(tmp_path, n, dtype="uint16", vocab=None, hi=500):
    path = os.path.join(tmp_path, "train.bin")
    np.random.default_rng(0).integers(0, hi, n).astype(dtype).tofile(path)
    meta = {"dtype": dtype}
    if vocab is not None:
        meta["vocab_size"] = vocab
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_token_bin_lm_streams_are_byte_equal(tmp_path, dtype):
    path = _write_corpus(str(tmp_path), 5000, dtype)
    js = jlm.token_bin_lm(path, 4, 32, seed=2, vocab_size=512)
    ts = tlm.token_bin_lm(path, 4, 32, seed=2, vocab_size=512)
    for _ in range(3):
        a, b = next(js), next(ts)
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_token_bin_lm_checks_match(tmp_path):
    d = str(tmp_path)
    short = _write_corpus(d, 20)
    for mod in (jlm, tlm):
        with pytest.raises(ValueError, match="seq_len\\+2"):
            mod.token_bin_lm(short, 2, 32)
    wide = _write_corpus(d, 5000, vocab=1000)
    for mod in (jlm, tlm):
        with pytest.raises(ValueError, match="tokenizer mismatch"):
            mod.token_bin_lm(wide, 2, 32, vocab_size=512)
    out_of_range = _write_corpus(d, 5000, hi=600)
    for mod in (jlm, tlm):
        stream = mod.token_bin_lm(out_of_range, 8, 32, vocab_size=512)
        with pytest.raises(ValueError, match="out of range"):
            for _ in range(20):
                next(stream)


# -- model --------------------------------------------------------------------

def test_packed_positions_match():
    segs = next(jlm.synthetic_lm(256, 4, 128, seed=3, pack=True))["segment_ids"]
    want = np.asarray(jtf.packed_positions(jnp.asarray(segs)))
    got = ttf.packed_positions(torch.from_numpy(segs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attn,pack", [
    ("xla", False), ("xla", True), ("flash", False), ("flash", True),
], ids=["xla", "xla_packed", "flash_hd64", "flash_hd64_packed"])
def test_loss_and_every_gradient_match_jax(attn, pack):
    kw = FLASH_KW if attn == "flash" else {}
    seq = 256 if attn == "flash" else 64
    jc = jtf.tiny_config(attn_impl=attn, **kw)
    tc = ttf.tiny_config(attn_impl=attn, **kw)
    params = _jax_params(jc)
    batch = next(jlm.synthetic_lm(jc.vocab_size, 2, seq, seed=1, pack=pack))
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jtf.next_token_loss(
            jc, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    lt, mt = ttf.next_token_loss(tc, tp, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(mt["perplexity"].detach()),
                               float(mj["perplexity"]), rtol=LOSS_RTOL)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]))
    _assert_grads_close(gt, convert.tree_leaves(jax.device_get(gj)), _names(params))


def test_chunked_loss_matches_jax():
    jc, tc = jtf.tiny_config(), ttf.tiny_config()
    params = _jax_params(jc)
    batch = next(jlm.synthetic_lm(jc.vocab_size, 2, 64, seed=2))
    lj, _ = jtf.next_token_loss(jc, params, {"tokens": jnp.asarray(batch["tokens"])},
                                loss_chunk=24)
    tp = convert.params_from_numpy(params, device="cpu")
    lt, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(batch["tokens"])},
                                loss_chunk=24)
    lf, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(lt.detach()), float(lf), rtol=LOSS_RTOL)


def test_masked_loss_matches_jax():
    jc, tc = jtf.tiny_config(), ttf.tiny_config()
    params = _jax_params(jc)
    batch = next(jlm.synthetic_lm(jc.vocab_size, 2, 64, seed=4))
    mask = np.ones_like(batch["tokens"])
    mask[:, 40:] = 0
    lj, _ = jtf.next_token_loss(jc, params, {"tokens": jnp.asarray(batch["tokens"]),
                                             "mask": jnp.asarray(mask)})
    tp = convert.params_from_numpy(params, device="cpu")
    lt, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(batch["tokens"]),
                                         "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)


# bf16 compute (fp32 master weights): both packages round at the JAX
# package's points, but XLA's CPU backend and PyTorch's round some bf16
# matmul outputs and elementwise chains at different places, one bf16 ulp
# (2^-8) of an activation each; through two layers forward and back the
# worst leaf's relative L2 difference read 1.9e-2 and the loss 2.7e-4
# (measured over three seeds, xla and flash).
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_REL_L2 = 4e-2


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_bf16_loss_and_every_gradient_match_jax(attn):
    """The bf16 decoder end to end. At this size the loss is near
    ln(vocab) and the logits small, so rounding them to bf16 would hide
    in the network's own bf16 noise: ``test_bf16_vocab_head_keeps_fp32_logits``
    pins the fp32 logits where it would not."""
    kw = dict(FLASH_KW, dtype=torch.bfloat16) if attn == "flash" else dict(
        dtype=torch.bfloat16)
    jkw = dict(kw, dtype=jnp.bfloat16)
    seq = 256 if attn == "flash" else 64
    jc = jtf.tiny_config(attn_impl=attn, **jkw)
    tc = ttf.tiny_config(attn_impl=attn, **kw)
    params = _jax_params(jc)
    batch = next(jlm.synthetic_lm(jc.vocab_size, 2, seq, seed=1))
    (lj, _), gj = jax.value_and_grad(
        lambda p: jtf.next_token_loss(
            jc, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    lt, _ = ttf.next_token_loss(tc, tp, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=BF16_LOSS_RTOL)
    for n, g, w in zip(_names(params), gt,
                       convert.tree_leaves(jax.device_get(gj))):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert rel <= BF16_GRAD_REL_L2, (n, rel)


def test_bf16_vocab_head_keeps_fp32_logits():
    """The vocab projection on bf16 operands, logits up to ~100 (a
    trained model's range) and half the targets at the argmax (NLL near
    0), against the JAX package's ``preferred_element_type=float32`` dot.
    Both form fp32 logits from exact products, so the NLL agrees to fp32
    order (read 1.5e-5 at NLL 138, 3e-6 near 0); logits rounded to bf16
    first (a step of 0.5 at 64-128) move the NLL by up to 0.28, the
    near-zero ones by 0.06. The gradients differ by one bf16 rounding of
    the logit gradient (the port's, as a TPU's default-precision matmul
    rounds an fp32 operand) and of the outputs: relative L2 read 3e-3,
    with bf16 logits 2e-2."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 64, 64, 256
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 3.0).astype(np.float32)
    hj, wj = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    z = np.asarray(hj.astype(jnp.float32) @ wj.astype(jnp.float32))
    tgt = z.argmax(-1).astype(np.int32)
    tgt[:, ::2] = rng.integers(0, v, (b, s // 2))
    cot = rng.standard_normal((b, s)).astype(np.float32)
    jc = jtf.tiny_config(dtype=jnp.bfloat16)

    def jf(hh, ww):
        nll, am = jtf._chunked_nll_and_argmax(jc, hh, ww, jnp.asarray(tgt), s)
        return (nll * cot).sum(), (nll, am)

    (_, (nj, aj)), gj = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(hj, wj)
    ht = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    nt, at = ttf._chunked_nll_and_argmax(
        ttf.tiny_config(dtype=torch.bfloat16), ht, wt, torch.from_numpy(tgt), s)
    gt = torch.autograd.grad((nt * torch.from_numpy(cot)).sum(), (ht, wt))
    np.testing.assert_allclose(nt.detach().numpy(), np.asarray(nj),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for g, want in zip(gt, gj):
        want = np.asarray(want.astype(jnp.float32))
        rel = np.linalg.norm(g.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_remat_equals_no_remat(attn):
    """Checkpointed layers recompute the same forward: same loss and
    gradients as keeping every activation."""
    cfg = ttf.tiny_config(attn_impl=attn, **FLASH_KW)
    tokens = torch.from_numpy(next(tlm.synthetic_lm(cfg.vocab_size, 2, 256, seed=6))["tokens"])
    out = []
    for remat in (False, True):
        params = ttf.init_params(cfg, seed=1, device="cpu")
        leaves = [p.requires_grad_(True) for p in convert.tree_leaves(params)]
        loss, _ = ttf.next_token_loss(cfg.replace(remat=remat), params,
                                      {"tokens": tokens})
        out.append((loss, torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_count_params_and_flops_match_jax():
    # bench.py's flagship, as bench_flagship builds it.
    flagship = jtf.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=16, n_heads=8, n_kv_heads=8,
        d_ff=4096, max_seq=1024, attn_impl="flash", remat=True)
    for name in ("tiny", "llama3_8b", "flagship"):
        jc = flagship if name == "flagship" else jlm.CONFIGS[name]()
        tc = tlm.CONFIGS[name]()
        assert ttf.train_flops_per_token(tc, 2048) == jtf.train_flops_per_token(jc, 2048)
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq", "attn_impl", "remat"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
    jc = jtf.tiny_config()
    params = _jax_params(jc)
    assert ttf.count_params(convert.params_from_numpy(params, device="cpu")) \
        == jtf.count_params(params)


def test_params_to_numpy_round_trips():
    params = _jax_params(jtf.tiny_config())
    back = convert.params_to_numpy(convert.params_from_numpy(params, device="cpu"))
    assert _names(back) == _names(params)
    for a, b in zip(convert.tree_leaves(back), convert.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", ["remat_ffn", "ring", "pp", "quant_fp8"])
def test_model_refuses_what_is_not_ported(name):
    cfg = ttf.tiny_config()
    if name == "remat_ffn":
        cfg = cfg.replace(remat="ffn")
    elif name == "ring":
        cfg = cfg.replace(attn_impl="ring")
    elif name == "quant_fp8":
        cfg = cfg.replace(quant="fp8")
    params = ttf.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttf.next_token_loss(cfg, params, batch,
                            pp_microbatches=2 if name == "pp" else 0)


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("lr,total", [(3e-4, 100), (1e-2, 3), (5e-4, 4000)])
def test_schedule_matches_optax(lr, total):
    """optax evaluates the schedule in float32, the port in float64: near
    the end of the decay cos(pi * t / T) differs by float32's rounding of
    its argument, a few 1e-8 of the peak; atol is 1e-6 of the peak."""
    warm = min(200, total // 10 + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warm, total)
    got = optim.warmup_cosine_decay_schedule(0.0, lr, warm, total)
    for count in sorted({0, 1, warm - 1, warm, warm + 1, total // 2, total - 1,
                         total, total + 5}):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"count {count}")


def test_three_adamw_steps_match_optax():
    """Three full steps (loss -> grads -> AdamW under the LM entry point's
    schedule and weight decay) against ``jax.value_and_grad`` +
    ``lm._make_optimizer``'s optax chain, on the same params and batches.
    The first update has learning rate 0 (warmup reads the count before
    it increments). Adam's step lr * m_hat / (sqrt(v_hat) + eps) divides
    by the gradient's own size, so an element whose gradient is fp32
    noise around zero (a cancelling sum) can move by a sizeable share of
    lr = 1e-2 in either framework: parameters agree within lr / 1000
    (measured worst 5.1e-6, one element of 8192 in wo, and one each in
    w_down and w_gate past 1e-6; the rest within 1e-6)."""
    jc, tc = jtf.tiny_config(), ttf.tiny_config()
    lr, total = 1e-2, 3
    params = _jax_params(jc, seed=3)
    tx = jlm._make_optimizer(lr, total, False)
    opt_state = tx.init(params)
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    topt = optim.make_optimizer(lr, total)
    topt.init(tp)
    stream = jlm.synthetic_lm(jc.vocab_size, 2, 64, seed=7)
    for step in range(3):
        batch = next(stream)
        (lj, _), gj = jax.value_and_grad(
            lambda p: jtf.next_token_loss(jc, p, {"tokens": jnp.asarray(batch["tokens"])}),
            has_aux=True)(params)
        updates, opt_state = tx.update(gj, opt_state, params)
        params = optax.apply_updates(params, updates)
        lt, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(batch["tokens"])})
        grads = torch.autograd.grad(lt, leaves)
        used = topt.update(tp, convert.tree_unflatten(tp, grads))
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
        if step == 0:
            assert used == 0.0
    for n, a, b in zip(_names(tp), convert.tree_leaves(tp),
                       convert.tree_leaves(jax.device_get(params))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=lr / 1000, err_msg=n)


# -- train loop and entry point -------------------------------------------------

class _Recorder:
    """An optimizer that keeps the gradients it is handed."""

    def init(self, params):
        self.grads = None

    def update(self, params, grads):
        self.grads = grads


def test_grad_accum_matches_one_batch():
    """Two microbatches of 2 rows average to the gradient (and metrics)
    of the 4-row batch: the loss is a mean over equal-sized
    microbatches, and perplexity their geometric mean."""
    cfg = ttf.tiny_config()
    batch = {"tokens": torch.from_numpy(next(tlm.synthetic_lm(cfg.vocab_size, 4, 32, seed=8))["tokens"])}
    steps = {}
    for accum in (1, 2):
        rec = _Recorder()
        loop = ttrain.TrainLoop(
            init_fn=ttf.make_init_fn(cfg), loss_fn=ttf.make_loss_fn(cfg),
            optimizer=rec, device="cpu",
            config=ttrain.TrainLoopConfig(total_steps=1, grad_accum=accum))
        steps[accum] = (loop.step(batch), convert.tree_leaves(rec.grads))
    (m1, g1), (m2, g2) = steps[1], steps[2]
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m2["perplexity"], m1["perplexity"], rtol=1e-6, atol=0)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_grad_accum_refuses_indivisible_batch():
    cfg = ttf.tiny_config()
    loop = ttrain.TrainLoop(
        init_fn=ttf.make_init_fn(cfg), loss_fn=ttf.make_loss_fn(cfg),
        optimizer=optim.AdamW(1e-3), device="cpu",
        config=ttrain.TrainLoopConfig(total_steps=1, grad_accum=2))
    with pytest.raises(ValueError, match="not divisible by grad_accum=2"):
        loop.step({"tokens": torch.zeros((3, 9), dtype=torch.int32)})


@pytest.mark.parametrize("kw,ported", [
    (dict(model_dir="/nonexistent"), True), (dict(stateful=True), False),
    (dict(eval_fn=lambda p, b: {}), False),
    (dict(config=dict(steps_per_call=2)), False),
    (dict(config=dict(checkpoint_every=5)), True),
    (dict(config=dict(profile_dir="/tmp/x")), False),
    (dict(config=dict(async_checkpoint=True)), False),
], ids=["model_dir", "stateful", "eval_fn", "steps_per_call", "checkpoint_every",
        "profile_dir", "async_checkpoint"])
def test_train_loop_refuses_what_is_not_ported(kw, ported):
    """Options not ported yet raise "not yet ported" at construction;
    ``model_dir`` and ``checkpoint_every``, refused until checkpoints
    were ported, build a loop that keeps them (and touches no file before
    it runs: test_torch_checkpoint.py runs them)."""
    cfg = ttf.tiny_config()
    kw = dict(kw)
    conf = ttrain.TrainLoopConfig(**kw.pop("config", {}))

    def build():
        return ttrain.TrainLoop(
            init_fn=ttf.make_init_fn(cfg), loss_fn=ttf.make_loss_fn(cfg),
            optimizer=optim.AdamW(1e-3), config=conf, device="cpu", **kw)

    if not ported:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            build()
        return
    loop = build()
    assert loop.model_dir == kw.get("model_dir", "")
    assert loop.config.checkpoint_every == conf.checkpoint_every
    assert not os.path.exists("/nonexistent")


def test_train_loop_reports_loss_accuracy_perplexity_and_rate():
    cfg = ttf.tiny_config()
    loop = ttrain.TrainLoop(
        init_fn=ttf.make_init_fn(cfg), loss_fn=ttf.make_loss_fn(cfg),
        optimizer=optim.make_optimizer(1e-2, 6), device="cpu",
        config=ttrain.TrainLoopConfig(total_steps=6, log_every=2))
    batch = next(tlm.synthetic_lm(cfg.vocab_size, 4, 32, seed=9))
    seen = []
    state = loop.run(ttrain.device_prefetch(iter([batch] * 6), "cpu"),
                     on_metrics=seen.append)
    assert state.step == 6 and [m.step for m in seen] == [2, 4, 6]
    for m in seen:
        assert set(m.extras) == {"accuracy", "perplexity"}
        assert m.steps_per_sec > 0
        assert m.extras["perplexity"] == pytest.approx(float(np.exp(m.loss)), rel=1e-5)
    assert seen[-1].loss < seen[0].loss


def test_device_prefetch_yields_tensors_in_order_and_raises_producer_errors():
    batches = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = [b["tokens"] for b in ttrain.device_prefetch(iter(batches), "cpu")]
    assert [int(t[0, 0]) for t in got] == list(range(5))
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in got)

    def broken():
        yield batches[0]
        raise RuntimeError("corpus went away")

    it = ttrain.device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="corpus went away"):
        next(it)


@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
def test_lm_train_runs_on_cpu(pack, tmp_path):
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext

    ctx = ProcessContext(log_dir=str(tmp_path))
    out = tlm.train(ctx, config="tiny", total_steps=4, per_data_shard_batch=2,
                    seq_len=64, pack=pack, grad_accum=2, device="cpu")
    assert out["final_step"] == 4 and np.isfinite(out["loss"])
    assert {"accuracy", "perplexity", "tokens_per_sec"} <= set(out)
    with open(os.path.join(str(tmp_path), "metrics-p0.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4]


def test_lm_train_reads_a_corpus(tmp_path):
    path = _write_corpus(str(tmp_path), 5000, vocab=256, hi=256)
    out = tlm.train(config="tiny", total_steps=2, per_data_shard_batch=2,
                    seq_len=32, data_file=path, device="cpu")
    assert out["final_step"] == 2


_LM_KW = [dict(tp=2), dict(fsdp=2), dict(sp=2), dict(attn="ring"),
          dict(model_dir="/nonexistent"), dict(checkpoint_every=5),
          dict(config="tiny_moe"), dict(config="llama3_70b")]


@pytest.mark.parametrize(
    "kw", _LM_KW, ids=["-".join(f"{k}={v}" for k, v in kw.items())
                       for kw in _LM_KW])
def test_lm_train_refuses_what_is_not_ported(kw, tmp_path):
    """What the port does not train yet raises "not yet ported".
    ``model_dir`` and ``checkpoint_every`` (refused until checkpoints
    were ported) train: into a model dir (here under tmp_path, not the
    id's path), saving there every ``checkpoint_every`` steps and at the
    end."""
    base = dict(config="tiny", total_steps=2, per_data_shard_batch=1,
                seq_len=32, device="cpu")
    base.update(kw)
    if "model_dir" in kw or "checkpoint_every" in kw:
        if "model_dir" in kw:
            base["model_dir"] = str(tmp_path)
        out = tlm.train(**base)
        assert out["final_step"] == 2 and out["start_step"] == 0
        want = [2] if "model_dir" in kw else []
        assert ttrain.checkpoint_steps(str(tmp_path)) == want
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tlm.train(**base)


@pytest.mark.parametrize("env", [
    dict(model_dir="/nonexistent"), dict(num_processes=2, process_id=1),
], ids=["ctx_model_dir", "num_processes=2"])
def test_lm_train_refuses_the_job_env_it_cannot_honour(env, tmp_path):
    """A multi-process job (the reference syncs gradients across
    processes) is refused, never dropped without a word. A TPUJob's
    model dir (refused until checkpoints were ported; here under
    tmp_path, not the id's path) is honoured as the reference honours
    it: the job trains into it, saves at the end, and a rerun resumes
    there."""
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext

    kw = dict(config="tiny", per_data_shard_batch=1, seq_len=32, device="cpu")
    if "model_dir" not in env:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tlm.train(ProcessContext(**env), total_steps=2, **kw)
        return
    ctx = ProcessContext(model_dir=str(tmp_path))
    assert tlm.train(ctx, total_steps=2, **kw)["final_step"] == 2
    assert ttrain.checkpoint_steps(str(tmp_path)) == [2]
    out = tlm.train(ctx, total_steps=3, **kw)
    assert (out["start_step"], out["final_step"]) == (2, 3)
    assert ttrain.checkpoint_steps(str(tmp_path)) == [2, 3]
