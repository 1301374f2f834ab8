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

import itertools
import json
import os
import subprocess
import sys

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

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

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
    """What the model cannot run yet raises "not yet ported".
    ``remat="ffn"``, refused until the MoE slice ported it, trains: its
    loss and gradients are remat=False's bit for bit. ``attn_impl="ring"``
    and ``pp_microbatches``, refused until the sequence- and
    pipeline-parallel slice: without a mesh the ring is the dense
    forward (the JAX package's fallback), and the pipeline, which runs
    over a mesh's pp axis, raises the JAX call's ValueError (both run
    over a mesh in ``test_torch_parallel.py``)."""
    cfg = ttf.tiny_config()
    if name == "remat_ffn":
        cfg = cfg.replace(remat="ffn")
    elif name == "quant_fp8":
        cfg = cfg.replace(quant="fp8")
    params = ttf.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.int32)}
    if name == "ring":
        batch = {"tokens": torch.arange(18, dtype=torch.int32).reshape(2, 9) * 7 % 256}
        dense = ttf.forward_hidden(cfg, params, batch["tokens"])[0]
        ring = ttf.forward_hidden(cfg.replace(attn_impl="ring"), params, batch["tokens"])[0]
        torch.testing.assert_close(ring, dense, rtol=0, atol=2e-4)
        torch.testing.assert_close(
            ttf.next_token_loss(cfg.replace(attn_impl="ring"), params, batch)[0],
            ttf.next_token_loss(cfg, params, batch)[0], rtol=1e-5, atol=0)
        return
    if name == "pp":
        with pytest.raises(ValueError, match="mesh"):
            ttf.next_token_loss(cfg, params, batch, pp_microbatches=2)
        with pytest.raises(ValueError, match="mesh"):
            jtf.next_token_loss(jtf.tiny_config(), _jax_params(jtf.tiny_config()),
                                {"tokens": batch["tokens"].numpy()}, pp_microbatches=2)
        return
    if name == "remat_ffn":
        for p in convert.tree_leaves(params):
            p.requires_grad_(True)
        got = []
        for c in (cfg, cfg.replace(remat=False)):
            loss, _ = ttf.next_token_loss(c, params, batch)
            got.append((loss, torch.autograd.grad(loss, convert.tree_leaves(params))))
        assert torch.isfinite(got[0][0]) and torch.equal(got[0][0], got[1][0])
        assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttf.next_token_loss(cfg, params, batch)


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
    (dict(model_dir="/nonexistent"), True), (dict(stateful=True), True),
    (dict(eval_fn=lambda p, b: {}), True),
    (dict(config=dict(steps_per_call=2)), True),
    (dict(config=dict(checkpoint_every=5)), True),
    (dict(config=dict(profile_dir="/tmp/x")), True),
    (dict(config=dict(async_checkpoint=True)), True),
], ids=["model_dir", "stateful", "eval_fn", "steps_per_call", "checkpoint_every",
        "profile_dir", "async_checkpoint"])
def test_train_loop_refuses_what_is_not_ported(kw, ported):
    """Options not ported yet raise "not yet ported" at construction;
    ``model_dir`` and ``checkpoint_every``, refused until checkpoints
    were ported, build a loop that keeps them (and touches no file before
    it runs: test_torch_checkpoint.py runs them); ``stateful`` and
    ``eval_fn``, refused until the MNIST and ResNet slice, build one too
    (the tests below run them against the JAX loop); so do
    ``steps_per_call``, ``profile_dir`` and ``async_checkpoint``, refused
    until the MoE slice (the tests below run them)."""
    cfg = ttf.tiny_config()
    kw = dict(kw)
    conf = ttrain.TrainLoopConfig(**kw.pop("config", {}))
    init_fn = ttf.make_init_fn(cfg)
    if kw.get("stateful"):
        init_fn = lambda seed, dev: (ttf.make_init_fn(cfg)(seed, dev), {})  # noqa: E731

    def build():
        return ttrain.TrainLoop(
            init_fn=init_fn, loss_fn=ttf.make_loss_fn(cfg),
            optimizer=optim.AdamW(1e-3), config=conf, device="cpu", **kw)

    if not ported:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            build()
        return
    loop = build()
    assert loop.model_dir == kw.get("model_dir", "")
    assert loop.config == conf
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


_EXIT_EARLY = """
import sys
import torch
from kubeflow_controller_tpu_torch.dataplane.train import device_prefetch

def stream():
    while True:
        a = torch.randn(256, 256)
        for _ in range(100):           # the next batch takes a while, in torch
            a = torch.tanh(a @ a)
        yield {"x": a.numpy()}

it = device_prefetch(stream(), "cpu")
next(it)
del it
sys.exit(0)
"""


def test_a_stream_left_early_lets_the_process_exit_cleanly():
    """A consumer that stops early waits for the producer thread to end:
    a producer left making the next batch inside torch while the
    interpreter shuts down aborts the process ("terminate called
    without an active exception", rc -6), as a two-process gang's rank
    did after training."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _EXIT_EARLY], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, (p.returncode, p.stderr[-2000:])


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
    end. ``config="tiny_moe"`` (refused until the MoE slice) trains and
    reports the MoE metrics. ``llama3_70b`` (refused until its own slice,
    though tensor parallelism came first) is a training config now, and
    ``serve`` takes it over tensor parallelism: its heads split at tp=2,
    which one process, a world of one rank, cannot fill (the serving
    mesh's ``ValueError``, before any weight loads), and tp=3 is refused
    by the head check. ``tp`` and ``fsdp`` (refused until multi-process training
    was ported) are a ``mesh_config`` now: one process is a world of one
    rank, which a tp=2 or fsdp=2 mesh cannot fill, and
    ``MeshConfig.resolve`` raises the reference's ``ValueError``; so does
    ``sp`` (refused until the sequence-parallel slice), and ``attn="ring"``
    trains, on one process the dense attention (``sp=2`` with the ring
    trains over a gang in ``test_torch_parallel.py``)."""
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig

    base = dict(config="tiny", total_steps=2, per_data_shard_batch=1,
                seq_len=32, device="cpu")
    kw = dict(kw)
    if {"tp", "fsdp", "sp"} & set(kw):
        base["mesh_config"] = MeshConfig(**kw)
        with pytest.raises(ValueError, match="not divisible"):
            tlm.train(**base)
        return
    base.update(kw)
    if kw.get("config") == "llama3_70b":
        from kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm import serve

        cfg = tlm.model_config("llama3_70b")
        assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads) == (8192, 80, 64, 8)
        with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
            serve(config="llama3_70b", tp=2, device="cpu")
        with pytest.raises(ValueError, match="n_kv_heads must be divisible by tp"):
            serve(config="llama3_70b", tp=3, device="cpu")
        return
    if kw.get("config") == "tiny_moe" or kw.get("attn") == "ring":
        out = tlm.train(**base)
        assert out["final_step"] == 2 and np.isfinite(out["loss"])
        if "attn" not in kw:
            assert np.isfinite(out["moe_aux"]) and 0 <= out["moe_drop_rate"] <= 1
        return
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
    """A multi-process job whose process group is not up (the reference
    syncs gradients across processes; refused with "not yet ported"
    until multi-process training was ported) is refused with an error
    that names ``initialize_from_env``, never trained as a private
    replica. A TPUJob's model dir (refused until checkpoints were
    ported; here under tmp_path, not the id's path) is honoured as the
    reference honours it: the job trains into it, saves at the end, and
    a rerun resumes there."""
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext

    kw = dict(config="tiny", per_data_shard_batch=1, seq_len=32, device="cpu")
    if "model_dir" not in env:
        with pytest.raises(RuntimeError, match="initialize_from_env"):
            tlm.train(ProcessContext(**env), total_steps=2, **kw)
        return
    ctx = ProcessContext(model_dir=str(tmp_path))
    assert tlm.train(ctx, total_steps=2, **kw)["final_step"] == 2
    assert ttrain.checkpoint_steps(str(tmp_path)) == [2]
    out = tlm.train(ctx, total_steps=3, **kw)
    assert (out["start_step"], out["final_step"]) == (2, 3)
    assert ttrain.checkpoint_steps(str(tmp_path)) == [2, 3]


# -- evaluation, stateful models and the other optimizers -------------------------

def _jax_loop(**kw):
    """The JAX package's TrainLoop on one CPU device."""
    from kubeflow_controller_tpu.dataplane import train as jtrain
    from kubeflow_controller_tpu.parallel.mesh import MeshConfig, make_mesh

    return jtrain.TrainLoop(mesh=make_mesh(MeshConfig(), jax.devices()[:1]), **kw)


def _records(loop_run):
    seen = []
    loop_run(lambda m: seen.append((m.step, m.loss, dict(m.extras))))
    return seen


def test_eval_every_matches_jax_loop():
    """``eval_fn``/``eval_every``/``eval_batches``: the MNIST MLP trained 6
    steps by Adam, evaluated every 2 steps over 2 held-out batches; each
    report's loss, accuracy and ``val_*`` metrics equal the JAX loop's
    (fp32; Adam moves an element by up to lr wherever its gradient is
    noise, so the metrics agree within 1e-4 relative)."""
    from kubeflow_controller_tpu.dataplane import train as jtrain
    from kubeflow_controller_tpu.models import mnist as jmnist
    from kubeflow_controller_tpu_torch.models import mnist as tmnist

    jm, tm = jmnist.MnistMLP(hidden=32), tmnist.MnistMLP(hidden=32)
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((2, 784))))
    conf = dict(total_steps=6, log_every=2, eval_every=2, eval_batches=2)
    train = list(itertools.islice(jmnist.synthetic_mnist(16, uint8=True), 6))
    jloop = _jax_loop(init_fn=lambda rng: variables, loss_fn=jmnist.make_loss_fn(jm),
                      optimizer=optax.adam(1e-3), eval_fn=jmnist.make_eval_fn(jm),
                      config=jtrain.TrainLoopConfig(**conf))
    want = _records(lambda cb: jloop.run(
        iter(train), on_metrics=cb,
        eval_iter=jmnist.synthetic_mnist(16, seed=1, uint8=True)))
    tloop = ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.mnist_params_from_flax(variables, dev),
        loss_fn=tmnist.make_loss_fn(tm), optimizer=optim.adam(1e-3),
        eval_fn=tmnist.make_eval_fn(tm), config=ttrain.TrainLoopConfig(**conf),
        device="cpu")
    got = _records(lambda cb: tloop.run(
        ttrain.device_prefetch(iter(train), "cpu"), on_metrics=cb,
        eval_iter=tmnist.synthetic_mnist(16, seed=1, uint8=True)))
    assert [g[0] for g in got] == [w[0] for w in want] == [2, 4, 6]
    for (_, gl, ge), (_, wl, we) in zip(got, want):
        assert set(ge) == set(we) == {"accuracy", "val_cross_entropy", "val_accuracy"}
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        for k in we:
            np.testing.assert_allclose(ge[k], we[k], rtol=1e-4, err_msg=k)
    assert tloop.evaluate(tmnist.synthetic_mnist(16, seed=5, uint8=True), 3).keys() == {
        "cross_entropy", "accuracy"}


def _resnet_setup():
    from kubeflow_controller_tpu.models import resnet as jresnet
    from kubeflow_controller_tpu_torch.models import resnet as tresnet

    jm, tm = jresnet.resnet_tiny(), tresnet.resnet_tiny()
    params, stats = jax.device_get(
        jax.jit(jresnet.make_init_fn(jm, 16))(jax.random.key(2)))
    batches = list(itertools.islice(
        jresnet.synthetic_imagenet(8, 16, 10, seed=3, uint8=True), 3))
    return jresnet, tresnet, jm, tm, params, stats, batches


def test_stateful_loop_with_grad_accum_matches_jax_loop():
    """``stateful=True`` with ``grad_accum=2``: resnet_tiny's BatchNorm
    statistics thread through both microbatches of each step in order;
    3 steps of SGD with Nesterov momentum (lr 0.05) from the same
    weights. Each step's loss within 1e-4 relative, and the statistics
    and parameters after, within 1e-4 of each leaf's largest element,
    of the JAX loop's."""
    from kubeflow_controller_tpu.dataplane import train as jtrain

    jresnet, tresnet, jm, tm, params, stats, batches = _resnet_setup()
    conf = dict(total_steps=3, log_every=1, grad_accum=2)
    jloop = _jax_loop(init_fn=lambda rng: (params, stats),
                      loss_fn=jresnet.make_loss_fn(jm),
                      optimizer=optax.sgd(0.05, momentum=0.9, nesterov=True),
                      config=jtrain.TrainLoopConfig(**conf), stateful=True)
    want = _records(lambda cb: jloop.run(iter(batches), on_metrics=cb))
    tloop = ttrain.TrainLoop(
        init_fn=lambda seed, dev: convert.resnet_params_from_flax(params, stats, dev),
        loss_fn=tresnet.make_loss_fn(tm),
        optimizer=optim.SGD(0.05, momentum=0.9, nesterov=True),
        config=ttrain.TrainLoopConfig(**conf), stateful=True, device="cpu")
    got = _records(lambda cb: tloop.run(ttrain.device_prefetch(iter(batches), "cpu"),
                                        on_metrics=cb))
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 2, 3]
    for (_, gl, _), (_, wl, _) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
    jp, js = convert.resnet_params_to_flax(tloop.state.params, tloop.state.model_state)
    for got_tree, want_tree in ((js, jloop.state.model_state), (jp, jloop.state.params)):
        for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(jax.device_get(want_tree))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))
    # The statistics moved from their init (mean 0, var 1).
    assert float(np.abs(js["stem_norm"]["mean"]).max()) > 1e-3


def test_checkpoint_round_trip_keeps_model_state(tmp_path):
    """A stateful loop saves its model state with its parameters; a new
    loop resumed from the checkpoint at step 2 and run to 3 ends where an
    uninterrupted run to 3 ends, statistics included."""
    _, tresnet, _, tm, params, stats, batches = _resnet_setup()

    def loop(total, model_dir=""):
        return ttrain.TrainLoop(
            init_fn=lambda seed, dev: convert.resnet_params_from_flax(params, stats, dev),
            loss_fn=tresnet.make_loss_fn(tm),
            optimizer=optim.SGD(0.05, momentum=0.9, nesterov=True),
            config=ttrain.TrainLoopConfig(total_steps=total), stateful=True,
            model_dir=model_dir, device="cpu")

    def feed(bs):
        return ttrain.device_prefetch(iter(bs), "cpu")

    first = loop(2, str(tmp_path))
    first.run(feed(batches[:2]))
    assert ttrain.checkpoint_steps(str(tmp_path)) == [2]
    resumed = loop(3, str(tmp_path))
    assert resumed.restore() and resumed.state.step == 2
    for a, b in zip(convert.tree_leaves(resumed.state.model_state),
                    convert.tree_leaves(first.state.model_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    resumed.run(feed(batches[2:]))
    whole = loop(3)
    whole.run(feed(batches))
    for a, b in zip(convert.tree_leaves(resumed.state.model_state),
                    convert.tree_leaves(whole.state.model_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(convert.tree_leaves(resumed.state.params),
                    convert.tree_leaves(whole.state.params)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["sgd_nesterov", "adam"])
def test_optimizer_matches_optax_over_five_steps(name):
    """``optim.SGD(momentum=0.9, nesterov=True)`` under the ResNet entry
    point's warmup-cosine schedule, and ``optim.adam``, against optax on
    the same parameters and the same five gradients (numpy draws):
    within 1e-6 of each leaf's largest element (fp32 rounding of the same
    updates; Adam's division by its own small gradients stays inside
    this at these draws)."""
    rng = np.random.default_rng(11)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 2)}}
    draw = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    params = draw()
    grads = [draw() for _ in range(5)]
    if name == "adam":
        tx, topt = optax.adam(3e-2), optim.adam(3e-2)
    else:
        sched = optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 5)
        tx = optax.sgd(sched, momentum=0.9, nesterov=True)
        topt = optim.SGD(optim.warmup_cosine_decay_schedule(0.0, 0.1, 2, 5),
                         momentum=0.9, nesterov=True)
    state = tx.init(params)
    tp = convert.params_from_numpy(params, device="cpu")
    topt.init(tp)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        topt.update(tp, convert.params_from_numpy(g, device="cpu"))
        for a, b in zip(convert.tree_leaves(tp), jax.tree.leaves(params)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * float(np.abs(b).max()))


# -- remat="ffn" and the last TrainLoop options -----------------------------------

@pytest.mark.parametrize("quant", ["", "int8"], ids=["fp32", "int8"])
def test_remat_ffn_matches_jax_and_drops_the_ffn_intermediates(quant):
    """``remat="ffn"`` (as ``tests/test_transformer.py``'s remat test):
    the loss and every gradient equal the JAX package's ``remat="ffn"``
    within the fp32 tolerances (int8: its composed path, as
    test_torch_quant.py holds it), and the port's ``remat=False`` bit for
    bit; of the activations autograd keeps, none is d_ff wide (the four
    intermediates and, under int8, their quantized copies are recomputed
    in the backward), where ``remat=False`` keeps several."""
    jc = jtf.tiny_config(remat="ffn", quant=quant)
    tc = ttf.tiny_config(remat="ffn", quant=quant)
    params = _jax_params(jc)
    batch = next(jlm.synthetic_lm(jc.vocab_size, 2, 64, seed=1))
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jtf.next_token_loss(
        jc, p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rows = 2 * 64
    got = {}
    for remat in ("ffn", False):
        tp = convert.params_from_numpy(params, device="cpu")
        leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
        wide = []

        def pack(t):
            if t.numel() == rows * tc.d_ff and tc.d_ff in t.shape:
                wide.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lt, _ = ttf.next_token_loss(tc.replace(remat=remat), tp, tb)
        got[remat] = (lt, torch.autograd.grad(lt, leaves), wide)
    lt, gt, wide = got["ffn"]
    assert wide == [] and len(got[False][2]) >= 4 * tc.n_layers
    assert torch.equal(lt, got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(gt, got[False][1]))
    gj = convert.tree_leaves(jax.device_get(gj))
    if not quant:
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
        _assert_grads_close(gt, gj, _names(params))
        return
    # int8: test_torch_quant.py's limits for the fp32 decoder (a code may
    # flip at a rounding tie that the two frameworks' upstream sums place
    # differently): loss within 3e-4 relative, each leaf within 5e-2
    # relative L2.
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=3e-4)
    for n, g, w in zip(_names(params), gt, gj):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= 5e-2, n


def _toy_loop(total, **conf):
    """The JAX package's TestMultiStepDispatch model: ``w [8]`` pulled
    towards each batch's first row by SGD at 0.05."""
    def init_fn(seed, dev):
        return {"w": torch.zeros(8, device=dev)}

    def loss_fn(params, batch):
        err = ((params["w"] - batch["x"][0]) ** 2).sum()
        return err, {"werr": err}

    return ttrain.TrainLoop(
        init_fn=init_fn, loss_fn=loss_fn, optimizer=optim.SGD(0.05),
        config=ttrain.TrainLoopConfig(total_steps=total, **conf), device="cpu")


def _toy_data():
    i = 0
    while True:
        yield {"x": np.full((8, 8), i % 5, np.float32)}
        i += 1


@pytest.mark.parametrize("k", [4, 5], ids=["K4", "K5_trimmed"])
def test_steps_per_call_matches_single_steps(k, tmp_path):
    """``steps_per_call = K`` over ``device_prefetch(chunk=K,
    yield_chunks=True)``: the final parameters equal K=1's bit for bit;
    the log, checkpoint and eval cadences land on K-step boundaries,
    each report the mean of its call's stacked metrics (the JAX
    package's TestMultiStepDispatch); a last chunk past ``total_steps``
    is trimmed, so the run ends exactly there (24 = 4·5 + 4 at K=5)."""
    evals = []
    runs = {}
    for spc in (1, k):
        mdir = str(tmp_path / f"k{spc}")
        loop = _toy_loop(24, log_every=8, checkpoint_every=8, eval_every=8,
                         steps_per_call=spc)
        loop.model_dir = mdir
        loop.eval_fn = lambda p, b: (evals.append(spc), {"w0": p["w"][0]})[1]
        it = (ttrain.device_prefetch(_toy_data(), "cpu", chunk=spc,
                                     yield_chunks=True)
              if spc > 1 else ttrain.device_prefetch(_toy_data(), "cpu"))
        seen = []
        state = loop.run(it, on_metrics=seen.append, eval_iter=_toy_data())
        runs[spc] = (state, seen, ttrain.checkpoint_steps(mdir))
    (s1, log1, ck1), (sk, logk, ckk) = runs[1], runs[k]
    assert s1.step == sk.step == 24
    assert torch.equal(s1.params["w"], sk.params["w"])
    want = sorted({min(24, -(-m // k) * k) for m in (8, 16, 24)})
    assert [m.step for m in log1] == [8, 16, 24] and ck1 == [8, 16, 24]
    assert [m.step for m in logk] == want and ckk == want
    assert evals.count(1) == 3 and evals.count(k) == len(want)
    # Each K-step report is the mean of the losses of its call's steps.
    losses = []
    _toy_loop(24, log_every=1).run(ttrain.device_prefetch(_toy_data(), "cpu"),
                                   on_metrics=lambda m: losses.append(m.loss))
    for m in logk:
        first = (m.step - 1) // k * k
        assert m.loss == pytest.approx(float(np.mean(losses[first:m.step])),
                                       rel=1e-6)


def test_device_prefetch_chunks():
    """``chunk=K``: one stacked ``[K, ...]`` transfer a chunk, yielded
    whole with ``yield_chunks`` (a finite stream's last chunk partial),
    else batch by batch in order."""
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(7)]
    chunks = list(ttrain.device_prefetch(iter(batches), "cpu", chunk=3,
                                         yield_chunks=True))
    assert [tuple(c["x"].shape) for c in chunks] == [(3, 2, 3), (3, 2, 3), (1, 2, 3)]
    flat = list(ttrain.device_prefetch(iter(batches), "cpu", chunk=3))
    assert [int(b["x"][0, 0]) for b in flat] == list(range(7))


def test_async_checkpoint_resumes(tmp_path):
    """``async_checkpoint``: periodic saves are written in the background,
    the final save waits, and a fresh loop resumes from it and ends
    where an uninterrupted run ends (the JAX package's
    TestAsyncCheckpoint, and the host copy holds the state of its step,
    not a later one)."""
    mdir = str(tmp_path / "ckpt")

    def make(total):
        loop = _toy_loop(total, log_every=100, checkpoint_every=5,
                         async_checkpoint=True)
        loop.model_dir = mdir
        return loop

    state = make(20).run(ttrain.device_prefetch(_toy_data(), "cpu"))
    assert state.step == 20 and ttrain.checkpoint_steps(mdir) == [10, 15, 20]
    saved5 = ttrain.load_params(mdir, 15, "cpu")["w"]
    loop2 = make(40)
    state = loop2.run(ttrain.device_prefetch(_toy_data(), "cpu"))
    assert loop2.start_step == 20 and state.step == 40
    assert ttrain.checkpoint_steps(mdir) == [30, 35, 40]
    ref = _toy_loop(15)
    ref.run(ttrain.device_prefetch(_toy_data(), "cpu"))
    assert torch.equal(saved5, ref.state.params["w"])


def test_async_checkpoint_is_restorable_before_the_next_save(tmp_path):
    """``async_checkpoint`` commits in its background thread, as orbax
    finalizes: a loop stopped (preempted) after one periodic save, with
    no later save and no ``wait_for_save``, leaves that step restorable
    once the thread ends, and a fresh loop resumes from it."""
    mdir = str(tmp_path / "ckpt")

    class Preempted(Exception):
        pass

    def preempted_after(n):
        for i, batch in enumerate(_toy_data()):
            if i == n:
                raise Preempted
            yield batch

    loop = _toy_loop(20, log_every=100, checkpoint_every=5, async_checkpoint=True)
    loop.model_dir = mdir
    with pytest.raises(Preempted):
        loop.run(ttrain.device_prefetch(preempted_after(7), "cpu"))
    assert loop.state.step == 7
    loop._saver.join()
    assert ttrain.checkpoint_steps(mdir) == [5]
    resumed = _toy_loop(20, log_every=100, checkpoint_every=5)
    resumed.model_dir = mdir
    assert resumed.restore() and resumed.state.step == 5


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir``: a ``torch.profiler`` trace of steps
    ``[profile_start, profile_start + profile_steps)`` lands there, once,
    and training goes on to the end; a window the run does not reach
    writes nothing."""
    prof = tmp_path / "prof"
    loop = _toy_loop(8, profile_dir=str(prof), profile_start=2, profile_steps=3)
    assert loop.run(ttrain.device_prefetch(_toy_data(), "cpu")).step == 8
    traces = sorted(p.name for p in prof.glob("*.pt.trace.json"))
    assert traces == ["steps_2_5.pt.trace.json"]
    assert json.loads((prof / traces[0]).read_text())["traceEvents"]
    loop = _toy_loop(4, profile_dir=str(tmp_path / "none"), profile_start=10)
    loop.run(ttrain.device_prefetch(_toy_data(), "cpu"))
    assert not (tmp_path / "none").exists()


# -- mesh options the port does not train yet --------------------------------------

def _fake_mesh(size, **kw):
    """A ``size``-rank mesh seen from rank 0 under torch's fake process
    group (no collective runs); the caller destroys the group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    return make_mesh(MeshConfig(**kw))


#: The mesh options refused with "not yet ported" until the slice that
#: trains them (MoE over tp, ep and sp; int8 projections over tp; 8-bit
#: AdamW on sharded leaves; BERT over tp): mesh, model options.
_MESH_REFUSALS = {
    "moe_tp2": (dict(dp=1, tp=2), dict(config="tiny_moe")),
    "moe_ep2": (dict(dp=1, ep=2), dict(config="tiny_moe")),
    "int8_tp2": (dict(dp=1, tp=2), dict(quant="int8")),
    "int8_fused_tp2": (dict(dp=1, tp=2), dict(quant="int8_fused")),
    "sp2": (dict(dp=1, sp=2), dict(config="tiny_moe")),
    "opt8bit_fsdp2": (dict(dp=1, fsdp=2), dict(opt8bit=True)),
    "bert_tp2": (dict(dp=1, tp=2), dict(model="bert")),
}


def _chunk_shape(shape, spec, sizes):
    """The shape of one rank's chunk of a ``shape`` leaf placed by the
    JAX ``PartitionSpec`` ``spec`` over a mesh of axis ``sizes``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n = int(np.prod([sizes[a] for a in axes]))
        assert dim % n == 0, (shape, spec)
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("case", list(_MESH_REFUSALS))
def test_mesh_options_not_yet_ported_are_refused(case):
    """The mesh options once refused with "not yet ported" (each case's
    id) now build: on a two-rank mesh under the fake process group
    (where no collective runs) the model's mesh check passes, and
    ``TrainLoop`` places every leaf so that this rank's chunk has the
    shape the JAX package's ``param_specs`` give it on that mesh, and so
    do its optimizer moments: AdamW's after one update (of zeros, no
    collective), 8-bit AdamW's codes (the chunk's shape) and per-row
    statistics (its rows, one column: the whole leaf's) at init."""
    import torch.distributed as dist

    from kubeflow_controller_tpu.models import bert as jbert
    from kubeflow_controller_tpu_torch.models import bert as tbert
    from kubeflow_controller_tpu_torch.ops.optim8 import QLeafM, QLeafV
    from kubeflow_controller_tpu_torch.parallel.mesh import use_mesh

    mesh_kw, opt = _MESH_REFUSALS[case]
    mesh = _fake_mesh(2, **mesh_kw)
    try:
        if opt.get("model") == "bert":
            cfg = tbert.bert_tiny_config()
            init, loss_fn, specs = tbert.make_init_fn(cfg), tbert.make_loss_fn(cfg), tbert.param_specs(cfg)
            jspecs = jbert.param_specs(jbert.bert_tiny_config())
            tx = optim.AdamW(1e-3, weight_decay=0.01)
        else:
            config, quant = opt.get("config", "tiny"), opt.get("quant", "")
            cfg = tlm.model_config(config, quant=quant)
            with use_mesh(mesh):
                ttf.check_mesh(cfg)
            init, loss_fn, specs = ttf.make_init_fn(cfg), ttf.make_loss_fn(cfg), ttf.param_specs(cfg)
            jspecs = jtf.param_specs(getattr(jtf, f"{config}_config")(quant=quant))
            tx = optim.make_optimizer(1e-3, 2, opt8bit=opt.get("opt8bit", False))
        loop = ttrain.TrainLoop(init_fn=init, loss_fn=loss_fn, optimizer=tx, device="cpu",
                                mesh=mesh, param_shardings=specs)
        want = [_chunk_shape(shape, spec, mesh.shape)
                for shape, spec in zip(loop._full_shapes, jax.tree.leaves(jspecs))]
        leaves = convert.tree_leaves(loop.state.params)
        assert [tuple(p.shape) for p in leaves] == want
        # sp shards no parameter; every other layout here shards some.
        assert any(tuple(p.shape) != full for p, full in
                   zip(leaves, loop._full_shapes)) == ("sp" not in mesh_kw)
        if opt.get("opt8bit"):
            quantized = 0
            for m, v, shape in zip(tx.m, tx.v, want):
                if isinstance(m, QLeafM):
                    quantized += 1
                    rows = shape[:-1] + (1,)
                    assert isinstance(v, QLeafV) and m.q.shape == v.q.shape == shape
                    assert m.scale.shape == v.lo.shape == v.rng.shape == rows
                else:
                    assert m.shape == v.shape == shape
            assert quantized > 0
        else:
            tx.update(loop.state.params, convert.tree_unflatten(
                loop.state.params, [torch.zeros_like(p) for p in leaves]))
            state = tx.state_dict()["opt"]["state"]
            assert [tuple(state[i]["exp_avg"].shape) for i in range(len(want))] == want
            assert [tuple(state[i]["exp_avg_sq"].shape) for i in range(len(want))] == want
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entry", ["mnist", "resnet", "bert"])
def test_entry_points_refuse_a_job_without_its_process_group(entry):
    """MNIST, ResNet and BERT in a multi-process job whose process group
    is not up (refused with "not yet ported" until multi-process
    training was ported) raise the error naming ``initialize_from_env``."""
    import importlib

    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext

    mod = importlib.import_module(
        f"kubeflow_controller_tpu_torch.dataplane.entrypoints.{entry}")
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        mod.train(ProcessContext(num_processes=2, process_id=1), total_steps=1,
                  device="cpu")
