"""The port's 8-bit AdamW (``ops/optim8.py``) held against the JAX
package's ``adamw8bit`` on the CPU, and ``lm.train`` with int8
projections and 8-bit moments.

Both optimizers get the same gradients (numpy draws) for three steps
under the LM entry point's schedule; the JAX update runs under
``jax.jit``, as the JAX package trains. The port computes what the
jitted step computes (reciprocal constants, fused multiply-adds), so
the int8 m codes and their scales agree bit for bit. The v codes pass
through ``log`` and ``exp``, which round differently in XLA and PyTorch
(one fp32 ulp apart for about one value in ten), so a v code may land
one step apart; they are held within one.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
from kubeflow_controller_tpu.ops import optim8 as jo8
from kubeflow_controller_tpu_torch import convert, optim
from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm as tlm
from kubeflow_controller_tpu_torch.ops import optim8 as to8

LR, TOTAL = 1e-2, 3

# v codes one step apart, of the 25,600 quantized v codes: read 0 in
# every step (three seeds of params and gradients); a log or exp one
# ulp apart could move one across a rounding tie. Limit 0.1 %, and none
# two steps apart.
V_CODE_MISMATCH_SHARE = 1e-3
# Parameters after three steps, in units of the peak lr: read 2.4e-5 of
# lr at the worst element (one fp32 ulp of a parameter near 2; the bias
# corrections and the schedule round differently). A v code one step
# apart would move sqrt(v) by rng / 510 (~3 % at this data's log-ranges)
# and that element's update by as much; none did. Limit 1e-4 of lr.
PARAM_ATOL_OF_LR = 1e-4
# fp32 moments of the small leaves: XLA fuses their update with another
# operand order than the quantized leaves' (one fp32 rounding apart), so
# an element that nearly cancels reads up to 1.3e-5 relative; against the
# leaf's largest element every one is within 1.2e-7. Limits 1e-6 of each.
FP32_MOMENT_RTOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "big": rng.standard_normal((64, 256)).astype(np.float32),      # 16384: 8-bit
        "layers": {"w": rng.standard_normal((3, 8, 384)).astype(np.float32)},  # 9216: 8-bit
        "norm": np.ones((4, 1000), np.float32),                         # 4000: fp32
        "bias": rng.standard_normal((100,)).astype(np.float32),         # fp32
    }


def _grads(tree, rng, first=False):
    """Gradients over many orders of magnitude per row (v spans a wide
    log range), with exact zeros: scattered zeros, and on the first step
    a zero row."""
    if isinstance(tree, dict):
        return {k: _grads(tree[k], rng, first) for k in sorted(tree)}
    g = rng.standard_normal(tree.shape).astype(np.float32)
    g *= (10.0 ** rng.uniform(-6, 0, tree.shape[:-1] + (1,))).astype(np.float32)
    g[rng.random(tree.shape) < 0.05] = 0.0
    if tree.ndim == 2 and first:
        g[1] = 0.0
    return g


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def test_three_8bit_adamw_steps_match_jitted_jax():
    params = _params()
    tx = jlm._make_optimizer(LR, TOTAL, True)
    state = tx.init(params)
    update = jax.jit(tx.update)
    apply = jax.jit(optax.apply_updates)
    tp = convert.params_from_numpy(params, device="cpu")
    topt = optim.make_optimizer(LR, TOTAL, opt8bit=True)
    assert isinstance(topt, to8.AdamW8bit)
    topt.init(tp)
    names = _names(params)
    n_v = sum(p.size for p in convert.tree_leaves(params) if p.size >= 4096)
    for step in range(3):
        grads = _grads(params, np.random.default_rng(100 + step), step == 0)
        updates, state = update(grads, state, params)
        params = jax.device_get(apply(params, updates))
        used = topt.update(tp, convert.params_from_numpy(grads, device="cpu"))
        if step == 0:
            # The schedule is read before the count increments: warmup's 0.
            assert used == 0.0
            for a, b in zip(convert.tree_leaves(tp), convert.tree_leaves(_params())):
                np.testing.assert_array_equal(a.numpy(), b)
        jm = convert.tree_leaves(jax.device_get(state.m))
        jv = convert.tree_leaves(jax.device_get(state.v))
        mismatched = 0
        for n, tm, tv, wm, wv in zip(names, topt.m, topt.v, jm, jv):
            if isinstance(wm, jo8.QLeafM):
                np.testing.assert_array_equal(tm.q.numpy(), np.asarray(wm.q), err_msg=n)
                np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(wm.scale),
                                              err_msg=n)
                diff = np.abs(tv.q.numpy().astype(int) - np.asarray(wv.q).astype(int))
                assert diff.max() <= 1, (n, step)
                mismatched += int((diff > 0).sum())
                np.testing.assert_allclose(tv.lo.numpy(), np.asarray(wv.lo), rtol=1e-6)
                np.testing.assert_allclose(tv.rng.numpy(), np.asarray(wv.rng), rtol=1e-5)
            else:
                # The carve-out: small leaves keep fp32 moments in both.
                assert isinstance(tm, torch.Tensor) and tm.dtype == torch.float32
                for got, want in ((tm, wm), (tv, wv)):
                    want = np.asarray(want)
                    np.testing.assert_allclose(
                        got.numpy(), want, rtol=FP32_MOMENT_RTOL,
                        atol=FP32_MOMENT_RTOL * np.abs(want).max(), err_msg=n)
        assert mismatched <= V_CODE_MISMATCH_SHARE * n_v, (step, mismatched)
    for n, a, b in zip(names, convert.tree_leaves(tp), convert.tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL_OF_LR * LR, err_msg=n)


def test_min_quantized_size_carve_out():
    """Leaves below ``min_quantized_size`` elements keep fp32 moments;
    at or above it, int8 m and uint8 v with per-row (last-axis) scales."""
    tp = convert.params_from_numpy(_params(), device="cpu")
    opt = to8.AdamW8bit(1e-3)
    opt.init(tp)
    kinds = {n: (type(m).__name__, type(v).__name__)
             for n, m, v in zip(_names(_params()), opt.m, opt.v)}
    assert kinds == {"big": ("QLeafM", "QLeafV"), "layers/w": ("QLeafM", "QLeafV"),
                     "norm": ("Tensor", "Tensor"), "bias": ("Tensor", "Tensor")}
    big_m, big_v = opt.m[1], opt.v[1]                  # sorted: bias, big, ...
    assert big_m.q.dtype == torch.int8 and big_m.scale.shape == (64, 1)
    assert big_v.q.dtype == torch.uint8 and big_v.lo.shape == (64, 1)
    assert opt.m[2].scale.shape == (3, 8, 1)
    everything = to8.AdamW8bit(1e-3, min_quantized_size=100)
    everything.init(tp)
    assert all(isinstance(m, to8.QLeafM) for m in everything.m)


def test_8bit_moments_read_zero_at_the_floor():
    """A zero second moment survives quantization as exactly 0, and an
    outlier row does not touch the others' codes."""
    v = torch.zeros((4, 512))
    v[1] = torch.rand(512) * 1e-6
    v[2] = 1e3
    q, lo, rng = to8._quantize_v(v)
    back = to8._dequantize_v(q, lo, rng)
    assert not back[0].any() and not back[3].any()
    np.testing.assert_allclose(back[1].numpy(), v[1].numpy(), rtol=0.06)
    np.testing.assert_allclose(back[2].numpy(), v[2].numpy(), rtol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "int8_fused"])
def test_lm_train_int8_with_8bit_adam_on_cpu(quant, tmp_path):
    """The entry point a TPUJob runs, with bench.py's int8 + 8-bit Adam
    variant: every step's metrics written, the loss finite and falling.
    At tiny widths ``fusable`` sends every projection to the composed
    path, as in the JAX package."""
    ctx = ProcessContext(log_dir=str(tmp_path))
    out = tlm.train(ctx, config="tiny", total_steps=12, per_data_shard_batch=4,
                    seq_len=64, learning_rate=1e-2, quant=quant, opt8bit=True,
                    device="cpu")
    assert out["final_step"] == 12
    with open(os.path.join(str(tmp_path), "metrics-p0.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    assert [r["step"] for r in rows] == list(range(1, 13))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5, losses
