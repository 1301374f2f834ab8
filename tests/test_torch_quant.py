"""The port's int8 projection path (``ops/quant.py``, ``ops/quant_fused.py``
and the decoder with ``quant``) held against the JAX package on the CPU.

The JAX side runs under ``jax.jit``, as the JAX package trains, with the
fused Pallas kernel in interpret mode (as ``tests/test_quant.py`` runs
it). Under ``jit`` XLA turns the division by 127 into a multiplication
by fp32(1/127); the port computes that form, so at op level the two
packages agree bit for bit: the codes, the scales, the exact int32 sums
and the fp32 dequantization in the same order. On CPU tensors the fused
wrapper runs its plain version, so these tests also pin the arithmetic
the CUDA kernel is held to on the card (bit for bit, in chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane.entrypoints import lm as jlm
from kubeflow_controller_tpu.models import transformer as jtf
from kubeflow_controller_tpu.ops import quant as jq
from kubeflow_controller_tpu.ops import quant_pallas as jqp
from kubeflow_controller_tpu_torch import convert
from kubeflow_controller_tpu_torch.models import transformer as ttf
from kubeflow_controller_tpu_torch.ops import quant as tq
from kubeflow_controller_tpu_torch.ops import quant_fused as tqf

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = got != want
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} differ"


def _rows(m, k, seed, dtype=np.float32):
    """Normal rows with the cases that matter for the codes: a row of
    exact .5 ties (abs-max 127 gives scale 1.0), an all-zero row (the
    1e-30 floor) and an outlier row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0] = np.arange(k) % 254 - 126.5
    x[0, 0] = 127.0
    x[1] = 0.0
    x[2] *= 1000.0
    return x.astype(dtype)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(dtype)


# -- op level, bit for bit ------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_matches_jitted_jax(dtype, axis):
    x = _rows(64, 256, seed=0)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    xj, xt = _pair(x, dtype)
    qj, sj = jax.jit(lambda a: jq._quantize(a, axis))(xj)
    qt, st = tq._quantize(xt, axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    _same(qt, qj, "codes")
    _same(st, sj, "scales")


def test_quantize_ties_floor_and_outlier():
    """The reference's own semantics on the special rows: scale 1.0 and
    codes rounded half to even where the abs-max is 127, the 1e-30 floor
    on an all-zero row (codes 0), and an outlier row that does not touch
    the scales of the others."""
    x = _rows(8, 256, seed=1)
    q, s = tq._quantize(torch.from_numpy(x), 1)
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q[0].numpy(), np.round(x[0]).clip(-127, 127))
    assert float(s[1]) == np.float32(np.float32(1e-30) * np.float32(tq.INV_127))
    assert not q[1].any()
    assert float(s[2]) > 100 * float(s[3:].max())


def test_int8_matmul_raw_matches_jitted_jax():
    x, w = _rows(96, 256, seed=2), _rows(256, 72, seed=3)
    want = jax.jit(jq._int8_matmul_raw)(jnp.asarray(x), jnp.asarray(w))
    _same(tq._int8_matmul_raw(torch.from_numpy(x), torch.from_numpy(w)), want)


@pytest.mark.parametrize("m,k,n", [(5, 12, 9), (16, 64, 40), (24, 100, 8)])
def test_int_mm_pads_shapes_the_card_refuses(m, k, n):
    """Shapes outside cuBLASLt's int8 rule (m > 16, k and n multiples of
    8) are zero-padded: the int32 sums stay exact."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = tq._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


def _grads_both(jfn, tfn, x, w, cot, dtype=torch.float32):
    """Forward, dx and dw of ``jfn`` (jitted, ``jax.grad`` of the output
    against ``cot``) and of ``tfn`` on the same values."""
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)

    def loss(a, b):
        return (jfn(a, b).astype(jnp.float32) * cot).sum()

    yj = jax.jit(jfn)(xj, wj)
    dxj, dwj = jax.jit(jax.grad(loss, argnums=(0, 1)))(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    yt = tfn(xt, wt)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(cot).to(yt.dtype))
    return (yt, dxt, dwt), (yj, dxj, dwj)


def test_int8_matmul_and_its_gradients_match_jitted_jax():
    x = _rows(2 * 48, 128, seed=4).reshape(2, 48, 128)
    w = _rows(128, 80, seed=5)
    cot = np.random.default_rng(6).standard_normal((2, 48, 80)).astype(np.float32)
    got, want = _grads_both(jq.int8_matmul, tq.int8_matmul, x, w, cot)
    assert got[0].dtype == torch.float32
    for name, g, w_ in zip(("y", "dx", "dw"), got, want):
        _same(g, w_, name)


@pytest.mark.parametrize("m,k,n", [(256, 256, 384), (128, 4096, 512)],
                         ids=["256x256x384", "k4096_third_rung"])
def test_fused_plain_matches_jitted_pallas_kernel(m, k, n):
    """The plain version against the Pallas kernel (interpret mode, under
    jit), at the JAX test's shape and at k = 4096, where ``_pick_blocks``
    takes its third rung (bm 128, bn 512)."""
    assert jqp._pick_blocks(m, k, n) == tqf._pick_blocks(m, k, n)
    a = _rows(m, k, seed=7)
    b = np.random.default_rng(8).standard_normal((k, n)).astype(np.float32)
    aj, at = _pair(a, torch.bfloat16)
    want = jax.jit(jqp.fused_int8_matmul_2d)(aj, jnp.asarray(b))
    got = tqf.fused_int8_matmul_2d_plain(at, torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _same(got, want)
    # On CPU tensors the wrapper is the plain version, and launches nothing.
    tqf.reset_launches()
    _same(tqf.fused_int8_matmul_2d(at, torch.from_numpy(b)), want)
    assert tqf.LAUNCHES == {"int8_quantize_rows": 0, "int8_matmul": 0,
                            "int8_quantize_rows_scaled": 0, "int8_matmul_f32": 0}


@pytest.mark.parametrize("k", [128, 1024, 4096])
def test_quantize_rows_plain_matches_jitted_jax(k):
    """The row-quantize prepass's plain version against the jitted
    ``_quantize(axis=1)`` on bf16 rows, bit for bit (the same IEEE steps:
    abs-max, times fp32(1/127), a division, round half to even, clip), on
    the tie, all-zero and outlier rows too. On CPU tensors the wrapper is
    that plain version and launches nothing."""
    aj, at = _pair(_rows(16, k, seed=20), torch.bfloat16)
    qj, sj = jax.jit(lambda a: jq._quantize(a, 1))(aj)
    qt, st = tqf.quantize_rows_plain(at)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert qt.shape == (16, k) and st.shape == (16, 1)
    _same(qt, qj, "codes")
    _same(st, sj, "scales")
    assert float(st[0]) == 1.0 and not qt[1].any()      # the tie row, the zero row
    tqf.reset_launches()
    qw, sw = tqf.quantize_rows(at)
    _same(qw, qj, "codes through the wrapper")
    _same(sw, sj, "scales through the wrapper")
    assert tqf.LAUNCHES["int8_quantize_rows"] == 0


@pytest.mark.parametrize("orientation", ["forward_w", "dx_w_transposed"])
def test_rhs_codes_are_the_transposed_column_codes(orientation):
    """The GEMM kernel reads the rhs codes as [n, k]: the same codes and
    scales as the jitted ``_quantize(b, axis=0)`` (exact equality: one
    abs-max and an elementwise pass either way), transposed and
    contiguous, for the forward's ``w [k, n]`` and for dx's ``w.T``,
    whose [n, k] form is ``w``'s own layout."""
    w = _rows(256, 384, seed=21) * 0.05
    b = w if orientation == "forward_w" else np.ascontiguousarray(w).T
    qj, sj = jax.jit(lambda x: jq._quantize(x, 0))(jnp.asarray(b))
    bt = torch.from_numpy(np.ascontiguousarray(w))
    qbt, sb = tqf.rhs_codes(bt if orientation == "forward_w" else bt.T)
    k, n = b.shape
    assert qbt.shape == (n, k) and qbt.is_contiguous() and qbt.dtype == torch.int8
    assert sb.shape == (1, n) and sb.is_contiguous()
    _same(qbt.T, qj, "codes")
    _same(sb, sj, "scales")
    # The plain product on those codes is the wrapper's result.
    a = torch.from_numpy(_rows(128, k, seed=22)).to(torch.bfloat16)
    _same(tqf._fused_plain(a, qbt, sb),
          tqf.fused_int8_matmul_2d(a, bt if orientation == "forward_w" else bt.T))


@pytest.mark.parametrize("n", [384, 4224], ids=["dx_fused", "dx_composed"])
def test_fused_int8_matmul_and_its_gradients_match_jitted_jax(n):
    """Forward through the kernel; dx through the kernel (n = 384) or,
    where ``fusable`` refuses dx's orientation (contraction n = 4224 >
    4096), through the composed path; dw always composed. bf16 operands,
    as the model passes them."""
    m, k = 128, 256 if n == 384 else 128
    assert tqf.fusable(m, k, n)
    assert tqf.fusable(m, n, k) == (n == 384)
    x, w = _rows(m, k, seed=9), _rows(k, n, seed=10) * 0.05
    cot = np.random.default_rng(11).standard_normal((m, n)).astype(np.float32)
    got, want = _grads_both(jqp.fused_int8_matmul, tqf.fused_int8_matmul, x, w,
                            cot, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    for name, g, w_ in zip(("y", "dx", "dw"), got, want):
        _same(g, w_, name)


def test_fusable_and_pick_blocks_match_jax():
    sizes = [64, 100, 128, 256, 384, 512, 1000, 1024, 2048, 3072, 4096, 4224,
             8192, 14336, 16384]
    for m in (128, 256, 384, 1024, 4096, 16384, 100):
        for k in sizes:
            for n in sizes:
                assert tqf.fusable(m, k, n) == jqp.fusable(m, k, n), (m, k, n)
                assert tqf._pick_blocks(m, k, n) == jqp._pick_blocks(m, k, n)
    # test_fusable_gate's four, and the main path's shapes.
    assert tqf.fusable(16384, 1024, 4096) and tqf.fusable(16384, 4096, 1024)
    assert not tqf.fusable(16384, 8192, 1024)
    assert not tqf.fusable(16384, 1000, 512)
    assert not tqf.fusable(4096, 14336, 4096)        # llama w_down forward


def test_maybe_quant_dot_fused_falls_back_at_k100():
    x = _rows(32, 100, seed=12).reshape(4, 8, 100)
    w = _rows(100, 64, seed=13)
    xj, xt = _pair(x, torch.bfloat16)
    wj, wt = _pair(w, torch.bfloat16)
    want = jax.jit(lambda a, b: jq.maybe_quant_dot(a, b, "int8_fused"))(xj, wj)
    got = tq.maybe_quant_dot(xt, wt, "int8_fused")
    assert got.shape == (4, 8, 64) and got.dtype == torch.bfloat16
    _same(got, want)
    _same(tq.maybe_quant_dot(xt, wt, "int8"), want)


def test_fused_wrapper_refuses_unfusable_shapes_and_other_devices():
    a = torch.zeros((128, 100), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not fusable"):
        tqf.fused_int8_matmul_2d(a, torch.zeros((100, 128)))
    meta = torch.zeros((128, 128), device="meta")
    with pytest.raises(RuntimeError, match="CUDA kernel on cuda tensors"):
        tqf.fused_int8_matmul_2d(meta, meta)


# -- the decoder ------------------------------------------------------------------

# The tiny decoder widened to d_model 128, d_ff 256 (B2 S64, m = 128):
# wq, wo, w_gate, w_up, w_down and their dx take the fused route, wk/wv
# (n = 64) fall back to the composed one, as in the JAX package.
MODEL_KW = dict(d_model=128, d_ff=256)

# Loss and gradients against jitted JAX. At op level the two packages
# agree bit for bit (above), but each int8 code rounds an fp32 (or bf16)
# activation whose upstream sums (rmsnorm, attention, the residual
# stream, the loss) run in another order in the two frameworks, so a
# code can flip at a rounding tie, and in the fused path an fp32 lhs can
# round to the other bf16 neighbour; one flip moves its row's product by
# a quantization step, and the flips carry forward and back through both
# layers. Read over three seeds (params and tokens; this test runs the
# first): fp32 loss within 8.7e-5 relative and the worst leaf within
# 1.9e-2 relative L2 (with no flip at all, as the fused path at the
# first seed, 2.3e-7); bf16 loss within 3.4e-4 and the worst leaf 4.2e-2
# (bf16 without int8 reads 2.0e-2: the rounding points the two
# frameworks place differently, test_torch_train.py). Limits are 2-3x
# the worst reading.
QUANT_TOL = {torch.float32: dict(loss=3e-4, leaf=5e-2),
             torch.bfloat16: dict(loss=1e-3, leaf=8e-2)}


def _model_pair(quant, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = jtf.tiny_config(quant=quant, dtype=jdt, **MODEL_KW)
    tc = ttf.tiny_config(quant=quant, dtype=dtype, **MODEL_KW)
    return jc, tc


def _port_loss_and_grads(tc, params, tokens):
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    loss, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(tokens)})
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quant", ["int8", "int8_fused"])
def test_quant_decoder_loss_and_every_gradient_match_jax(quant, dtype):
    jc, tc = _model_pair(quant, dtype)
    params = jax.device_get(jtf.init_params(jc, jax.random.key(0)))
    tokens = next(jlm.synthetic_lm(jc.vocab_size, 2, 64, seed=1))["tokens"]
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.next_token_loss(jc, p, {"tokens": t}), has_aux=True))(
            params, jnp.asarray(tokens))
    lt, gt = _port_loss_and_grads(tc, params, tokens)
    tol = QUANT_TOL[dtype]
    np.testing.assert_allclose(lt, float(lj), rtol=tol["loss"])
    for n, g, w in zip(_names(params), gt, convert.tree_leaves(jax.device_get(gj))):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(_np(g) - w) / np.linalg.norm(w)
        assert rel <= tol["leaf"], (n, rel)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def test_bf16_int8_and_int8_fused_are_one_function():
    """In bf16 the fused path's bf16 rounding of its lhs and output is
    what a bf16 model does anyway: the two modes give the same loss and
    the same gradients, bit for bit."""
    out = {}
    for quant in ("int8", "int8_fused"):
        _, tc = _model_pair(quant, torch.bfloat16)
        params = convert.params_to_numpy(ttf.init_params(tc, seed=2, device="cpu"))
        tokens = next(jlm.synthetic_lm(tc.vocab_size, 2, 64, seed=3))["tokens"]
        out[quant] = _port_loss_and_grads(tc, params, tokens)
    assert out["int8"][0] == out["int8_fused"][0]
    for a, b in zip(out["int8"][1], out["int8_fused"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_route_counts_match_the_jax_routing(monkeypatch):
    """Which calls take the fused route at the test size, counted through
    the wrapper (remat re-runs each layer's forward): per layer 5 fused
    forwards (wk/wv fall back) and 5 fused dx, and 5 more under remat."""
    calls = []
    real = tqf._fused_2d

    def counting(a, b, group=None):
        calls.append(tuple(a.shape) + (b.shape[1],))
        return real(a, b, group)

    monkeypatch.setattr(tqf, "_fused_2d", counting)
    for remat, want in ((False, 10), (True, 15)):
        calls.clear()
        _, tc = _model_pair("int8_fused", torch.bfloat16)
        tc = tc.replace(remat=remat)
        params = convert.params_to_numpy(ttf.init_params(tc, seed=4, device="cpu"))
        tokens = next(jlm.synthetic_lm(tc.vocab_size, 2, 64, seed=5))["tokens"]
        _port_loss_and_grads(tc, params, tokens)
        assert len(calls) == want * tc.n_layers, (remat, calls)
