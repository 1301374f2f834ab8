"""The port's flash attention (``kubeflow_controller_tpu_torch/ops``) held
against the JAX package's Pallas flash kernels, run in interpret mode on
the CPU as ``tests/test_flash_attention.py`` runs them, and against the
JAX package's dense path.

On CPU tensors each port wrapper runs its plain PyTorch version; the
inputs are drawn once with numpy and handed to both packages in fp32.
Tolerances are the JAX package's own flash-vs-dense contract
(``tests/test_flash_attention.py``): 2e-5 on outputs, and atol 5e-4 /
rtol 1e-3 on gradients — the two sides reduce the same fp32 products in
different orders (whole rows here, 128-wide blocks there) and the
backward's ``p * (dp - delta)`` cancels, which amplifies that order
difference in dq and dk.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models.transformer import rope as jax_rope
from kubeflow_controller_tpu.ops import attention as jax_attention
from kubeflow_controller_tpu.ops import flash_attention as jfa
from kubeflow_controller_tpu_torch.ops import attention as tattn
from kubeflow_controller_tpu_torch.ops import flash_attention as tfa

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

FWD_TOL = dict(rtol=0.0, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)

B, S, H, KVH, D = 2, 256, 4, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _inputs(seed, h=H, kv_h=KVH, s=S, d=D):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, s, h, d)).astype(np.float32)
    k = r.standard_normal((B, s, kv_h, d)).astype(np.float32)
    v = r.standard_normal((B, s, kv_h, d)).astype(np.float32)
    ct = r.standard_normal((B, s, h, d)).astype(np.float32)
    return q, k, v, ct


def _segments(s=S):
    """Two documents and a padding tail (id 0) in row 0; three documents
    in row 1 — boundaries off the 128-row blocks."""
    seg = np.zeros((B, s), np.int32)
    seg[0, :100], seg[0, 100:200] = 1, 2
    seg[1, :40], seg[1, 40:170], seg[1, 170:] = 1, 2, 3
    return seg


def _positions(s=S):
    """Per-row offsets, so the tables' batch indexing is exercised."""
    return (np.arange(s)[None, :] + np.array([[0], [17]])).astype(np.int32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _tables(with_rope, d=D):
    if not with_rope:
        return None, None
    pos = _positions()
    jt = jfa.rope_full_tables(jnp.asarray(pos), d, 10000.0)
    tt = tfa.rope_full_tables(torch.from_numpy(pos), d, 10000.0)
    return jt, tt


def test_rope_full_tables_match():
    pos = _positions()
    jc, js = jfa.rope_full_tables(jnp.asarray(pos), D, 500000.0)
    tc, ts = tfa.rope_full_tables(torch.from_numpy(pos), D, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FWD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FWD_TOL)


def test_apply_rope_tables_matches_jax_and_reference_rope():
    q = _inputs(0)[0]
    jt, tt = _tables(True)
    got = tattn.apply_rope_tables(torch.from_numpy(q), tt).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_attention.apply_rope_tables(jnp.asarray(q), jt)),
        **FWD_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_rope(jnp.asarray(q), jnp.asarray(_positions()),
                                 10000.0)), atol=1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_rope_rotate_plain_matches_jax_rope_rot(d):
    """The rope prepass's plain version against the JAX kernels' tile
    rotation ``_rope_rot`` on bf16 q and k, bit for bit after the bf16
    cast: both take two fp32 products, their sum and one cast, with no
    fused multiply-add. On CPU tensors the wrapper is that plain version
    and launches nothing."""
    r = np.random.default_rng(30)
    jt, tt = _tables(True, d)
    pairs = []
    for heads in (H, KVH):
        xj = jnp.asarray(r.standard_normal((B, S, heads, d)).astype(np.float32), jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
        pairs.append((xj, xt))
    tfa.reset_launches()
    got = tfa.rope_rotate(pairs[0][1], pairs[1][1], tt)
    assert tfa.LAUNCHES["rope_rotate"] == 0
    for (xj, xt), g in zip(pairs, got):
        assert g.dtype == torch.bfloat16 and g.shape == xt.shape
        for b in range(B):
            for hd in range(xt.shape[2]):
                want = jfa._rope_rot(xj[b, :, hd], jt[0][b], jt[1][b], True)
                np.testing.assert_array_equal(
                    g[b, :, hd].float().numpy(),
                    np.asarray(want.astype(jnp.float32)))
        assert torch.equal(g, tfa._rope_rot(xt, *tt))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segments", [False, True], ids=["dense", "segments"])
@pytest.mark.parametrize("kv_h", [KVH, H], ids=["gqa", "mha"])
def test_mha_xla_matches_jax(causal, segments, kv_h):
    q, k, v, _ = _inputs(1, kv_h=kv_h)
    seg = _segments() if segments else None
    want = jax_attention.mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal,
                                 segment_ids=None if seg is None else jnp.asarray(seg))
    got = tattn.mha_xla(_t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _jax_bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("block", [128, 256], ids=["two_pass", "single_tile"])
@pytest.mark.parametrize("causal,segments,rope", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, False), (True, False, True), (True, True, True),
], ids=["causal", "full", "causal_seg", "full_seg", "causal_rope",
        "causal_seg_rope"])
def test_forward_and_lse_match_jax_fwd(block, causal, segments, rope):
    """The plain forward's o and lse against the JAX package's ``_fwd``
    (the Pallas forward kernel and its narrow lse residual)."""
    q, k, v, _ = _inputs(2)
    seg = _segments() if segments else None
    jt, tt = _tables(rope)
    o_j, lse_j = jfa._fwd(
        _jax_bhsd(q), _jax_bhsd(k), _jax_bhsd(v),
        None if seg is None else jnp.asarray(seg), jt, causal, block, block,
        True)
    o_t, lse_t = tfa.flash_fwd(_t(q), _t(k), _t(v), _t(seg), tt, causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j).transpose(0, 2, 1, 3),
                               **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)


def _jax_grads(q, k, v, ct, causal, seg, jt, block):
    flash = functools.partial(jfa.flash_mha, causal=causal, block_q=block,
                              block_k=block, interpret=True, rope_tables=jt,
                              segment_ids=None if seg is None else jnp.asarray(seg))
    loss = lambda q, k, v: (flash(q, k, v) * jnp.asarray(ct)).sum()  # noqa: E731
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _port_grads(q, k, v, ct, causal, seg, tt, block):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_mha(qt, kt, vt, causal=causal, segment_ids=_t(seg),
                        block_q=block, block_k=block, rope_tables=tt)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(ct))


@pytest.mark.parametrize("block", [128, 256], ids=["two_pass", "fused"])
@pytest.mark.parametrize("causal,segments,rope,kv_h", [
    (True, False, False, KVH), (False, False, False, KVH),
    (True, True, False, KVH), (True, False, True, KVH),
    (True, True, True, KVH), (True, False, True, H),
], ids=["causal_gqa", "full_gqa", "causal_seg_gqa", "causal_rope_gqa",
        "causal_seg_rope_gqa", "causal_rope_mha"])
def test_grads_match_jax_flash(block, causal, segments, rope, kv_h):
    """dq/dk/dv of the port's Function through its fused (block == S) and
    two-pass (block < S) plain backward against ``jax.grad`` of the JAX
    package's flash_mha at the same blocks (fused resp. two-pass Pallas
    backward)."""
    q, k, v, ct = _inputs(3, kv_h=kv_h)
    seg = _segments() if segments else None
    jt, tt = _tables(rope)
    assert tfa.single_tile(S, block, block, segments) == (block == S)
    want = _jax_grads(q, k, v, ct, causal, seg, jt, block)
    got = _port_grads(q, k, v, ct, causal, seg, tt, block)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_plain_backward_routes_agree():
    """The fused plain backward and the two-pass plain backward compute
    the same gradients (one score recompute vs two)."""
    q, k, v, ct = (torch.from_numpy(x) for x in _inputs(4))
    seg = torch.from_numpy(_segments())
    tt = _tables(True)[1]
    o, lse = tfa.flash_fwd(q, k, v, seg, tt, True)
    fused = tfa.flash_bwd_fused(q, k, v, o, lse, ct, seg, tt, True)
    delta = tfa.attention_delta(o, ct)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, ct, lse, delta, seg, tt, True)
    dq = tfa.flash_bwd_dq(q, k, v, ct, lse, delta, seg, tt, True)
    for a, b in zip(fused, (dq, dk, dv)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,block,segments,fused", [
    (1024, 1024, False, True), (2048, 1024, False, False),
    (256, 1024, True, True), (384, 128, True, False), (192, 128, False, False),
])
def test_backward_route_follows_the_jax_block_rule(s, block, segments, fused):
    """The flagship's S=1024 takes the fused backward and llama's S=2048
    the two-pass one, as in the JAX package (``_bwd`` :1081)."""
    assert tfa.single_tile(s, block, block, segments) is fused
    bq = jfa._choose_block(s, block, lane_aligned=segments)
    assert (s // bq == 1) is fused


def test_choose_block_refuses_as_jax_does():
    with pytest.raises(ValueError, match="pad the sequence"):
        jfa._choose_block(132, 64)
    with pytest.raises(ValueError, match="pad the sequence"):
        tfa._choose_block(132, 64)
    assert tfa._choose_block(192, 128) == jfa._choose_block(192, 128) == 96


def test_launch_counters_stay_zero_on_cpu():
    tfa.reset_launches()
    q, k, v, ct = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(5))
    out = tfa.flash_mha(q, k, v)
    out.backward(ct)
    assert all(n == 0 for n in tfa.LAUNCHES.values())
    assert q.grad is not None and k.grad is not None


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_mha_dispatch_on_cpu_matches_dense(impl):
    """On the CPU "auto" takes the dense path (as off a TPU); every impl
    computes the same attention."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6))
    tt = _tables(True)[1]
    want = tattn.mha_xla(tattn.apply_rope_tables(q, tt),
                         tattn.apply_rope_tables(k, tt), v)
    got = tattn.mha(q, k, v, impl=impl, rope_tables=tt)
    torch.testing.assert_close(got, want, **FWD_TOL)


def test_mha_refuses_unknown_impl():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(7))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.mha(q, k, v, impl="ring")


def test_flash_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A non-CPU tensor must launch the kernel or raise — never fall back
    to the plain version."""
    q = torch.zeros((1, 64, 2, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA kernel on cuda tensors"):
        tfa.flash_fwd(q, q, q)
    lse = torch.zeros((1, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="CUDA kernel on cuda tensors"):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("segments", [False, True], ids=["dense", "segments"])
@pytest.mark.parametrize("kv_h", [KVH, H], ids=["gqa", "mha"])
def test_fused_backward_rotate_once_decomposition(causal, segments, kv_h):
    """The route the fused backward takes at head_dim 64 and 128: q and k
    rotated once (the rope prepass), the score recompute on plain tiles
    with no tables, fp32 dq and dk counter-rotated before the group fold
    and the cast (dq through the postprocess's plain version, delta and
    the zeroed scratch through the prepass's). Bit for bit the plain
    fused backward with tables; within GRAD_TOL of ``jax.grad`` through
    the JAX package's fused Pallas backward."""
    q, k, v, ct = _inputs(8, kv_h=kv_h)
    seg = _segments() if segments else None
    jt, tt = _tables(True)
    qt_, kt_, vt_, dot_ = (torch.from_numpy(x) for x in (q, k, v, ct))
    seg_t = _t(seg)
    o, lse = tfa.flash_fwd(qt_, kt_, vt_, seg_t, tt, causal)
    want = tfa.flash_bwd_fused_plain(qt_, kt_, vt_, o, lse, dot_, seg_t, tt, causal)

    qr, kr = tfa.rope_rotate(qt_, kt_, tt)
    delta, dq_acc = tfa.flash_bwd_prep(o, dot_)
    assert torch.equal(delta, tfa.attention_delta(o, dot_))
    assert not dq_acc.any() and dq_acc.dtype == torch.float32
    qh, kh, p, ds = tfa._bwd_terms(qr, kr, vt_, dot_, lse, delta, seg_t, None, causal)
    dk, dv = tfa._dkdv_from(qh, p, ds, dot_, tt, kt_, vt_)
    dq_acc += (ds.to(kh.dtype).float() @ kh.float()).transpose(1, 2)
    dq = tfa._rope_rot(dq_acc, tt[0], -tt[1]).to(qt_.dtype)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.equal(got, w), name
    # The postprocess's plain version rounds the same way, then casts to bf16.
    assert torch.equal(tfa.flash_bwd_post(dq_acc, tt), dq.to(torch.bfloat16))
    jax_want = _jax_grads(q, k, v, ct, causal, seg, jt, S)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), jax_want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("segments", [False, True], ids=["dense", "segments"])
@pytest.mark.parametrize("kv_h", [KVH, H], ids=["gqa", "mha"])
def test_two_pass_backward_rotate_once_decomposition(causal, segments, kv_h):
    """The route the two-pass backward takes at head_dim 64 and 128: q and
    k rotated once for both passes (the rope prepass), delta from the
    prepass's plain version (no scratch), the dk/dv and dq passes on the
    rotated tiles with no tables, fp32 dk and dq counter-rotated before
    the group fold and the cast. Bit for bit the plain two-pass backward
    with tables; within GRAD_TOL of ``jax.grad`` through the JAX
    package's two-pass Pallas backward (block 128 < S)."""
    q, k, v, ct = _inputs(9, kv_h=kv_h)
    seg = _segments() if segments else None
    jt, tt = _tables(True)
    qt_, kt_, vt_, dot_ = (torch.from_numpy(x) for x in (q, k, v, ct))
    seg_t = _t(seg)
    o, lse = tfa.flash_fwd(qt_, kt_, vt_, seg_t, tt, causal)
    want_delta = tfa.attention_delta(o, dot_)
    want = (tfa.flash_bwd_dq_plain(qt_, kt_, vt_, dot_, lse, want_delta, seg_t, tt, causal),
            *tfa.flash_bwd_dkdv_plain(qt_, kt_, vt_, dot_, lse, want_delta, seg_t, tt,
                                      causal))

    qr, kr = tfa.rope_rotate(qt_, kt_, tt)
    delta, scratch = tfa.flash_bwd_prep(o, dot_, scratch=False)
    assert scratch is None and torch.equal(delta, want_delta)
    a = (vt_, dot_, lse, delta, seg_t, tt, causal)
    dk, dv = tfa.flash_bwd_dkdv_rotated_plain(qr, kr, *a)
    dq = tfa.flash_bwd_dq_rotated_plain(qr, kr, *a)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.equal(got, w), name
    # The backward's own two-pass route on CPU tensors runs the same plain
    # versions.
    for name, got, w in zip(("dq", "dk", "dv"),
                            tfa.flash_bwd_two_pass(qt_, kt_, vt_, o, lse, dot_, seg_t, tt,
                                                   causal), want):
        assert torch.equal(got, w), name
    assert not tfa.single_tile(S, 128, 128, segments)
    jax_want = _jax_grads(q, k, v, ct, causal, seg, jt, 128)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), jax_want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)
