"""The port's full-sequence ``transformer.forward`` (fp32 logits ``[B, S,
V]``) held against the JAX package's ``forward``, and against the port's
own decode and generation, on ``tiny_config`` weights from JAX's init
carried across with ``convert.params_from_numpy``.

* Dense (``remat`` off and on, tied head, packed rows with their
  ``positions`` and ``segment_ids``) and MoE logits within 2e-4 of JAX's
  (``tests/test_transformer.py:60-86``, ``tests/test_moe.py:156-170``).
* ``quant="int8"`` and ``"int8_fused"`` within :data:`INT8_LOGITS_REL`
  of JAX's quantized forward, and within the reference's own 0.05 of the
  unquantized forward (``tests/test_quant.py:132-140``).
* The mirrors of ``tests/test_transformer.py:25-42`` (shape, dtype,
  causality) and ``tests/test_generate.py:22-56`` on the port alone:
  cached decode equals ``forward`` at every position, and greedy
  ``generate`` equals the teacher-forced argmax.

The gang's case (``forward`` on every rank at fsdp=2 x tp=2) is
``tests/test_torch_parallel.py``'s ``fwd_fsdp2_tp2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

# tests/test_transformer.py's and tests/test_generate.py's atol.
LOGITS_ATOL = 2e-4
# Int8 projections: tests/test_torch_quant.py's QUANT_TOL[fp32] holds a
# two-layer decoder's loss within 3e-4 relative and every gradient leaf
# within 5e-2 relative L2 of JAX's, the leaf bound set by an int8 code
# that flips at a rounding tie between the frameworks and moves its
# row's product by a quantum. The logits pass through the same layers
# and the same flips: read over three seeds (weights and tokens; this
# test runs the first) and both modes, their relative L2 to JAX's is
# 1.2e-7 with no flip and at most 9.1e-3 with one. The limit is half the
# leaf bound, 2.7x the worst reading.
INT8_LOGITS_REL = 5e-2 / 2
# tests/test_torch_quant.py's widened decoder (B2 S64): under
# "int8_fused" wq, wo, w_gate, w_up and w_down take the fused route.
INT8_MODEL_KW = dict(d_model=128, d_ff=256)
# tests/test_quant.py:140: an int8 forward within 5% of the unquantized.
INT8_VS_FLOAT_REL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.key(seed)))


@pytest.fixture(scope="module")
def dense():
    return _np_params(jtfm.tiny_config())


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _jax_forward(jcfg, params, tokens, positions=None, segment_ids=None):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jtfm.forward(jcfg, jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(tokens), opt(positions),
                                   opt(segment_ids)))


def _port_forward(tcfg, params, tokens, positions=None, segment_ids=None):
    opt = lambda a: None if a is None else torch.tensor(a).long()  # noqa: E731
    with torch.no_grad():
        out = ttfm.forward(tcfg, params_from_numpy(params, "cpu"),
                           torch.from_numpy(tokens), opt(positions), opt(segment_ids))
    assert out.dtype == torch.float32
    return out.numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _packed(b, s):
    """Two documents and a padded tail in each row, the positions
    restarting at each document (``transformer.packed_positions``)."""
    segs = np.concatenate([np.full((b, 6), 1), np.full((b, s - 10), 2),
                           np.zeros((b, 4))], axis=1).astype(np.int32)
    pos = np.asarray(jtfm.packed_positions(jnp.asarray(segs)), np.int32)
    return pos, segs


@pytest.mark.parametrize("case", ["plain", "remat", "packed", "tied"])
def test_forward_matches_jax(dense, case):
    kw = {"remat": dict(remat=True), "tied": dict(tie_embeddings=True)}.get(case, {})
    jcfg, tcfg = jtfm.tiny_config(**kw), ttfm.tiny_config(**kw)
    params = dense
    if case == "tied":
        params = {k: v for k, v in dense.items() if k != "lm_head"}
    tokens = _tokens(jcfg, (2, 16), seed=1)
    pos, segs = _packed(2, 16) if case == "packed" else (None, None)
    want = _jax_forward(jcfg, params, tokens, pos, segs)
    got = _port_forward(tcfg, params, tokens, pos, segs)
    assert got.shape == (2, 16, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_moe_forward_matches_jax():
    jcfg, tcfg = jtfm.tiny_moe_config(), ttfm.tiny_moe_config()
    params = _np_params(jcfg)
    tokens = _tokens(jcfg, (4, 16), seed=1)
    np.testing.assert_allclose(_port_forward(tcfg, params, tokens),
                               _jax_forward(jcfg, params, tokens),
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "int8_fused"])
def test_int8_forward_matches_jax_and_stays_near_float(quant):
    jcfg = jtfm.tiny_config(quant=quant, **INT8_MODEL_KW)
    tcfg = ttfm.tiny_config(quant=quant, **INT8_MODEL_KW)
    params = _np_params(jcfg, seed=1)
    tokens = _tokens(jcfg, (2, 64), seed=1)
    got = _port_forward(tcfg, params, tokens)
    rel = _rel_l2(got, _jax_forward(jcfg, params, tokens))
    assert rel < INT8_LOGITS_REL, rel
    vs_float = _rel_l2(got, _port_forward(ttfm.tiny_config(**INT8_MODEL_KW), params,
                                          tokens))
    assert vs_float < INT8_VS_FLOAT_REL, vs_float


def test_forward_shapes(dense):
    cfg = ttfm.tiny_config()
    logits = _port_forward(cfg, dense, np.zeros((2, 16), np.int32))
    assert logits.shape == (2, 16, cfg.vocab_size) and logits.dtype == np.float32


def test_causality(dense):
    """Changing a future token must not change past logits."""
    cfg = ttfm.tiny_config()
    t1 = _tokens(cfg, (1, 16), seed=0)
    t2 = t1.copy()
    t2[0, 10:] = (t2[0, 10:] + 1) % cfg.vocab_size
    l1, l2 = _port_forward(cfg, dense, t1), _port_forward(cfg, dense, t2)
    np.testing.assert_allclose(l1[0, :10], l2[0, :10], atol=1e-5)
    assert not np.allclose(l1[0, 10:], l2[0, 10:])


def test_decode_logits_match_forward(dense):
    """Logits from cached single-token decode equal the full forward's at
    every position."""
    cfg = ttfm.tiny_config()
    toks = _tokens(cfg, (2, 12), seed=0)
    full = _port_forward(cfg, dense, toks)
    params = params_from_numpy(dense, "cpu")
    cache = tgen.init_kv_cache(cfg, 2, 16, device="cpu")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        for i in range(12):
            logits, cache = tgen.decode_step(cfg, params, t[:, i:i + 1], cache)
            np.testing.assert_allclose(full[:, i], logits.numpy(), atol=LOGITS_ATOL,
                                       rtol=0)


def test_greedy_generation_matches_teacher_forced(dense):
    """Greedy ``generate`` reproduces the step-by-step argmax of the full
    (uncached) forward."""
    cfg = ttfm.tiny_config()
    prompt = _tokens(cfg, (1, 6), seed=1)
    n_new = 8
    with torch.no_grad():
        out = tgen.generate(cfg, params_from_numpy(dense, "cpu"),
                            torch.from_numpy(prompt), n_new, max_seq=32)
    seq, want = prompt, []
    for _ in range(n_new):
        tok = _port_forward(cfg, dense, seq)[:, -1].argmax(-1).astype(np.int32)
        want.append(int(tok[0]))
        seq = np.concatenate([seq, tok[:, None]], axis=1)
    assert [int(t) for t in out[0]] == want
