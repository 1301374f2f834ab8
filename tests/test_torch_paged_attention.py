"""The port's paged attention (``kubeflow_controller_tpu_torch/ops``) held
against the JAX package's Pallas kernels, run in interpret mode on the
CPU as the JAX package's own tests run them, and against the gather
oracle.

On a CPU tensor each port wrapper runs its plain PyTorch version, which
repeats the CUDA kernel's page-by-page online softmax; the contract with
the Pallas kernels is the JAX package's declared ``PALLAS_TOL``
(``tests/test_paged_attention_pallas.py``): the two frameworks round
the same fp32 arithmetic in different places, a few ulps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu.ops.attention import paged_kv_view as jax_view
from kubeflow_controller_tpu_torch.ops import paged_attention as tpa
from kubeflow_controller_tpu_torch.ops.attention import paged_kv_view

pytestmark = pytest.mark.skipif(
    pap.pltpu is None, reason="pallas TPU backend not built into this jax")

# The JAX package's declared kernel-vs-oracle tolerance
# (tests/test_paged_attention_pallas.py:53).
PALLAS_TOL = dict(rtol=5e-6, atol=5e-6)

BS = 8          # page size (tokens)
MB = 4          # table width (pages per slot)
N_BLOCKS = 12   # pool pages; id N_BLOCKS is the sentinel


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _pools(rng, g, hd, quant, extra_page):
    """Random pools, with (extra_page) or without a spare sentinel page:
    the engine's pool has none, so sentinel ids must clamp to the last
    real page."""
    n = N_BLOCKS + int(extra_page)
    if quant:
        # Scales are amax / 127 for rows whose amax lies in [1, 4], the
        # range _kv_quantize gives roped K/V of unit scale. (Rows of
        # |x| ~ 25 would push the cross-framework difference past
        # PALLAS_TOL: the two frameworks reduce q.k in different orders,
        # and one fp32 ulp of a score that large, amplified by exp and
        # by cancelling values of that size, is ~1e-5 of the output.)
        k = rng.integers(-127, 128, (n, BS, g, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (n, BS, g, hd)).astype(np.int8)
        ks = (rng.uniform(1, 4, (n, BS, g)) / 127).astype(np.float32)
        vs = (rng.uniform(1, 4, (n, BS, g)) / 127).astype(np.float32)
        return k, v, ks, vs
    k = rng.standard_normal((n, BS, g, hd)).astype(np.float32)
    v = rng.standard_normal((n, BS, g, hd)).astype(np.float32)
    return k, v, None, None


def _tables(rng, b):
    """Shuffled tables whose tail rows carry SENTINEL entries."""
    tables = rng.integers(0, N_BLOCKS, (b, MB)).astype(np.int32)
    tables[0, 2:] = N_BLOCKS
    if b > 1:
        tables[1, 1:] = N_BLOCKS
    return tables


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _decode_oracle(q, k_pool, v_pool, tables, pos, ks, vs, width):
    """Decode attention through the port's gather oracle: the dense view
    and a full-row softmax."""
    k = paged_kv_view(k_pool, tables, width, ks, torch.float32)
    v = paged_kv_view(v_pool, tables, width, vs, torch.float32)
    s = torch.einsum("bgrd,bsgd->bgrs", q.float(), k) * (q.shape[-1] ** -0.5)
    mask = torch.arange(width)[None, :] <= pos[:, None].long()
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    return torch.einsum("bgrs,bsgd->bgrd", torch.softmax(s, -1), v)


# pos covers one visible column (pos=0), a page's last row, the row just
# past a page boundary, and the table's last column.
DECODE_POS = np.asarray([BS + 3, 0, BS - 1, MB * BS - 1], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("width", [None, 2 * BS, 3 * BS],
                         ids=["full", "cap2", "cap3"])
def test_decode_matches_pallas_and_oracle(quant, width):
    rng = np.random.default_rng(11 + int(quant))
    g, rep, hd, b = 2, 2, 16, 4
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=False)
    q = rng.standard_normal((b, g, rep, hd)).astype(np.float32)
    tables = _tables(rng, b)
    pos = DECODE_POS.copy()
    if width is not None:
        pos = np.minimum(pos, width - 1)   # the cap covers every visible column
    want = pap.paged_attention_decode(
        _j(q), _j(k), _j(v), _j(tables), _j(pos), k_scale=_j(ks),
        v_scale=_j(vs), width=width)
    got = tpa.paged_attention_decode(
        _t(q), _t(k), _t(v), _t(tables), _t(pos), k_scale=_t(ks),
        v_scale=_t(vs), width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)
    oracle = _decode_oracle(_t(q), _t(k), _t(v), _t(tables), _t(pos),
                            _t(ks), _t(vs), width or MB * BS)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **PALLAS_TOL)


def _chunk_oracle(q, k_new, v_new, k_pool, v_pool, tables, pos, ks, vs,
                  width):
    """Chunk attention through the gather oracle: cached columns < pos
    from the dense view, concatenated with the intra-chunk causal tile,
    one full-row softmax."""
    b, w, g, rep, hd = q.shape
    kc = paged_kv_view(k_pool, tables, width, ks, torch.float32)
    vc = paged_kv_view(v_pool, tables, width, vs, torch.float32)
    qf = q.float() * hd ** -0.5
    s_c = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc)
    s_c = torch.where((torch.arange(width)[None, :] < pos[:, None].long())
                      [:, None, None, None, :], s_c, float("-inf"))
    s_n = torch.einsum("bqgrd,bkgd->bgrqk", qf, k_new.float())
    s_n = torch.where(torch.ones(w, w, dtype=torch.bool).tril(), s_n,
                      float("-inf"))
    p = torch.softmax(torch.cat([s_c, s_n], -1), -1)
    return (torch.einsum("bgrqk,bkgd->bqgrd", p[..., :width], vc)
            + torch.einsum("bgrqk,bkgd->bqgrd", p[..., width:], v_new.float()))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("offset,width", [(0, None), (BS, None),
                                          (BS + 3, 2 * BS), (3 * BS, None)],
                         ids=["off0", "page", "mid-cap2", "last"])
def test_prefill_matches_pallas_and_oracle(quant, offset, width):
    """One slot's W-row chunk: offset 0 (nothing cached, every pool page
    fully masked), a page boundary, mid-page under a width cap, and the
    table's last page."""
    rng = np.random.default_rng(21 + offset + int(quant))
    g, rep, hd, w = 2, 2, 16, BS
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=False)
    q = rng.standard_normal((w, g, rep, hd)).astype(np.float32)
    kn = rng.standard_normal((w, g, hd)).astype(np.float32)
    vn = rng.standard_normal((w, g, hd)).astype(np.float32)
    row = rng.permutation(N_BLOCKS)[:MB].astype(np.int32)
    row[(offset + w - 1) // BS + 1:] = N_BLOCKS        # sentinel tail
    want = pap.paged_attention_prefill(
        _j(q), _j(kn), _j(vn), _j(k), _j(v), _j(row), offset,
        k_scale=_j(ks), v_scale=_j(vs), width=width)
    got = tpa.paged_attention_prefill(
        _t(q), _t(kn), _t(vn), _t(k), _t(v), _t(row), offset,
        k_scale=_t(ks), v_scale=_t(vs), width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)
    oracle = _chunk_oracle(
        _t(q)[None], _t(kn)[None], _t(vn)[None], _t(k), _t(v),
        _t(row)[None], torch.tensor([offset]), _t(ks), _t(vs),
        width or MB * BS)[0]
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **PALLAS_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_verify_matches_pallas_and_oracle(quant):
    """The K+1-wide verify window over a batch of slots, pools WITH a
    spare sentinel page (the shape the JAX package's own tests use)."""
    rng = np.random.default_rng(31 + int(quant))
    g, rep, hd, b, w = 2, 2, 16, 4, 5
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=True)
    q = rng.standard_normal((b, w, g, rep, hd)).astype(np.float32)
    kn = rng.standard_normal((b, w, g, hd)).astype(np.float32)
    vn = rng.standard_normal((b, w, g, hd)).astype(np.float32)
    tables = _tables(rng, b)
    pos = np.asarray([BS + 2, 0, BS, MB * BS - w], np.int32)
    want = pap.paged_attention_verify(
        _j(q), _j(kn), _j(vn), _j(k), _j(v), _j(tables), _j(pos),
        k_scale=_j(ks), v_scale=_j(vs))
    got = tpa.paged_attention_verify(
        _t(q), _t(kn), _t(vn), _t(k), _t(v), _t(tables), _t(pos),
        k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)
    oracle = _chunk_oracle(_t(q), _t(kn), _t(vn), _t(k), _t(v), _t(tables),
                           _t(pos), _t(ks), _t(vs), MB * BS)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **PALLAS_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("width", [MB * BS, 2 * BS + 3, 1])
def test_paged_kv_view_bitwise_equals_jax(quant, width):
    """The plain table gather is bitwise JAX's ``paged_kv_view``: same
    pages, sentinel ids clamped like ``mode="clip"``, int8 scales applied
    in fp32, the gather capped at ``width`` — for one layer's pool and
    for the stacked ``[L, ...]`` pool read through one slot's row."""
    rng = np.random.default_rng(41 + int(quant))
    k, _, ks, _ = _pools(rng, 2, 16, quant, extra_page=False)
    tables = _tables(rng, 3)
    want = jax_view(_j(k), _j(tables), width, _j(ks), jnp.float32)
    got = paged_kv_view(_t(k), _t(tables), width, _t(ks), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stacked = np.stack([k, k[::-1]])
    s_stacked = None if ks is None else np.stack([ks, ks[::-1]])
    want = jax_view(_j(stacked), _j(tables[0]), width, _j(s_stacked))
    got = paged_kv_view(_t(stacked), _t(tables[0]), width, _t(s_stacked))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pages_to_walk_matches_the_pallas_rule():
    """nb = min(ceil(min(width, mb*bs) / bs), mb), at least 1."""
    for width in (None, 1, BS - 1, BS, BS + 1, 3 * BS, 10 * BS):
        span = MB * BS if width is None else min(width, MB * BS)
        assert tpa.pages_to_walk(width, BS, MB) == min(
            max(1, -(-span // BS)), MB)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("pos", [0, BS + 3, 2 * BS], ids=["pos0", "mid", "boundary"])
def test_chunk_dead_pages_skip_is_exact(quant, pos):
    """The chunk kernel walks only pages that hold a visible column (c <
    pos): capping the plain walk at the live pages, width = max(1,
    ceil(pos / bs)) * bs, leaves prefill and verify bit for bit as the
    uncapped walk — once the intra-chunk tile has made the running max
    finite, a fully masked page adds exp(-1e30 - m) == 0 with alpha 1."""
    rng = np.random.default_rng(51 + pos + int(quant))
    g, rep, hd, w = 2, 2, 16, 5
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=False)
    q = rng.standard_normal((w, g, rep, hd)).astype(np.float32)
    kn = rng.standard_normal((w, g, hd)).astype(np.float32)
    vn = rng.standard_normal((w, g, hd)).astype(np.float32)
    row = rng.permutation(N_BLOCKS)[:MB].astype(np.int32)
    live = max(1, -(-pos // BS)) * BS
    assert tpa.pages_to_walk(live, BS, MB) < MB
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    pre = [tpa.paged_attention_prefill(
        _t(q), _t(kn), _t(vn), _t(k), _t(v), _t(row), pos, width=cap, **kw)
        for cap in (live, None)]
    assert torch.equal(pre[0], pre[1])
    ver = [tpa.paged_attention_verify(
        _t(q)[None], _t(kn)[None], _t(vn)[None], _t(k), _t(v), _t(row)[None],
        torch.tensor([pos], dtype=torch.int32), width=cap, **kw)
        for cap in (live, None)]
    assert torch.equal(ver[0], ver[1])
    assert torch.equal(ver[0][0], pre[0])


@pytest.mark.parametrize("groups,cols", [(8, 0), (8, 240), (8, 1024), (64, 2048),
                                         (1, 4096), (264, 16), (8, 1)])
def test_chunk_parts_cover_every_live_tile(groups, cols):
    """The tensor-core chunk kernel's split: part 0 is the intra-chunk
    tile, parts 1.. cover every 16-column pool tile exactly once in equal
    runs (the last may be short, never empty), at most MAX_PARTS in all,
    and no more blocks than the target unless one run per tile is
    already fewer."""
    parts, per = tpa.chunk_parts(groups, cols)
    tiles = -(-cols // tpa.TILE_COLS)
    assert 1 <= parts <= tpa.MAX_PARTS and per >= 1
    covered = [t for p in range(1, parts)
               for t in range((p - 1) * per, min(p * per, tiles))]
    assert covered == list(range(tiles))
    assert all((p - 1) * per < tiles for p in range(1, parts))
    if tiles:
        assert groups * (parts - 1) <= max(tpa.TARGET_BLOCKS, groups)


# -- the tensor-core decode kernel's walk, in plain arithmetic ---------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("pos", [0, BS + 3, 2 * BS - 1, 2 * BS],
                         ids=["pos0", "mid", "boundary", "past-boundary"])
def test_decode_dead_pages_skip_is_exact(quant, pos):
    """The decode kernel walks only pages that hold a visible column (c <=
    pos): capping the plain walk at the live pages, width = ceil((pos + 1)
    / bs) * bs, leaves the output bit for bit as the uncapped walk — page 0
    makes the running max finite, and a fully masked page adds
    exp(-1e30 - m) == 0 with alpha 1."""
    rng = np.random.default_rng(61 + pos + int(quant))
    g, rep, hd, b = 2, 2, 16, 2
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=False)
    q = rng.standard_normal((b, g, rep, hd)).astype(np.float32)
    tables = rng.integers(0, N_BLOCKS, (b, MB)).astype(np.int32)
    live = -(-(pos + 1) // BS) * BS
    assert tpa.pages_to_walk(live, BS, MB) < MB
    p = torch.full((b,), pos, dtype=torch.int32)
    got = [tpa.paged_attention_decode(
        _t(q), _t(k), _t(v), _t(tables), p, k_scale=_t(ks), v_scale=_t(vs),
        width=cap) for cap in (live, None)]
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("groups,cols", [(64, 288), (64, 2048), (8, 2048), (1, 4096),
                                         (264, 16), (8, 1), (64, 16), (512, 2048)])
def test_decode_parts_cover_every_live_tile(groups, cols):
    """The tensor-core decode kernel's split: the parts cover every
    16-column tile of the width cap exactly once in equal runs (the last
    may be short, never empty), each run at least one tile for each warp
    of a block, at most MAX_PARTS parts, and no more parts than bring
    the grid to the target."""
    parts, per = tpa.decode_parts(groups, cols)
    tiles = max(1, -(-cols // tpa.TILE_COLS))
    assert 1 <= parts <= tpa.MAX_PARTS and per >= tpa.DECODE_WARPS
    covered = [t for p in range(parts) for t in range(p * per, min((p + 1) * per, tiles))]
    assert covered == list(range(tiles))
    assert all(p * per < tiles for p in range(parts))
    assert parts <= max(1, -(-tpa.TARGET_BLOCKS // groups))


def _merge_states(states):
    """The kernel's merge of partial (m, l, acc) states: w_i = exp(m_i -
    max m) over the states with l_i > 0, empty states (l_i == 0) weighted
    0; returns the merged (m, l, acc), unnormalised."""
    ms = torch.stack([m for m, _, _ in states])
    ls = torch.stack([l for _, l, _ in states])
    accs = torch.stack([a for _, _, a in states])
    live = ls > 0
    m = torch.where(live, ms, float("-inf")).amax(0)
    w = torch.where(live, torch.exp(ms - m), 0.0)
    return m, (w * ls).sum(0), (w * accs).sum(0)


def _decode_split_plain(q, k_pool, v_pool, tables, pos, k_scale, v_scale,
                        width, per, warps=tpa.DECODE_WARPS):
    """The tensor-core decode kernel's arithmetic, in plain PyTorch: each
    slot's live columns c <= pos (below the width cap) in 16-column tiles,
    parts of ``per`` tiles; warp w of a part walks tiles t0 + w, t0 + w +
    warps, ... with the online softmax; the warps' states merge, then the
    parts' (a part past the slot's live tiles is empty)."""
    b, g, rep, hd = q.shape
    n_pages, bs = k_pool.shape[:2]
    mb = tables.shape[1]
    nb = tpa.pages_to_walk(width, bs, mb)
    tc = tpa.TILE_COLS
    parts = -(-max(1, -(-nb * bs // tc)) // per)
    out = torch.empty(b, g, rep, hd)
    for bi in range(b):
        live = min(int(pos[bi]) + 1, nb * bs)
        cols = torch.arange(-(-live // tc) * tc)
        ids = tables[bi, (cols // bs).clamp(max=mb - 1)].long().clamp(0, n_pages - 1)
        k = k_pool[ids, cols % bs].float()                  # [C, G, D]
        v = v_pool[ids, cols % bs].float()
        if k_scale is not None:
            k = k * k_scale[ids, cols % bs][..., None]
            v = v * v_scale[ids, cols % bs][..., None]
        k, v = k.transpose(0, 1), v.transpose(0, 1)         # [G, C, D]
        qf = q[bi].float()
        partials = []
        for p in range(parts):
            t1 = min((p + 1) * per, len(cols) // tc)
            states = []
            for w in range(warps):
                m = torch.full((g, rep, 1), float("-inf"))
                l, acc = torch.zeros((g, rep, 1)), torch.zeros((g, rep, hd))
                for t in range(p * per + w, t1, warps):
                    sl = slice(t * tc, (t + 1) * tc)
                    s = (qf @ k[:, sl].transpose(-1, -2)) * hd ** -0.5
                    s = torch.where(cols[sl] < live, s, tpa.MASK_VALUE)
                    m, l, acc = tpa._online_update(m, l, acc, s, v[:, sl])
                states.append((m, l, acc))
            partials.append(_merge_states(states))
        _, l, acc = _merge_states(partials)
        out[bi] = acc / l
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("per", [tpa.DECODE_WARPS, 1, 6])
def test_decode_split_merge_matches_sequential_and_pallas(quant, per):
    """The split walk and its in-launch merge (warps within a part, then
    parts, some of them empty: one slot at pos 0 has a single live tile)
    against the sequential plain decode (fp32: the orders differ by
    rounding only) and against the JAX package's Pallas decode in
    interpret mode (PALLAS_TOL, as test_decode_matches_pallas_and_oracle)."""
    rng = np.random.default_rng(71 + per + int(quant))
    g, rep, hd, b, mb = 2, 4, 16, 4, 16
    k, v, ks, vs = _pools(rng, g, hd, quant, extra_page=False)
    q = rng.standard_normal((b, g, rep, hd)).astype(np.float32)
    tables = rng.integers(0, N_BLOCKS, (b, mb)).astype(np.int32)
    pos = np.asarray([0, 9, 63, mb * BS - 1], np.int32)
    for bi, p in enumerate(pos):
        tables[bi, p // BS + 1:] = N_BLOCKS                 # sentinel tail
    got = _decode_split_plain(_t(q), _t(k), _t(v), _t(tables), _t(pos),
                              _t(ks), _t(vs), None, per)
    seq = tpa.paged_attention_decode(_t(q), _t(k), _t(v), _t(tables), _t(pos),
                                     k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-6, atol=1e-7)
    want = pap.paged_attention_decode(_j(q), _j(k), _j(v), _j(tables), _j(pos),
                                      k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)


def test_stream_buffers_are_keyed_by_stream(monkeypatch):
    """The merge counters and split scratch are one pair per (device,
    stream): distinct for distinct streams, the same tensors for the same
    stream while they are large enough, grown (counters zero) when a
    launch needs more."""
    monkeypatch.setattr(tpa, "_STREAM_BUFFERS", {})
    dev = torch.device("cpu")
    a = tpa._stream_buffers(dev, 1, 8, 100)
    b = tpa._stream_buffers(dev, 2, 8, 100)
    assert a[0].data_ptr() != b[0].data_ptr() and a[1].data_ptr() != b[1].data_ptr()
    again = tpa._stream_buffers(dev, 1, 4, 50)
    assert again[0] is a[0] and again[1] is a[1]
    grown = tpa._stream_buffers(dev, 1, 1000, 10 ** 6)
    assert grown[0].numel() >= 1000 and grown[1].numel() >= 10 ** 6
    assert grown[0].dtype == torch.int32 and not bool(grown[0].any())
    assert grown[1].dtype == torch.float32
    assert tpa._stream_buffers(dev, 2, 8, 100)[0] is b[0]
    assert tpa._stream_buffers(dev, 1, 8, 100)[1] is grown[1]


@pytest.mark.parametrize("dtype,rep,hd,quant,want_mma", [
    (torch.bfloat16, 4, 128, False, True), (torch.bfloat16, 4, 64, True, True),
    (torch.bfloat16, 16, 128, False, True), (torch.bfloat16, 32, 128, False, False),
    (torch.bfloat16, 4, 256, False, False), (torch.float32, 4, 128, False, False)],
    ids=["bf16-d128", "int8-d64", "rep16", "rep32", "d256", "fp32"])
def test_decode_plan_sizes_the_split_and_checks_operands(dtype, rep, hd, quant, want_mma):
    """The decode wrapper's per-configuration plan: the tensor-core kernel
    (bf16, head_dim 64/128, rep <= 16) gets decode_parts' split of the
    width cap and scratch for every part's (rep, D) accumulator and (m,
    l) pair; the first kernel one part and none; the struct carries the
    launch's shape arguments."""
    b, g, mb, bs, n_pages = 8, 8, 18, 16, 144
    kv = torch.int8 if quant else dtype
    pool = ((n_pages, bs, g, hd), kv)
    scale = ((n_pages, bs, g), torch.float32) if quant else None
    dims, addr, n_floats, ml_offset = tpa._decode_plan(
        (b, g, rep, hd), dtype, pool, pool, scale, scale, (b, mb), (b,), 288, None, None)
    parts, per = tpa.decode_parts(b * g, 288) if want_mma else (1, 1)
    assert (dims.parts, dims.tiles_per_part) == (parts, per)
    assert (dims.B, dims.G, dims.rep, dims.D, dims.bs, dims.mb, dims.nb,
            dims.last_page) == (b, g, rep, hd, bs, mb, 18, n_pages - 1)
    assert dims.q_dtype == tpa._DTYPE_CODES[dtype] and dims.quantized == int(quant)
    assert dims.sm_scale == pytest.approx(hd ** -0.5)
    assert addr != 0
    if parts > 1:
        assert ml_offset == 4 * b * g * parts * rep * hd
        assert n_floats == b * g * parts * rep * (hd + 2)
    else:
        assert n_floats == 0


def test_decode_plan_refuses_inconsistent_operands():
    bf = torch.bfloat16
    pool = ((144, 16, 8, 128), bf)
    ok = dict(q_shape=(8, 8, 4, 128), q_dtype=bf, k_pool=pool, v_pool=pool, k_scale=None,
              v_scale=None, tables_shape=(8, 18), pos_shape=(8,), width=288, sm_scale=None,
              out_dtype=None)
    tpa._decode_plan(**ok)
    for bad, err in (
            (dict(q_shape=(8, 4, 4, 128)), ValueError),              # KV heads differ
            (dict(pos_shape=(7,)), ValueError),
            (dict(tables_shape=(7, 18)), ValueError),
            (dict(out_dtype=torch.float32), TypeError),
            (dict(v_pool=((144, 16, 8, 128), torch.int8)), TypeError),
            (dict(k_scale=((144, 16, 8), torch.float32)), ValueError),  # k_scale alone
            (dict(q_dtype=torch.float16), TypeError)):
        with pytest.raises(err):
            tpa._decode_plan(**{**ok, **bad})
