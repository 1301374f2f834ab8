"""Each count of ``gpubench/counts`` against a case worked by hand."""

import pytest

from gpubench.counts import attention as att
from gpubench.counts import model as mdl
from gpubench.counts.peaks import H100, bound_s, peaks_for


def test_causal_pairs():
    assert att.causal_pairs([1, 2, 3]) == 1 + 3 + 6


def test_flash_fwd_by_hand():
    # 2 documents of 2 tokens: 3 pairs each; H=2, KVH=1, D=4
    flops, nbytes = att.flash_fwd(tokens=4, pairs=6, H=2, KVH=1, D=4)
    assert flops == 4 * 6 * 2 * 4
    # q and o: 4 x 2 x 4 x 2 bytes each; k and v: 4 x 1 x 4 x 2 each; cos, sin 4 x 4 x 4
    assert nbytes == 64 + 64 + 32 + 32 + 128


def test_flash_bwd_by_hand():
    flops, nbytes = att.flash_bwd(tokens=4, pairs=6, H=2, KVH=1, D=4)
    assert flops == 8 * 6 * 2 * 4
    reads = 4 * (3 * 2 + 2 * 1) * 4 * 2 + 4 * 2 * 4 + 2 * 4 * 4 * 4
    writes = 4 * (2 + 2) * 4 * 2
    assert nbytes == reads + writes


def test_paged_decode_by_hand():
    flops, nbytes = att.paged_decode([3, 5], H=4, KVH=2, D=8)
    assert flops == 4 * 8 * 4 * 8
    assert nbytes == 8 * 2 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2


def test_paged_chunk_by_hand():
    flops, nbytes = att.paged_chunk(width=2, offset=3, H=1, KVH=1, D=2)
    assert flops == 4 * (2 * 3 + 3) * 1 * 2
    assert nbytes == (2 * 4 * 2 + 3 * 2 * 2) * 2


C = {"vocab_size": 10, "d_model": 4, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
     "d_ff": 6}


def test_matmul_params_dense_and_moe():
    attn = 4 * (2 + 2) * 2 + 2 * 2 * 4          # wq, wk, wv, wo
    assert mdl.matmul_params(C) == 2 * (attn + 3 * 4 * 6) + 4 * 10
    moe = dict(C, moe_experts=4, moe_top_k=2)
    assert mdl.matmul_params(moe) == 2 * (attn + 2 * 3 * 4 * 6 + 4 * 4) + 4 * 10


def test_forward_prefill_and_train_flops():
    n = mdl.matmul_params(C)
    assert mdl.attn_flops(C, 5) == 4 * 2 * 2 * 2 * 5
    assert mdl.forward_token(C, 5) == 2 * n + mdl.attn_flops(C, 5)
    assert mdl.prefill(C, 3) == sum(mdl.forward_token(C, i + 1) for i in range(3))
    assert mdl.chunk(C, 2, 3) == mdl.forward_token(C, 4) + mdl.forward_token(C, 5)
    assert mdl.train_row(C, [2, 1]) == 6 * n * 3 + 3 * mdl.attn_flops(C, 1) * (3 + 1)


def test_bound_and_peaks():
    assert peaks_for("NVIDIA H100 80GB HBM3") is H100
    with pytest.raises(KeyError):
        peaks_for("cpu")
    assert bound_s(989e12, 0, H100) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12, H100) == pytest.approx(1.0)
    assert bound_s(989e12, 2 * 3.35e12, H100) == pytest.approx(2.0)
