"""The plain reference against the port at tiny sizes on the CPU, in
fp32: the serving forward (dense, and routed as the port routes), the
training loss and gradients, and AdamW's steps."""

import numpy as np
import pytest
import torch

from gpubench.harness import traffic as tr
from gpubench.harness import weights as wts
from gpubench.reference import decoder as ref
from gpubench.tests.helpers import TINY, TINY_MOE

torch.set_num_threads(2)
PORT = dict(TINY, max_seq=128, rope_theta=10000.0, norm_eps=1e-5)
PORT_MOE = dict(TINY_MOE, max_seq=128, rope_theta=10000.0, norm_eps=1e-5)


def _cfg(port, **kw):
    from kubeflow_controller_tpu_torch.models.transformer import TransformerConfig

    extra = {}
    if port.get("moe_experts"):
        # capacity for every token: the serving paths' routing, no drops
        extra = {"moe_capacity_factor": port["moe_experts"] / port["moe_top_k"]}
    return TransformerConfig(**port, dtype=torch.float32, remat=False, **extra, **kw)


@pytest.mark.parametrize("port", [PORT, PORT_MOE], ids=["dense", "moe"])
def test_reference_logits_match_the_port(port):
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    tree = wts.make(port, 11, "cpu", torch.float32)
    seq = torch.from_numpy(np.random.default_rng(0).integers(0, 256, 40))
    got = tfm.forward(_cfg(port), tree, seq[None])[0]
    want = ref.logits(port, wts.flat(tree), seq)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("port", [PORT, PORT_MOE], ids=["dense", "moe"])
def test_served_gaps_are_zero_on_the_references_own_tokens(port):
    w = wts.flat(wts.make(port, 5, "cpu", torch.float32))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 12))
    seq = prompt
    for _ in range(6):                                    # greedy by the reference
        seq = torch.cat([seq, ref.logits(port, w, seq)[-1].argmax()[None]])
    (g,) = ref.served_gaps(port, w, [seq], [12])
    assert g.shape == (6,) and float(g.max()) == 0.0
    bad = seq.clone()
    bad[14] = (bad[14] + 1) % 256
    (g2,) = ref.served_gaps(port, w, [bad], [12])
    assert float(g2[2]) > 0


def test_reference_loss_and_gradients_match_the_port():
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    tree = wts.make(PORT, 3, "cpu", torch.float32)
    segs = torch.from_numpy(tr.packed_layout({"doc": {"dist": "lognormal", "median": 12,
                                                      "sigma": 1.0, "min": 4, "max": 32}},
                                             2, 32, 3))
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 33)))
    leaves = list(wts.flat(tree).values())
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tfm.next_token_loss(_cfg(PORT), tree, {"tokens": tok, "segment_ids": segs})
    g_port = torch.autograd.grad(loss, leaves)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in wts.flat(tree).items()}
    denom = float(((segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] != 0)).sum())
    ref_loss = sum(ref.row_loss(PORT, w, tok[r], segs[r], denom) for r in range(2))
    g_ref = torch.autograd.grad(ref_loss, list(w.values()))
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for a, b in zip(g_port, g_ref):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4)


def test_reference_adamw_matches_torch():
    p = torch.randn(5, 7)
    g = torch.randn(5, 7)
    opt = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
    q = p.clone().requires_grad_(True)
    torch_opt = torch.optim.AdamW([q], lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                                  weight_decay=0.1)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for t in (1, 2, 3):
        q.grad = g * t
        torch_opt.step()
        ref.adamw_(p, g * t, m, v, t, opt)
    assert torch.allclose(p, q.detach(), atol=1e-7)
