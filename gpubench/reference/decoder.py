"""The plain reference decoder: fp32 PyTorch, TF32 off, no kernels, no
cache, no batching, written from the published layer equations
(Mistral and Mixtral: pre-norm RMSNorm, rope in the halves convention,
grouped-query causal attention, SwiGLU, an untied head).

It imports nothing of the program: it reads the benchmark's weights (a
dict of leaves in the port's layout, ``gpubench/harness/weights.py``)
and token ids, and works out everything else again: positions, rope
angles, masks and routing.

Routing follows the program, not the published model: softmax over the
experts in fp32, the ``top_k`` picks by repeated argmax (the first
maximum on ties), each pick weighted by its probability, NOT
renormalised over the picks (published Mixtral renormalises; listed under
``departures`` in ``configs/mixtral_8x7b.json``).

Under :func:`fp8_operands` the same equations serve as a cell's control:
one precision below the bf16 that the configurations state.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def exact_fp32():
    """Full fp32 matmuls on the card (TF32 would round the operands),
    the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


_FP8 = [False]


@contextlib.contextmanager
def fp8_operands():
    """The control's precision: each projection's two operands rounded to
    fp8 (e4m3, a scale per row of the activations and per output column
    of the weight, as an fp8 GEMM takes them) before an fp32 product.
    The router and the head stay in fp32."""
    _FP8[0] = True
    try:
        yield
    finally:
        _FP8[0] = False


def _e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection ``x [.., D_in] @ w [D_in, D_out]``."""
    if _FP8[0]:
        return _e4m3(x, -1) @ _e4m3(w, -2)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [S, heads, D]`` rotated by ``pos [S]``: pairs ``(i, i + D/2)``
    turned by ``pos * theta ** (-2i / D)``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(c: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              segs: Optional[torch.Tensor]) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: ``q [S, H, D]``,
    ``k, v [S, KVH, D]``; query head ``h`` reads KV head ``h // (H /
    KVH)``. ``segs [S]``: attend only inside the same segment."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    qh, kh, vh = q.transpose(0, 1), kk.transpose(0, 1), vv.transpose(0, 1)
    s = (qh @ kh.transpose(1, 2)) * (D ** -0.5)            # [H, S, S]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if segs is not None:
        keep = keep & (segs[:, None] == segs[None, :])
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ vh).transpose(0, 1).reshape(S, H * D)


def ffn(c: Dict, lp: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or the routed bank: each token's ``top_k`` experts by
    repeated argmax over its fp32 router probabilities, weighted by
    those probabilities."""
    E = c.get("moe_experts", 0)
    if not E:
        return mm(F.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_up"]), lp["w_down"])
    probs = torch.softmax(h @ lp["w_router"], dim=-1)               # [S, E]
    rest = probs.clone()
    out = torch.zeros_like(h)
    for _ in range(c["moe_top_k"]):
        pick = rest.argmax(-1)
        gate = rest.gather(-1, pick[:, None])[:, 0]
        rest = rest.scatter(-1, pick[:, None], -1.0)
        for e in range(E):
            rows = (pick == e).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            x = h[rows]
            y = mm(F.silu(mm(x, lp["w_gate"][e])) * mm(x, lp["w_up"][e]), lp["w_down"][e])
            out.index_add_(0, rows, y * gate[rows, None])
    return out


def layer(c: Dict, lp: Dict[str, torch.Tensor], x: torch.Tensor,
          pos: torch.Tensor, segs: Optional[torch.Tensor]) -> torch.Tensor:
    """One pre-norm decoder layer on ``x [S, D]``."""
    S = x.shape[0]
    H, KV = c["n_heads"], c["n_kv_heads"]
    hd = c["d_model"] // H
    eps, theta = c["norm_eps"], c["rope_theta"]
    h = rmsnorm(x, lp["attn_norm"], eps)
    q = rope(mm(h, lp["wq"]).reshape(S, H, hd), pos, theta)
    k = rope(mm(h, lp["wk"]).reshape(S, KV, hd), pos, theta)
    v = mm(h, lp["wv"]).reshape(S, KV, hd)
    x = x + mm(attention(c, q, k, v, segs), lp["wo"])
    return x + ffn(c, lp, rmsnorm(x, lp["mlp_norm"], eps))


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_router",
              "w_gate", "w_up", "w_down")


def layer_weights(w: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights upcast to fp32 (one layer at a time, so the
    reference fits beside the program's bf16 weights)."""
    return {k: w[k][i].float() for k in LAYER_KEYS if k in w}


@torch.no_grad()
def logits(c: Dict, w: Dict[str, torch.Tensor], seq: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``[S, V]`` at every position of one sequence."""
    x = w["embed"][seq].float()
    pos = torch.arange(seq.numel(), device=seq.device)
    for i in range(c["n_layers"]):
        x = layer(c, layer_weights(w, i), x, pos, None)
    return rmsnorm(x, w["final_norm"].float(), c["norm_eps"]) @ w["lm_head"].float()


@torch.no_grad()
def served_logits(c: Dict, w: Dict[str, torch.Tensor], seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int]) -> List[torch.Tensor]:
    """For each sequence (its prompt and then its served tokens), the
    logits ``[n, V]`` at the positions of its ``n`` served tokens; the
    last served token is not fed back. Layer by layer over every
    sequence, so that one layer's weights are upcast at a time."""
    xs, poss = [], []
    for s in seqs:
        inp = s[:-1]
        xs.append(w["embed"][inp].float())
        poss.append(torch.arange(inp.numel(), device=inp.device))
    for i in range(c["n_layers"]):
        lp = layer_weights(w, i)
        xs = [layer(c, lp, x, p, None) for x, p in zip(xs, poss)]
        del lp
    head = w["lm_head"].float()
    fnorm = w["final_norm"].float()
    return [rmsnorm(x[P - 1:], fnorm, c["norm_eps"]) @ head
            for x, P in zip(xs, prompt_lens)]


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The best logit at each position less the logit of ``tokens``."""
    return logits.max(-1).values - logits.gather(-1, tokens.long()[:, None])[:, 0]


def served_gaps(c: Dict, w: Dict[str, torch.Tensor],
                seqs: Sequence[torch.Tensor], prompt_lens: Sequence[int]) -> List[torch.Tensor]:
    """The gap at every served token: the reference's best logit at that
    position less the logit of the token served."""
    return [gaps(lg, s[P:]) for lg, s, P in
            zip(served_logits(c, w, seqs, prompt_lens), seqs, prompt_lens)]


def row_loss(c: Dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
             segs: torch.Tensor, denom: float) -> torch.Tensor:
    """One packed row's share of the batch's next-token loss: the sum of
    its NLL over targets inside a document, over the whole batch's count
    ``denom``. Positions restart at 0 in every document. Each layer runs
    under a checkpoint, so one row's fp32 activations fit."""
    inp, tgt = tokens[:-1], tokens[1:]
    s_in = segs[:-1]
    idx = torch.arange(s_in.numel(), device=tokens.device)
    start = torch.ones_like(s_in, dtype=torch.bool)
    start[1:] = s_in[1:] != s_in[:-1]
    pos = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    x = w["embed"][inp]
    for i in range(c["n_layers"]):
        lp = {k: w[k][i] for k in LAYER_KEYS if k in w}
        x = checkpoint(layer, c, lp, x, pos, s_in, use_reentrant=False)
    h = rmsnorm(x, w["final_norm"], c["norm_eps"])
    logp = torch.log_softmax(h @ w["lm_head"], -1)
    nll = -logp.gather(-1, tgt[:, None].long())[:, 0]
    valid = (segs[1:] == segs[:-1]) & (segs[1:] != 0)
    return (nll * valid).sum() / denom


def adamw_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
           t: int, opt: Dict) -> None:
    """One decoupled AdamW update in place (Loshchilov and Hutter): decay
    by ``lr * wd``, then the bias-corrected moment step."""
    b1, b2, lr = opt["b1"], opt["b2"], opt["lr"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    p.mul_(1 - lr * opt["weight_decay"])
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    p.sub_(lr * mhat / (vhat.sqrt() + opt["eps"]))


def train_steps(c: Dict, w: Dict[str, torch.Tensor],
                batches: Callable[[int], Dict[str, torch.Tensor]], steps: int,
                opt: Dict,
                first_grad: Optional[Callable[[str, torch.Tensor], None]] = None) -> Dict:
    """``steps`` AdamW steps from the fp32 weights ``w`` (updated in
    place) on ``batches(k)``, a row at a time. Returns each step's loss
    and every leaf's first gradient norm; ``first_grad(leaf, grad)``, if
    given, sees each leaf's first gradient."""
    leaves = {k: t.requires_grad_(True) for k, t in w.items()}
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    losses, grad_norms = [], {}
    for t in range(1, steps + 1):
        b = batches(t - 1)
        tok, seg = b["tokens"], b["segment_ids"]
        denom = float(((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)).sum())
        total = 0.0
        for r in range(tok.shape[0]):
            loss = row_loss(c, leaves, tok[r], seg[r], denom)
            loss.backward()             # each leaf's .grad sums the rows
            total += float(loss.detach())
        losses.append(total)
        if t == 1:
            grad_norms = {k: float(p.grad.norm()) for k, p in leaves.items()}
            if first_grad is not None:
                for k, p in leaves.items():
                    first_grad(k, p.grad)
        with torch.no_grad():
            for k, p in leaves.items():
                adamw_(p, p.grad, m[k], v[k], t, opt)
                p.grad = None
    for p in leaves.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms}
