"""Continuous-batching LM decode engine over the paged KV pool, on one GPU.

Counterpart of ``kubeflow_controller_tpu/dataplane/serving_engine.py``:

* KV lives in one shared block pool (:class:`~..models.generate.
  PagedKVCache`); each of the ``n_slots`` lanes reads and writes it
  through its row of a host-owned block table, pushed to the device
  before every dispatch that could read it;
* a FIFO request queue; admission reserves the request's whole
  ``ceil((prompt + max_new) / block_size)`` page span up front, so no
  slot can run out of pages mid-decode;
* ``prefill_mode="exact"`` (the default) prefills a request's whole
  prompt at admission in one forward (``generate.prefill_into_paged``)
  and the slot decodes from the next step; ``"bucketed"`` decomposes
  every prefill on the absolute ``block_size`` grid into full-block
  chunks plus a power-of-two padded tail, one chunk per slot per step,
  interleaved with decode (Sarathi-style);
* every step dispatches one fused chunk of ``decode_chunk`` micro-steps
  (argmax of the carried logits -> one decode step -> retirement), and
  retirement is decided ON THE DEVICE: the chunk flips a row's
  ``active`` bit the micro-step it emits EOS or spends its budget, so no
  host round trip sits between a sequence finishing and its row going
  dead;
* the host loop is pipelined one dispatch deep: ``step()`` dispatches
  the next chunk first, then books the previous chunk's tokens (copied
  to pinned host memory behind that chunk on the stream) while the
  device works;
* ``spec_decode=True``: model-free drafts (``dataplane/spec_decode.py``)
  verified in one forward over the pages (``generate.verify_step_paged``)
  on the quanta where some slot drafts; the plain pipelined chunk
  otherwise. Greedy streams are those of plain decode;
* per-request sampling (``Request.params``, or the engine's defaults):
  each draw is keyed by ``fold_in(fold_in(PRNGKey(seed), gen), pos)``
  (``dataplane/sampling.py``), so a sampled stream is a function of the
  request alone — not of the batch, the slot, the admission order or
  the kind of quantum that emitted a token. A batch with a sampled row
  runs the sampled twin of the chunk (and of the verify step); an
  all-greedy batch runs the greedy one;
* ``logit_mask`` (grammars): while a decoding slot carries a mask, each
  quantum is ONE masked micro-step booked at once, so the host advances
  the slot's automaton between draws;
* ``n > 1``: the prompt is prefilled once and forked copy-on-write into
  generations 1..n-1, which read the prompt's full pages by refcount and
  copy only the partial boundary page.

Everything else the JAX engine offers raises "not yet ported" when
asked for: the prefix cache, the radix proposer, the host tier, tensor
parallelism, disaggregation, fault injection and the tracer.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_controller_tpu_torch.dataplane import kv_blocks
from kubeflow_controller_tpu_torch.dataplane import spec_decode as spec_mod
from kubeflow_controller_tpu_torch.dataplane.metrics import (
    MetricsLogger, ServingStats,
)
from kubeflow_controller_tpu_torch.dataplane.sampling import (
    LogitMask, SamplingParams,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models import generate as gen
from kubeflow_controller_tpu_torch.models.transformer import (
    Params, TransformerConfig,
)
from kubeflow_controller_tpu_torch.obs.telemetry import registry


def not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to the PyTorch engine (see ROADMAP.md)")


class Rejected(Exception):
    """Typed admission-control rejection from :meth:`ServingEngine.submit`:
    ``reason`` is ``"queue_full"`` or ``"draining"``."""

    def __init__(self, rid: int, reason: str):
        self.rid = rid
        self.reason = reason
        super().__init__(f"request {rid} rejected: {reason}")


class DrainError(RuntimeError):
    """``run()`` failed to drain within its step budget; the completions
    that did finish ride along on ``.completions``."""

    def __init__(self, msg: str, completions: List["Completion"]):
        super().__init__(msg)
        self.completions = completions


@dataclass
class Request:
    """One generation request: ``prompt`` is a 1-D int token-id array.
    ``deadline_s`` is a latency budget in seconds from submission."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    params: Optional[SamplingParams] = None
    prefill_only: bool = False


@dataclass
class Completion:
    rid: int
    tokens: List[int]                 # includes the EOS token if emitted
    finish_reason: str                # eos | length | deadline | shed | cancelled
    submit_t: float
    first_token_t: Optional[float]    # None when retired before any token
    done_t: float
    admit_t: Optional[float] = None   # None when shed in the queue
    gen: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def queue_wait_s(self) -> float:
        return (self.admit_t if self.admit_t is not None
                else self.done_t) - self.submit_t

    @property
    def tpot_s(self) -> float:
        n = len(self.tokens)
        if n <= 1 or self.first_token_t is None:
            return 0.0
        return (self.done_t - self.first_token_t) / (n - 1)


@dataclass
class _Queued:
    req: Request
    submit_t: float
    deadline_t: Optional[float]


@dataclass
class _Prefill:
    """Chunked-prefill progress of a slot still mid-admission: the next
    chunk starts at absolute position ``next_off``."""

    tokens: np.ndarray
    next_off: int
    eos_val: int
    budget_val: int


@dataclass
class _Slot:
    """Host bookkeeping for one live slot (device truth lives in the
    slot's table row and length/active entries)."""

    req: Request
    submit_t: float
    admit_t: float
    deadline_t: Optional[float] = None
    cancelled: bool = False
    first_token_t: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    owned: List[int] = field(default_factory=list)   # pool pages held
    # Pool pages this slot reads but does not own: a fork's shared prompt
    # pages, refcounted in the pool at fork time and released on every
    # retirement path (_free_shared).
    shared: List[int] = field(default_factory=list)
    prefill: Optional[_Prefill] = None   # set while mid-chunked-prefill
    # Speculative decoding: the next committed token (argmax of the
    # carried logits, fetched with the step that computed it; None until
    # the slot's first booked step), the adaptive draft length, and the
    # consecutive fruitless rounds and full accepts that drive backoff.
    next_tok: Optional[int] = None
    spec_k: int = 0
    spec_miss: int = 0
    spec_hits: int = 0
    # The generation's sampling contract (the request's params or the
    # engine's defaults) and its index (0 for the parent, 1..n-1 for
    # forks); the grammar mask and its automaton state, advanced a
    # booked token at a time.
    sp: SamplingParams = field(default_factory=SamplingParams)
    gen_idx: int = 0
    mask: Optional[LogitMask] = None
    mask_state: object = None


@dataclass
class _ForkSource:
    """A prefilled ``n > 1`` parent awaiting its forks 1..n-1: its table
    row, prefill-final logits row and the page holds each pending child
    already took (taken at capture, so the parent's retirement can never
    free a page a deferred child still needs). Children take slots as
    they free; cancel, deadline and drain release the holds."""

    req: Request
    sp: SamplingParams
    submit_t: float
    admit_t: float
    deadline_t: Optional[float]
    gens_left: List[int]              # generation indices not yet placed
    table: np.ndarray                 # the parent's table row (host copy)
    needed: int                       # pages spanned by prompt + budget
    prompt_len: int
    logits_row: torch.Tensor          # [vocab] parent logits at prefill end
    shared: List[int]                 # the prompt's full page ids
    boundary_bid: Optional[int]       # the partial last prompt page


class _Fetch:
    """A device tensor's copy to the host, started behind the work that
    produced it: on a GPU into pinned memory with an event recorded
    after it, so reading it later waits for that work only, not for
    dispatches enqueued since."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without stopping the host: a pinned
    staging copy on the GPU (the caching host allocator keeps it alive
    until the copy lands), a private copy on the CPU (the host keeps
    mutating its arrays)."""
    t = torch.from_numpy(np.array(a, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ServingEngine:
    """Continuous-batching decode over a fixed slot pool.

    Drive it with :meth:`run` (submit everything, drain) or manually —
    :meth:`submit` + :meth:`step`. ``params`` must already live on
    ``device`` (``cuda`` unless ``device="cpu"`` is passed)."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Params,
        n_slots: int = 8,
        max_seq: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        decode_chunk: int = 4,
        max_queue: Optional[int] = None,
        max_queue_delay_s: Optional[float] = None,
        prefill_mode: str = "exact",
        prefix_cache: bool = False,
        block_size: int = 16,
        kv_pool_blocks: Optional[int] = None,
        kv_hbm_budget_mb: Optional[float] = None,
        kv_quant: str = "",
        metrics_path: Optional[str] = None,
        spec_decode: bool = False,
        draft_k: int = 4,
        proposer: object = "prompt",
        spec_patience: int = 2,
        spec_cooldown_max: int = 256,
        tp: int = 1,
        attn_impl: str = "kernel",
        host_kv_mb: float = 0.0,
        tracer=None,
        injector=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._default_params = SamplingParams(
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed))
        self._default_params.validate()
        if prefill_mode not in ("exact", "bucketed"):
            raise ValueError(
                f"prefill_mode must be 'exact' or 'bucketed' "
                f"(got {prefill_mode!r})")
        if prefix_cache and prefill_mode != "bucketed":
            raise ValueError(
                "prefix_cache requires prefill_mode='bucketed' (exact-"
                "length prefill does not land on the block grid)")
        refused = [
            (prefix_cache, "prefix_cache"),
            (host_kv_mb > 0, "the host KV tier (host_kv_mb)"),
            (int(tp) > 1, "tensor-parallel serving (tp > 1)"),
            (tracer is not None, "the lifecycle tracer"),
            (injector is not None, "fault injection"),
        ]
        for asked, what in refused:
            if asked:
                raise not_yet_ported(what)
        if block_size < 1 or (block_size & (block_size - 1)) != 0:
            raise ValueError(
                f"block_size must be a power of two >= 1 (got {block_size})")
        attn_impl = gen.check_attn_impl(attn_impl)
        if kv_quant in (None, "none"):
            kv_quant = ""
        if kv_quant not in ("", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8' (got {kv_quant!r})")
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(
                f"params live on {embed.device}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = int(max_seq or cfg.max_seq)
        if prefill_mode == "bucketed":
            # A slot's KV is exactly its table span, so max_seq rounds UP
            # to the block grid.
            self.max_seq = -(-self.max_seq // block_size) * block_size
        else:
            # Exact prefill never exposes the grid, but the pool needs
            # one: shrink to the largest power-of-two divisor of max_seq,
            # so that the table span lands exactly on max_seq.
            while block_size > self.max_seq or self.max_seq % block_size:
                block_size //= 2
        self.prefill_mode = prefill_mode
        self.decode_chunk = max(1, int(decode_chunk))
        self.max_queue = max_queue
        self.max_queue_delay_s = max_queue_delay_s
        self.block_size = int(block_size)
        self._max_blocks = self.max_seq // self.block_size
        self.kv_quant = kv_quant
        self.attn_impl = attn_impl
        # Pool sizing: explicit page count > memory budget > one full
        # context per slot.
        if kv_pool_blocks is None:
            if kv_hbm_budget_mb is not None:
                kv_pool_blocks = kv_blocks.blocks_for_budget(
                    cfg, self.block_size, int(kv_hbm_budget_mb * (1 << 20)),
                    kv_quant)
            else:
                kv_pool_blocks = n_slots * self._max_blocks
        self._kv_pool_blocks = int(kv_pool_blocks)
        self.pool = kv_blocks.BlockPool(self._kv_pool_blocks)
        self._clock = clock
        self._metrics = MetricsLogger(metrics_path) if metrics_path else None
        # Speculative decoding. Cooldown (steps before a lane may propose
        # again) and backoff (the last cooldown, doubled on every relapse
        # up to spec_cooldown_max) are kept per LANE, not per request:
        # "this traffic does not speculate" outlives any one request.
        self.spec_decode = bool(spec_decode)
        self.draft_k = int(draft_k)
        self.spec_patience = max(1, int(spec_patience))
        self.spec_cooldown_max = max(1, int(spec_cooldown_max))
        self._spec_cooldown = [0] * n_slots
        self._spec_backoff = [0] * n_slots
        self._proposer: Optional[spec_mod.DraftProposer] = None
        if self.spec_decode:
            if self.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1 (got {draft_k})")
            if isinstance(proposer, str):
                self._proposer = spec_mod.make_proposer(proposer)
            elif isinstance(proposer, spec_mod.DraftProposer):
                self._proposer = proposer
            else:
                raise ValueError(
                    f"proposer must be 'prompt', 'radix', or a "
                    f"DraftProposer (got {proposer!r})")

        self.cache = gen.init_paged_cache(
            cfg, n_slots, self._max_blocks, self._kv_pool_blocks,
            self.block_size, kv_quant, device=self.device)
        # Host-owned block tables, the scheduler's source of truth; the
        # sentinel (== n_blocks) marks unallocated entries.
        self._tables = np.full(
            (n_slots, self._max_blocks), self._kv_pool_blocks, np.int32)
        self._tables_dirty = False
        # Per-slot reserved page span (0 = free): its max, rounded up to
        # a power of two, is the width the next dispatch attends.
        self._slot_blocks = np.zeros(n_slots, np.int64)
        dev = self.device
        self.logits = torch.zeros((n_slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        # The retirement rule, kept on the device so the fused chunk can
        # flip `active` itself: eos id (-1 = none), token budget, tokens
        # emitted so far.
        self.eos = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
        self.budget = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.emitted = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        # Per-slot sampling lanes, host-owned and mirrored to the device
        # (_push_sampling) before a sampled dispatch: temperature, top-k,
        # top-p, seed, generation index. Greedy rows carry temperature 0
        # and take the argmax inside the sampled functions.
        self._temp_h = np.zeros(n_slots, np.float32)
        self._topk_h = np.zeros(n_slots, np.int32)
        self._topp_h = np.ones(n_slots, np.float32)
        self._seed_h = np.zeros(n_slots, np.int32)
        self._gen_h = np.zeros(n_slots, np.int32)
        self._samp_d: Optional[Tuple[torch.Tensor, ...]] = None
        self._gen_key_d: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # Prefilled n > 1 parents awaiting forks, and the generations
        # each such rid still owes a Completion (the rid stays reserved
        # until its last generation finishes).
        self._fork_sources: List[_ForkSource] = []
        self._rid_gens: Dict[int, int] = {}
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.queue: deque = deque()
        self.stats = ServingStats(n_slots=n_slots)
        # One-deep dispatch pipeline: (token fetch, slot snapshot).
        self._pending: Optional[Tuple[_Fetch, List[Optional[_Slot]]]] = None
        self._rids: set = set()
        self._done_buf: List[Completion] = []
        self._draining = False

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request. Raises ``ValueError`` on malformed input,
        :class:`Rejected` on admission control, and
        ``NotImplementedError`` for what this port does not serve yet."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.params is not None:
            req.params.validate()
            if req.params.max_tokens is not None:
                req.max_new_tokens = int(req.params.max_tokens)
            if req.params.logit_mask is not None:
                mv = getattr(req.params.logit_mask, "vocab_size", None)
                if mv is not None and mv != self.cfg.vocab_size:
                    raise ValueError(
                        f"request {req.rid}: logit_mask vocab "
                        f"{mv} != model vocab {self.cfg.vocab_size}")
        if req.prefill_only:
            raise not_yet_ported("prefill/decode disaggregation (prefill_only)")
        if prompt.size + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {prompt.size} + "
                f"{req.max_new_tokens} new exceeds max_seq {self.max_seq}")
        needed = self._blocks_needed(prompt.size, req.max_new_tokens)
        if needed > self._kv_pool_blocks:
            raise ValueError(
                f"request {req.rid}: needs {needed} pool pages, pool "
                f"holds {self._kv_pool_blocks} (raise kv_pool_blocks / "
                f"kv_hbm_budget_mb, or shrink the request)")
        if req.rid in self._rids:
            raise ValueError(f"request {req.rid}: duplicate rid "
                             "among queued/in-flight requests")
        if self._draining:
            self.stats.rejected += 1
            raise Rejected(req.rid, "draining")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats.rejected += 1
            raise Rejected(req.rid, "queue_full")
        req.prompt = prompt
        now = self._clock()
        deadline_t = None if req.deadline_s is None else now + req.deadline_s
        self.queue.append(_Queued(req=req, submit_t=now, deadline_t=deadline_t))
        self._rids.add(req.rid)
        if req.params is not None and req.params.n > 1:
            self._rid_gens[req.rid] = req.params.n
        self.stats.submitted += 1
        self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                         len(self.queue))

    def cancel(self, rid: int) -> bool:
        """Cancel a request by rid. A queued request is removed outright
        (a Completion with no tokens at the next :meth:`step`); an
        in-flight one retires at the next step with the tokens decoded
        so far — every generation of an ``n > 1`` request, and the forks
        not placed yet, whose page holds come back. Returns False for an
        unknown rid (finished, or never submitted)."""
        if rid not in self._rids:
            return False
        for q in self.queue:
            if q.req.rid == rid:
                self.queue.remove(q)
                self._rids.discard(rid)
                self._rid_gens.pop(rid, None)
                self._finish_completion(Completion(
                    rid=rid, tokens=[], finish_reason="cancelled",
                    submit_t=q.submit_t, first_token_t=None,
                    done_t=self._clock()))
                return True
        found = False
        for slot in self.slots:
            if slot is not None and slot.req.rid == rid:
                slot.cancelled = True
                found = True
        for src in list(self._fork_sources):
            if src.req.rid == rid:
                self._cancel_fork_source(src, "cancelled")
                self._fork_sources.remove(src)
                found = True
        return found

    def _finish_completion(self, comp: Completion) -> None:
        """Record a completion made outside a step's booking (a shed) and
        buffer it for the next step()'s return."""
        self.stats.record(comp)
        self._done_buf.append(comp)

    # -- block-table plumbing ----------------------------------------------

    def _push_tables(self) -> None:
        """Mirror the host block tables to the device cache; a no-op
        while clean."""
        if not self._tables_dirty:
            return
        self.cache.tables = _to_device(self._tables, self.device)
        self._tables_dirty = False

    def _view_width(self) -> int:
        """Columns the next dispatch attends: the max page span any live
        slot has RESERVED, rounded up to a power of two on the block grid
        and capped at the table span. It fixes how many pages the kernels
        walk, and so their reduction order."""
        mb = int(self._slot_blocks.max()) if self.n_slots else 1
        nb = 1
        while nb < mb:
            nb *= 2
        nb = max(1, min(nb, self._max_blocks))
        return nb * self.block_size

    def _blocks_needed(self, prompt_size: int, max_new: int) -> int:
        return -(-(prompt_size + max_new) // self.block_size)

    def _reserve_blocks(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pool pages, or None (every page unwound) when
        the free list cannot cover them."""
        owned: List[int] = []
        while len(owned) < n:
            bid = self.pool.alloc()
            if bid is None:
                for b in owned:
                    self.pool.unref(b)
                return None
            owned.append(bid)
        return owned

    def _free_owned(self, slot: _Slot) -> None:
        for bid in slot.owned:
            self.pool.unref(bid)
        slot.owned = []

    def _free_shared(self, slot: _Slot) -> None:
        """Drop the slot's fork-shared page holds. Called on every
        retirement path, like :meth:`_free_owned`, so sharing is
        leak-free under eos, length, deadline, cancel and drain alike."""
        for bid in slot.shared:
            self.pool.unref(bid, owner=("fork", slot.req.rid, slot.gen_idx))
        slot.shared = []

    def _rid_done(self, rid: int) -> None:
        """One generation of ``rid`` finished; the rid stays reserved
        (the duplicate-rid guard) until all ``n`` have."""
        left = self._rid_gens.get(rid)
        if left is None:
            self._rids.discard(rid)
        elif left <= 1:
            self._rid_gens.pop(rid, None)
            self._rids.discard(rid)
        else:
            self._rid_gens[rid] = left - 1

    # -- per-slot sampling lanes -----------------------------------------------

    def _set_slot_sampling(self, i: int, sp: SamplingParams,
                           gen_idx: int = 0) -> None:
        """Program slot ``i``'s sampling lane (admission and fork)."""
        self._temp_h[i] = sp.temperature
        self._topk_h[i] = sp.top_k
        self._topp_h[i] = sp.top_p
        self._seed_h[i] = sp.seed
        self._gen_h[i] = gen_idx
        self._samp_d = None

    def _push_sampling(self) -> Tuple[torch.Tensor, ...]:
        """The lanes on the device ``(temperature, top_k, top_p, seed,
        gen)``, pushed again only after a lane changed; with them each
        lane's generation key ``fold_in(PRNGKey(seed), gen)``
        (``self._gen_key_d``), hashed on the host: on the device it would
        be a threefry of ~170 launches on eight words every chunk."""
        if self._samp_d is None:
            self._samp_d = tuple(
                _to_device(a, self.device) for a in (
                    self._temp_h, self._topk_h, self._topp_h,
                    self._seed_h, self._gen_h))
            k0, k1 = gen.generation_keys(torch.from_numpy(self._seed_h),
                                         torch.from_numpy(self._gen_h))
            self._gen_key_d = (_to_device(k0.numpy(), self.device),
                               _to_device(k1.numpy(), self.device))
        return self._samp_d

    def _sampled_in(self, snapshot) -> int:
        """Decoding rows that need the sampled functions."""
        return sum(1 for s in snapshot
                   if s is not None and not s.sp.is_greedy)

    def _masked_decoding(self) -> bool:
        """True while a DECODING slot carries a grammar mask: such quanta
        run one synchronous micro-step, so the automaton advances a token
        at a time (mid-prefill masked slots do not count yet)."""
        return any(s is not None and s.prefill is None
                   and s.mask is not None for s in self.slots)

    def _clear_table_row(self, i: int) -> None:
        """Reset slot ``i``'s host table row to the sentinel. The stale
        device row persists until the next push, which is safe: its
        ``active`` bit is already clear and inactive rows write
        nothing."""
        self._tables[i] = self._kv_pool_blocks
        self._slot_blocks[i] = 0
        self._tables_dirty = True

    def _retire_slot(self, i: int, slot: _Slot, reason: str,
                     now: float) -> Completion:
        """Host-side policy retirement of an in-flight slot: emit the
        partial completion, return its pages, clear its table row and
        its device row's ``active`` bit. The pending chunk's tokens for
        this row are dropped by the snapshot-identity check in
        :meth:`_process_pending`."""
        self._free_owned(slot)
        self._free_shared(slot)
        self._clear_table_row(i)
        comp = Completion(
            rid=slot.req.rid, tokens=slot.tokens, finish_reason=reason,
            submit_t=slot.submit_t, first_token_t=slot.first_token_t,
            done_t=now, admit_t=slot.admit_t, gen=slot.gen_idx)
        self.slots[i] = None
        self._rid_done(slot.req.rid)
        self.cache.active[i] = False
        self.stats.record(comp)
        return comp

    def _retire_due(self) -> List[Completion]:
        """Retire in-flight slots that were cancelled or whose deadline
        passed, before the next dispatch."""
        out: List[Completion] = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.cancelled:
                out.append(self._retire_slot(i, slot, "cancelled",
                                             self._clock()))
            elif (slot.deadline_t is not None
                  and self._clock() >= slot.deadline_t):
                out.append(self._retire_slot(i, slot, "deadline",
                                             self._clock()))
        return out

    # -- scheduling ----------------------------------------------------------

    def _decode_chunk(self, vw: int):
        """``decode_chunk`` fused micro-steps over the pool: sample the
        carried logits' argmax (first maximum on ties), decode it, and
        retire rows on the device. Returns the ``[chunk, n_slots]``
        tokens — with speculative decoding one row more, each slot's
        next committed token (the carried logits' argmax) for the
        proposer; the logits, cache and emitted counts advance in place
        of the engine's."""
        logits, cache, emitted = self.logits, self.cache, self.emitted
        toks_out = []
        for _ in range(self.decode_chunk):
            toks = logits.argmax(-1).to(torch.int32)
            was_active = cache.active
            logits, cache = gen.decode_step_paged(
                self.cfg, self.params, toks[:, None], cache, view_width=vw,
                attn_impl=self.attn_impl)
            # This token IS decoded (the stream includes EOS); the row
            # then goes inactive for every later micro-step. Its later
            # chunk tokens are garbage the host discards by the same rule.
            emitted = torch.where(was_active, emitted + 1, emitted)
            done = was_active & ((toks == self.eos) | (emitted >= self.budget))
            cache.active = cache.active & ~done
            toks_out.append(toks)
        self.logits, self.cache, self.emitted = logits, cache, emitted
        if self.spec_decode:
            toks_out.append(logits.argmax(-1).to(torch.int32))
        return torch.stack(toks_out)

    def _decode_chunk_sampled(self, vw: int):
        """The sampled twin of :meth:`_decode_chunk`: each micro-step
        draws through ``generate.sample_with_noise`` (per-row filters;
        greedy rows take the argmax, the greedy chunk's bits) under the
        key of (seed, gen, emitted). A row live at micro-step j was live
        at every earlier one, so its position there is ``emitted + j``,
        and one call draws the Gumbel noise of the whole chunk; a row
        that retired mid-chunk draws garbage the host discards. With
        speculative decoding the extra row is the sampled peek at the
        carried position: the first token the next quantum would draw,
        which the proposer drafts from."""
        temp, top_k, top_p, _, _ = self._push_sampling()
        logits, cache, emitted = self.logits, self.cache, self.emitted
        n_draws = self.decode_chunk + (1 if self.spec_decode else 0)
        steps = torch.arange(n_draws, dtype=torch.int32, device=self.device)
        noise = gen.sampling_noise(self._gen_key_d,
                                   emitted[None] + steps[:, None],
                                   self.cfg.vocab_size)   # [n, B, V]
        toks_out = []
        for j in range(self.decode_chunk):
            toks = gen.sample_with_noise(logits, temp, top_k, top_p, noise[j])
            was_active = cache.active
            logits, cache = gen.decode_step_paged(
                self.cfg, self.params, toks[:, None], cache, view_width=vw,
                attn_impl=self.attn_impl)
            emitted = torch.where(was_active, emitted + 1, emitted)
            done = was_active & ((toks == self.eos) | (emitted >= self.budget))
            cache.active = cache.active & ~done
            toks_out.append(toks)
        self.logits, self.cache, self.emitted = logits, cache, emitted
        if self.spec_decode:
            toks_out.append(gen.sample_with_noise(
                logits, temp, top_k, top_p, noise[self.decode_chunk]))
        return torch.stack(toks_out)

    def _masked_step(self, vw: int, mask: np.ndarray, sampled: bool):
        """ONE constrained micro-step: draw each row's token under its
        ``[n_slots, vocab]`` admissibility row (all True on unmasked rows,
        which changes nothing), decode it and retire rows on the device.
        Returns the ``[n_slots]`` tokens. Without a sampled row the draw
        is the masked argmax, the greedy rows' bits either way."""
        mask_d = _to_device(mask, self.device)
        if sampled:
            temp, top_k, top_p, _, _ = self._push_sampling()
            noise = gen.sampling_noise(self._gen_key_d, self.emitted,
                                       self.cfg.vocab_size)
            toks = gen.sample_with_noise(self.logits, temp, top_k, top_p,
                                         noise, mask=mask_d)
        else:
            toks = torch.where(
                mask_d, self.logits,
                torch.tensor(float("-inf"), device=self.device)
            ).argmax(-1).to(torch.int32)
        was_active = self.cache.active
        self.logits, self.cache = gen.decode_step_paged(
            self.cfg, self.params, toks[:, None], self.cache, view_width=vw,
            attn_impl=self.attn_impl)
        self.emitted = torch.where(was_active, self.emitted + 1, self.emitted)
        done = was_active & ((toks == self.eos) | (self.emitted >= self.budget))
        self.cache.active = self.cache.active & ~done
        return toks

    def _verify(self, vw: int, draft: np.ndarray, dlen: np.ndarray,
                sampled: bool = False):
        """One fused verify step over the pool: commit each row's accepted
        run, then apply the plain chunk's retirement rule on the device —
        an EOS inside the committed run, or the budget spent (``max_commit
        = budget - emitted`` caps the run, so a row retires at exactly
        its budget). ``sampled`` runs ``generate.verify_step_paged_sampled``
        (the batch has a sampled row): acceptance by the speculative
        sampling rule, and the next token is the sampled peek. Returns
        ``[n_slots, K + 3]`` int32: the window, the committed count n and
        the next committed token."""
        max_commit = (self.budget - self.emitted).clamp_min(1)
        draft_d = _to_device(draft, self.device)
        dlen_d = _to_device(dlen, self.device)
        if sampled:
            window, n, next_tok, self.logits, self.cache = \
                gen.verify_step_paged_sampled(
                    self.cfg, self.params, draft_d, dlen_d, self.logits,
                    self.cache, self.eos, max_commit, *self._push_sampling(),
                    self.emitted, view_width=vw, attn_impl=self.attn_impl)
        else:
            window, n, self.logits, self.cache = gen.verify_step_paged(
                self.cfg, self.params, draft_d, dlen_d, self.logits,
                self.cache, self.eos, max_commit, view_width=vw,
                attn_impl=self.attn_impl)
            next_tok = None
        self.emitted = self.emitted + n              # n = 0 on inactive rows
        in_commit = (torch.arange(window.shape[1], device=self.device)[None, :]
                     < n[:, None])
        committed_eos = ((window == self.eos[:, None])
                         & (self.eos[:, None] >= 0) & in_commit).any(1)
        active = self.cache.active
        done = active & (committed_eos | (self.emitted >= self.budget))
        self.cache.active = active & ~done
        if next_tok is None:
            next_tok = self.logits.argmax(-1).to(torch.int32)
        return torch.cat([window, n[:, None], next_tok[:, None]], 1)

    def _chunk(self, i: int, toks: np.ndarray, off: int, w_real: int,
               p: _Prefill, activate: bool) -> None:
        """One prefill chunk into slot ``i`` at the current view width
        (which covers the slot's reserved span: reservation precedes the
        first chunk): installs the chunk's logits row and the slot's
        retirement rule, and flips the row live on the final chunk."""
        vw = self._view_width()
        row_logits, self.cache = gen.prefill_chunk_paged(
            self.cfg, self.params, _to_device(toks, self.device),
            self.cache, i, off, w_real, view_width=vw,
            attn_impl=self.attn_impl)
        self.logits[i] = row_logits[0]
        self.eos[i] = p.eos_val
        self.budget[i] = p.budget_val
        self.emitted[i] = 0
        self.cache.active[i] = activate

    def _shed_queued(self) -> None:
        """Shed queued requests past their deadline or queue-wait cap
        before they take a slot."""
        if not self.queue:
            return
        if self.max_queue_delay_s is None and all(
                q.deadline_t is None for q in self.queue):
            return
        now = self._clock()
        keep: deque = deque()
        for q in self.queue:
            expired = q.deadline_t is not None and now >= q.deadline_t
            delayed = (self.max_queue_delay_s is not None
                       and now - q.submit_t >= self.max_queue_delay_s)
            if expired or delayed:
                self._rids.discard(q.req.rid)
                self._rid_gens.pop(q.req.rid, None)
                self._finish_completion(Completion(
                    rid=q.req.rid, tokens=[], finish_reason="shed",
                    submit_t=q.submit_t, first_token_t=None, done_t=now))
            else:
                keep.append(q)
        self.queue = keep

    def _admit_waiting(self) -> None:
        """Fill every free slot from the queue: reserve the request's
        whole page span and write the page ids into the slot's table
        row; then, in exact mode, prefill the prompt into the slot and
        make it live, or, bucketed, leave a :class:`_Prefill` cursor that
        :meth:`_advance_prefills` runs one chunk per step. A request
        whose reservation cannot be met goes back to the queue head and
        admission stops for this step. Pending forks take free slots
        first: they extend work already prefilled, and their page holds
        are live."""
        self._shed_queued()
        self._spawn_forks()
        while self.queue:
            try:
                slot = self.slots.index(None)
            except ValueError:
                return                      # slots full
            q = self.queue.popleft()
            req = q.req
            sp = req.params if req.params is not None else self._default_params
            now = self._clock()
            needed = self._blocks_needed(req.prompt.size, req.max_new_tokens)
            owned = self._reserve_blocks(needed)
            if owned is None:
                self.queue.appendleft(q)    # FIFO order is a fairness contract
                return
            row = self._tables[slot]
            row[:] = self._kv_pool_blocks
            row[:needed] = owned
            self._slot_blocks[slot] = needed
            self._tables_dirty = True
            eos_val = -1 if req.eos_id is None else req.eos_id
            prefill = None
            if self.prefill_mode == "exact":
                # The whole prompt in one forward; the row is live at once
                # and decodes in the next dispatch.
                self._push_tables()
                row_logits, self.cache = gen.prefill_into_paged(
                    self.cfg, self.params,
                    _to_device(req.prompt[None], self.device), self.cache,
                    slot)
                self.logits[slot] = row_logits[0]
                self.eos[slot] = eos_val
                self.budget[slot] = req.max_new_tokens
                self.emitted[slot] = 0
            else:
                prefill = _Prefill(tokens=req.prompt, next_off=0,
                                   eos_val=eos_val,
                                   budget_val=req.max_new_tokens)
            self.slots[slot] = _Slot(
                req=req, submit_t=q.submit_t, admit_t=now,
                deadline_t=q.deadline_t, owned=owned, spec_k=self.draft_k,
                prefill=prefill, sp=sp, mask=sp.logit_mask,
                mask_state=(sp.logit_mask.init_state()
                            if sp.logit_mask is not None else None))
            self._set_slot_sampling(slot, sp, 0)
            if prefill is None and sp.n > 1:
                # Exact prefill ran at once: the parent is fork-ready.
                self._capture_fork_source(slot, self.slots[slot])
            if not sp.is_greedy:
                self.stats.sampled_requests += 1
            self.stats.admitted += 1
            self.stats.record_queue_wait(now - q.submit_t)
        # Exact admissions may have captured fork sources; place their
        # children in the slots still free.
        self._spawn_forks()

    def _advance_prefills(self) -> None:
        """Run ONE prefill chunk for every slot mid-admission. Chunks sit
        on the absolute ``block_size`` grid; the final, possibly partial
        chunk pads to a power-of-two width, installs the last real
        position's logits and activates the row."""
        bs = self.block_size
        for i, slot in enumerate(self.slots):
            if slot is None or slot.prefill is None:
                continue
            p = slot.prefill
            off = p.next_off
            w_real = min(bs, p.tokens.size - off)
            w = bs
            if w_real < bs:
                w = 1
                while w < w_real:
                    w *= 2
            final = off + w_real >= p.tokens.size
            buf = np.zeros((1, w), np.int32)
            buf[0, :w_real] = p.tokens[off:off + w_real]
            self._push_tables()
            self._chunk(i, buf, off, w_real, p, final)
            self.stats.prefill_chunks += 1
            p.next_off = off + w_real
            if final:
                slot.prefill = None
                if slot.sp.n > 1:
                    # The prompt is in the pages and the row holds the
                    # prompt-final logits: the parent is fork-ready.
                    self._capture_fork_source(i, slot)
        self._spawn_forks()

    # -- copy-on-write forks (n > 1) ------------------------------------------

    def _capture_fork_source(self, i: int, slot: _Slot) -> None:
        """Snapshot a just-prefilled ``n > 1`` parent for forking. Each
        pending generation takes a pool ref on every full prompt page
        (owner ``("fork", rid, g)``) and on the partial boundary page
        until its copy lands (``("fork-src", rid, g)``), so neither the
        parent's retirement nor anything else frees a page a deferred
        child needs. The prompt-final logits row is copied here, before a
        later dispatch replaces the engine's logits."""
        sp = slot.sp
        bs = self.block_size
        n_prompt = int(slot.req.prompt.size)
        fp = n_prompt // bs                  # full, immutable prompt pages
        shared = [int(self._tables[i, b]) for b in range(fp)]
        boundary_bid = int(self._tables[i, fp]) if n_prompt % bs else None
        gens = list(range(1, sp.n))
        for g in gens:
            for bid in shared:
                self.pool.ref(bid, owner=("fork", slot.req.rid, g))
            if boundary_bid is not None:
                self.pool.ref(boundary_bid,
                              owner=("fork-src", slot.req.rid, g))
        self._fork_sources.append(_ForkSource(
            req=slot.req, sp=sp, submit_t=slot.submit_t,
            admit_t=slot.admit_t, deadline_t=slot.deadline_t,
            gens_left=gens, table=self._tables[i].copy(),
            needed=int(self._slot_blocks[i]), prompt_len=n_prompt,
            logits_row=self.logits[i].clone(), shared=shared,
            boundary_bid=boundary_bid))

    def _materialize_fork(self, slot_idx: int, src: _ForkSource,
                          g: int) -> bool:
        """Install generation ``g`` of ``src`` into a free slot: the
        parent's table entries for the full prompt pages, a fresh copy of
        the boundary page (the child's first decode write lands in it),
        fresh decode pages, and the row made live with the parent's
        prefill-final logits. False (the source's holds intact, to retry
        next quantum) when the pool cannot supply the fresh pages yet."""
        bs = self.block_size
        n_prompt = src.prompt_len
        fp = n_prompt // bs
        owned = self._reserve_blocks(src.needed - fp)
        if owned is None:
            return False
        row = self._tables[slot_idx]
        row[:] = self._kv_pool_blocks
        row[:fp] = src.table[:fp]
        row[fp:src.needed] = owned
        self._slot_blocks[slot_idx] = src.needed
        self._tables_dirty = True
        if src.boundary_bid is not None:
            gen.copy_pool_pages(self.cache, [src.boundary_bid], [owned[0]])
            self.pool.unref(src.boundary_bid,
                            owner=("fork-src", src.req.rid, g))
            self.stats.cow_page_copies += 1
        self.logits[slot_idx] = src.logits_row
        self.eos[slot_idx] = -1 if src.req.eos_id is None else src.req.eos_id
        self.budget[slot_idx] = src.req.max_new_tokens
        self.emitted[slot_idx] = 0
        self.cache.length[slot_idx] = n_prompt
        self.cache.active[slot_idx] = True
        self.slots[slot_idx] = _Slot(
            req=src.req, submit_t=src.submit_t, admit_t=src.admit_t,
            deadline_t=src.deadline_t, spec_k=self.draft_k, owned=owned,
            sp=src.sp, gen_idx=g, shared=list(src.shared),
            mask=src.sp.logit_mask,
            mask_state=(src.sp.logit_mask.init_state()
                        if src.sp.logit_mask is not None else None))
        self._set_slot_sampling(slot_idx, src.sp, g)
        self.stats.admitted += 1
        self.stats.fork_shared_tokens += fp * bs
        if not src.sp.is_greedy:
            self.stats.sampled_requests += 1
        return True

    def _spawn_forks(self) -> None:
        """Place pending fork generations into free slots. A source whose
        deadline passed sheds its remaining generations, holds
        released."""
        if not self._fork_sources:
            return
        remaining: List[_ForkSource] = []
        for src in self._fork_sources:
            if (src.deadline_t is not None
                    and self._clock() >= src.deadline_t):
                self._cancel_fork_source(src, "deadline")
                continue
            while src.gens_left:
                try:
                    slot = self.slots.index(None)
                except ValueError:
                    break
                if not self._materialize_fork(slot, src, src.gens_left[0]):
                    break
                src.gens_left.pop(0)
            if src.gens_left:
                remaining.append(src)
        self._fork_sources = remaining

    def _cancel_fork_source(self, src: _ForkSource, reason: str) -> None:
        """Release every pending generation's page holds and emit its
        (empty) Completion. The caller drops ``src`` from
        ``_fork_sources``."""
        now = self._clock()
        for g in list(src.gens_left):
            for bid in src.shared:
                self.pool.unref(bid, owner=("fork", src.req.rid, g))
            if src.boundary_bid is not None:
                self.pool.unref(src.boundary_bid,
                                owner=("fork-src", src.req.rid, g))
            self._finish_completion(Completion(
                rid=src.req.rid, tokens=[], finish_reason=reason,
                submit_t=src.submit_t, first_token_t=None, done_t=now,
                admit_t=src.admit_t, gen=g))
            self._rid_done(src.req.rid)
        src.gens_left = []

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return (not self.queue and self.n_active == 0
                and self._pending is None and not self._done_buf
                and not self._fork_sources)

    def step(self) -> List[Completion]:
        """One scheduling quantum, pipelined one dispatch deep:

        0. flush buffered sheds and deadline-retire due slots (their
           device rows go inactive before the dispatch below);
        1. dispatch the next fused decode chunk over the pool;
        2. book the PREVIOUS dispatch's tokens while the device works;
        3. admit waiting requests into freed slots and advance every
           slot's prefill by one chunk.

        Returns the requests that finished this quantum. While a
        decoding slot carries a grammar mask, :meth:`_step_constrained`
        runs instead; otherwise ``spec_decode=True`` engines run
        :meth:`_step_spec`."""
        if self._masked_decoding():
            return self._step_constrained()
        if self.spec_decode:
            return self._step_spec()
        finished: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        finished.extend(self._retire_due())
        snapshot = self._decoding_snapshot()
        dispatched = self._dispatch_plain(snapshot)
        finished.extend(self._process_pending())
        self._pending = dispatched
        self._admit_waiting()
        self._advance_prefills()
        self._sync_stats()
        return finished

    def _decoding_snapshot(self) -> List[Optional[_Slot]]:
        """The slots past prefill. A mid-prefill slot's device row is
        inactive, and snapshotting it as None keeps its chunk garbage out
        of the books."""
        return [s if (s is not None and s.prefill is None) else None
                for s in self.slots]

    def _dispatch_plain(self, snapshot):
        """Dispatch the pipelined plain chunk when any slot decodes — the
        sampled twin when a decoding row samples, else the greedy chunk:
        the ``(token fetch, snapshot)`` to book next quantum, or None."""
        if not any(s is not None for s in snapshot):
            return None
        self._push_tables()
        chunk = (self._decode_chunk_sampled if self._sampled_in(snapshot)
                 else self._decode_chunk)
        return _Fetch(chunk(self._view_width())), snapshot

    def _step_constrained(self) -> List[Completion]:
        """One quantum while a decoding slot carries a grammar mask. The
        automaton must see token i before it can admit token i+1, so the
        quantum books the pipelined chunk still in flight, then
        dispatches ONE masked micro-step and books it at once. Unmasked
        rows ride along under all-True mask rows; since draws are keyed
        by (seed, gen, position), their streams do not change with the
        kind of quantum. A masked slot whose grammar admits nothing (and
        that has no EOS to carry the end) retires as an EOS finish."""
        finished: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        finished.extend(self._retire_due())
        finished.extend(self._process_pending())  # booking order = stream order
        snapshot = self._decoding_snapshot()
        vocab = self.cfg.vocab_size
        mask = np.ones((self.n_slots, vocab), bool)
        now = self._clock()
        for i, s in enumerate(snapshot):
            if s is None or s.mask is None:
                continue
            allowed = s.mask.allowed(s.mask_state)
            if not allowed.any():
                finished.append(self._retire_slot(i, s, "eos", now))
                snapshot[i] = None
                continue
            mask[i] = allowed
            self.stats.mask_tokens_filtered += int(vocab - int(allowed.sum()))
        if any(s is not None for s in snapshot):
            self._push_tables()
            toks = _Fetch(self._masked_step(
                self._view_width(), mask,
                self._sampled_in(snapshot) > 0)).numpy()
            now = self._clock()
            self.stats.steps += 1
            for i, s in enumerate(snapshot):
                if s is None or self.slots[i] is not s:
                    continue
                tok = int(toks[i])
                if s.mask is not None:
                    s.mask_state = s.mask.advance(s.mask_state, tok)
                # The masked step does not peek: speculation for this
                # slot resumes after its next plain quantum.
                s.next_tok = None
                comp = self._book_token(i, s, tok, now)
                if comp is not None:
                    # Recorded here as the other booking paths record
                    # theirs (the JAX engine's constrained step does not).
                    self.stats.record(comp)
                    finished.append(comp)
        self._admit_waiting()
        self._advance_prefills()
        self._sync_stats()
        return finished

    def _step_spec(self) -> List[Completion]:
        """One quantum with speculative decoding. Drafting needs the last
        committed token, so the order differs from :meth:`step`: the
        previous dispatch books FIRST (it carries each surviving slot's
        ``next_tok``), then the proposer runs over the live contexts, and
        the dispatch is the fused verify step (booked at once: its output
        feeds the next proposal) or, when nothing drafts, the plain
        pipelined chunk. When no lane is worth a probe (cooldown, or a
        host-side scan of the booked context finds no candidate), the
        quantum is exactly the plain one: dispatch first, then book."""
        finished: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        finished.extend(self._retire_due())
        probe = False
        for i, s in enumerate(self.slots):
            if s is None or s.prefill is not None:
                continue
            if self._spec_cooldown[i] > 0:
                continue
            ctx = np.concatenate([s.req.prompt, np.asarray(s.tokens, np.int32)])
            if self._proposer.has_candidate(ctx):
                probe = True
            else:
                self._note_spec_miss(i, s)
        if not probe:
            snapshot = self._decoding_snapshot()
            if any(s is not None for s in snapshot):
                for i, s in enumerate(snapshot):
                    if s is not None and self._spec_cooldown[i] > 0:
                        self._spec_cooldown[i] -= 1
            dispatched = self._dispatch_plain(snapshot)
            finished.extend(self._process_pending())
            self._pending = dispatched
            self._admit_waiting()
            self._advance_prefills()
            self._sync_stats()
            return finished
        finished.extend(self._process_pending())
        snapshot = self._decoding_snapshot()
        if any(s is not None for s in snapshot):
            self.stats.spec_probe_steps += 1
            proposal = self._propose_drafts(snapshot)
            if proposal is not None:
                draft, dlen = proposal
                self._push_tables()
                out = _Fetch(self._verify(
                    self._view_width(), draft, dlen,
                    sampled=self._sampled_in(snapshot) > 0)).numpy()
                k1 = draft.shape[1] + 1
                finished.extend(self._book_spec(
                    snapshot, out[:, :k1], out[:, k1], out[:, k1 + 1], dlen))
            else:
                self._pending = self._dispatch_plain(snapshot)
        self._admit_waiting()
        self._advance_prefills()
        self._sync_stats()
        return finished

    def _propose_drafts(self, snapshot):
        """Draft proposals for every slot eligible to speculate: decoding,
        its next token known, at least 2 tokens of budget left, not an
        EOS away from retiring, not cooling down (the cooldown ticks down
        here, on each step the slot sits out). Returns ``(draft [B, K]
        int32, dlen [B] int32)``, or None when no slot has a draft."""
        k = self.draft_k
        contexts: List[Optional[np.ndarray]] = [None] * self.n_slots
        caps = np.zeros((self.n_slots,), np.int32)
        for i, slot in enumerate(snapshot):
            if slot is None:
                continue
            if self._spec_cooldown[i] > 0:
                self._spec_cooldown[i] -= 1
                continue
            if slot.next_tok is None:
                continue                  # first step after admission
            remaining = slot.req.max_new_tokens - len(slot.tokens) - 1
            if remaining < 1:
                continue                  # next_tok retires the slot
            if (slot.req.eos_id is not None
                    and slot.next_tok == slot.req.eos_id):
                continue                  # nothing follows EOS
            caps[i] = min(max(1, slot.spec_k), remaining, k)
            if self._spec_backoff[i] > 0 and slot.spec_hits == 0:
                # A backed-off lane probes with ONE token, so a spurious
                # match cannot buy a full-width garbage verify.
                caps[i] = 1
            contexts[i] = np.concatenate([
                slot.req.prompt,
                np.asarray(slot.tokens + [slot.next_tok], np.int32)])
        if not any(c is not None for c in contexts):
            return None
        draft, lens = self._proposer.propose(contexts, k)
        lens = np.minimum(np.asarray(lens, np.int32), caps)
        # A verify quantum is serialized, a plain one commits decode_chunk
        # tokens pipelined: drop drafts too short to commit ~2x that.
        # Probes (cap 1) and budget-capped drafts are exempt.
        min_len = 2 * self.decode_chunk
        for i in range(self.n_slots):
            if caps[i] > 1 and 0 < lens[i] < min(min_len, int(caps[i])):
                lens[i] = 0
        # No draft (or none long enough) for an eligible slot is a miss
        # too, so incompressible traffic enters cooldown.
        for i, slot in enumerate(snapshot):
            if contexts[i] is not None and lens[i] == 0:
                self._note_spec_miss(i, slot)
        if not lens.any():
            return None
        return np.asarray(draft, np.int32), lens

    def _note_spec_miss(self, i: int, slot: _Slot) -> None:
        """One fruitless round on lane ``i`` (no match, or a verified
        draft with zero accepts). The first descent takes
        ``spec_patience`` misses in a row; once backed off, one fruitless
        probe re-enters cooldown at twice the interval (capped at
        ``spec_cooldown_max``)."""
        slot.spec_hits = 0
        slot.spec_miss += 1
        if (self._spec_backoff[i] > 0
                or slot.spec_miss >= self.spec_patience):
            self._spec_backoff[i] = min(max(4, self._spec_backoff[i] * 2),
                                        self.spec_cooldown_max)
            self._spec_cooldown[i] = self._spec_backoff[i]
            slot.spec_miss = 0

    def _book_spec(self, snapshot, window, n, next_tok,
                   dlen) -> List[Completion]:
        """Book one verify step: for each surviving snapshot row, record
        its ``n[i]`` committed window tokens through the shared EOS/budget
        rule, update the acceptance counters and the adaptive-K / backoff
        state, and keep ``next_tok`` for the next proposal. A row retired
        on the host since the dispatch fails the snapshot-identity check
        and its tokens are dropped, as on the plain path."""
        now = self._clock()
        self.stats.steps += 1
        self.stats.spec_steps += 1
        finished: List[Completion] = []
        for i, slot in enumerate(snapshot):
            if slot is None or self.slots[i] is not slot:
                continue
            n_i = int(n[i])
            if n_i <= 0:
                continue
            hist = self.stats.spec_step_tokens_hist
            hist[n_i] = hist.get(n_i, 0) + 1
            d = int(dlen[i])
            accepted = min(n_i - 1, d)
            if d > 0:
                self.stats.draft_proposed += d
                self.stats.draft_accepted += accepted
                if accepted >= d:
                    # Full accept: regrow toward draft_k by doubling; a
                    # probe hit jumps to full width. Clearing the backoff
                    # takes a >= 2-token full accept or two probe hits.
                    if self._spec_backoff[i] > 0 and d == 1:
                        slot.spec_k = self.draft_k
                    else:
                        slot.spec_k = min(self.draft_k,
                                          max(1, slot.spec_k) * 2)
                    slot.spec_miss = 0
                    slot.spec_hits += 1
                    if d >= 2 or slot.spec_hits >= 2:
                        self._spec_backoff[i] = 0
                        slot.spec_hits = 0
                elif accepted == 0:
                    slot.spec_k = max(1, slot.spec_k // 2)
                    self._note_spec_miss(i, slot)
                else:
                    slot.spec_k = max(1, accepted + 1)
                    slot.spec_miss = 0
                    slot.spec_hits = 0
            # n was cut at the first committed EOS and at the budget, so
            # only the LAST committed token can finish the request.
            if n_i > 1:
                if slot.first_token_t is None:
                    slot.first_token_t = now
                slot.tokens.extend(int(t) for t in window[i, :n_i - 1])
                self.stats.tokens_out += n_i - 1
                self.stats.active_slot_steps += n_i - 1
            comp = self._book_token(i, slot, int(window[i, n_i - 1]), now)
            if comp is not None:
                finished.append(comp)
            else:
                slot.next_tok = int(next_tok[i])
        for c in finished:
            self.stats.record(c)
        return finished

    def _sync_stats(self) -> None:
        self.stats.heartbeat += 1
        self.stats.pool_blocks_total = self.pool.n_blocks
        self.stats.pool_blocks_in_use = self.pool.used_blocks
        self.stats.kv_bytes_per_token = kv_blocks.kv_bytes_per_token(
            self.cfg, self.kv_quant)
        reg = registry()
        reg.gauge("queue_depth", "serving").set(len(self.queue))
        reg.gauge("pool_blocks_in_use", "serving").set(self.pool.used_blocks)
        reg.gauge("active_slots", "serving").set(self.n_active)

    def _book_token(self, i: int, slot: _Slot, tok: int,
                    now: float) -> Optional[Completion]:
        """Record ONE token against a live slot and apply the host half
        of the retirement rule (EOS / budget — the rule the device
        applied). Returns the Completion when this token finishes the
        request."""
        req = slot.req
        if slot.first_token_t is None:
            slot.first_token_t = now
        slot.tokens.append(tok)
        self.stats.tokens_out += 1
        self.stats.active_slot_steps += 1
        done_eos = req.eos_id is not None and tok == req.eos_id
        if not done_eos and len(slot.tokens) < req.max_new_tokens:
            return None
        self._free_owned(slot)
        self._free_shared(slot)
        self._clear_table_row(i)
        comp = Completion(
            rid=req.rid, tokens=slot.tokens,
            finish_reason="eos" if done_eos else "length",
            submit_t=slot.submit_t, first_token_t=slot.first_token_t,
            done_t=now, admit_t=slot.admit_t, gen=slot.gen_idx)
        self.slots[i] = None
        self._rid_done(req.rid)
        return comp

    def _process_pending(self) -> List[Completion]:
        """Book the token chunk of the previous dispatch against the
        slots captured AT dispatch time; a snapshot row whose slot has
        since been freed or reassigned is skipped. With speculative
        decoding the chunk also carried each row's next committed token,
        which a surviving slot keeps for the next proposal."""
        if self._pending is None:
            return []
        fetch, snapshot = self._pending
        self._pending = None
        toks_np = fetch.numpy()                       # [chunk (+1), B]
        next_np = None
        if self.spec_decode:
            toks_np, next_np = toks_np[:-1], toks_np[-1]
        now = self._clock()
        self.stats.steps += toks_np.shape[0]
        finished: List[Completion] = []
        for i, slot in enumerate(snapshot):
            if slot is None or self.slots[i] is not slot:
                continue
            comp = None
            for k in range(toks_np.shape[0]):
                comp = self._book_token(i, slot, int(toks_np[k, i]), now)
                if comp is not None:
                    finished.append(comp)
                    break
            if comp is None and next_np is not None:
                slot.next_tok = int(next_np[i])
        for c in finished:
            self.stats.record(c)
        return finished

    def drain(self, grace_s: float = 5.0) -> List[Completion]:
        """Graceful shutdown: stop admission, shed the queue, let
        in-flight slots finish within ``grace_s`` wall seconds, then
        deadline-retire what is still decoding. Every outstanding request
        comes back as a Completion with a typed finish reason."""
        self._draining = True
        out: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        now = self._clock()
        while self.queue:
            q = self.queue.popleft()
            self._rids.discard(q.req.rid)
            self._rid_gens.pop(q.req.rid, None)
            comp = Completion(
                rid=q.req.rid, tokens=[], finish_reason="shed",
                submit_t=q.submit_t, first_token_t=None, done_t=now)
            self.stats.record(comp)
            out.append(comp)
        deadline = now + grace_s
        while not self.idle and self._clock() < deadline:
            out.extend(self.step())
        # Grace exhausted: book the chunk still in flight (those tokens
        # were decoded — keep them), then force-retire stragglers.
        out.extend(self._process_pending())
        now = self._clock()
        for i, slot in enumerate(self.slots):
            if slot is not None:
                out.append(self._retire_slot(i, slot, "deadline", now))
        # Forks never placed shed with their page holds released.
        for src in self._fork_sources:
            self._cancel_fork_source(src, "deadline")
        self._fork_sources = []
        out.extend(self._done_buf)
        self._done_buf.clear()
        self._sync_stats()
        self._flush_observability(drained=1.0)
        return out

    def _flush_observability(self, **extra: float) -> None:
        """Write the metrics JSONL summary (with ``extra`` markers) and
        close it; idempotent."""
        if self._metrics is not None:
            scalars = self.stats.summary()
            scalars.update(extra)
            self._metrics.write(self.stats.steps, scalars)
            self._metrics.close()
            self._metrics = None

    def run(self, requests: Sequence[Request], max_steps: int = 0,
            stop=None, drain_grace_s: float = 5.0) -> List[Completion]:
        """Submit ``requests`` and step until everything finishes.
        Results come back in completion order. ``max_steps`` bounds the
        loop (0 = the worst case derived from the workload); ``stop``
        (a ``threading.Event``) drains early. An overrun raises
        :class:`DrainError` carrying the completions that did finish."""
        for r in requests:
            self.submit(r)
        if not max_steps:
            max_steps = sum(
                (r.params.n if r.params is not None else 1)
                * (r.max_new_tokens + 2)
                + -(-int(np.asarray(r.prompt).size) // self.block_size)
                for r in requests
            ) + 2 * len(requests) + 4
        out: List[Completion] = []
        for _ in range(max_steps):
            if stop is not None and stop.is_set():
                out.extend(self.drain(drain_grace_s))
                return out
            out.extend(self.step())
            if self.idle:
                break
        if not self.idle:
            self._sync_stats()
            self._flush_observability(drain_error=1.0)
            raise DrainError(
                f"engine did not drain in {max_steps} steps "
                f"({self.n_active} active, {len(self.queue)} queued)",
                completions=out)
        return out
