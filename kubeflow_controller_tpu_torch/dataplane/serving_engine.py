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
  otherwise. Greedy streams are those of plain decode.

Greedy decoding only. Everything else the JAX engine offers raises "not
yet ported" when asked for: the prefix cache, the radix proposer, the
host tier, sampling, ``n > 1`` forks, grammars, tensor parallelism,
disaggregation, fault injection and the tracer.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_controller_tpu_torch.dataplane import kv_blocks
from kubeflow_controller_tpu_torch.dataplane import spec_decode as spec_mod
from kubeflow_controller_tpu_torch.dataplane.metrics import (
    MetricsLogger, ServingStats,
)
from kubeflow_controller_tpu_torch.dataplane.sampling import SamplingParams
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
    finish_reason: str                # eos | length | deadline | shed
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
    first_token_t: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    owned: List[int] = field(default_factory=list)   # pool pages held
    prefill: Optional[_Prefill] = None   # set while mid-chunked-prefill
    # Speculative decoding: the next committed token (argmax of the
    # carried logits, fetched with the step that computed it; None until
    # the slot's first booked step), the adaptive draft length, and the
    # consecutive fruitless rounds and full accepts that drive backoff.
    next_tok: Optional[int] = None
    spec_k: int = 0
    spec_miss: int = 0
    spec_hits: int = 0


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
            (not self._default_params.is_greedy,
             "sampling (temperature > 0)"),
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
            if not req.params.is_greedy:
                raise not_yet_ported("sampling (temperature > 0)")
            if req.params.n > 1:
                raise not_yet_ported("parallel generations (n > 1)")
            if req.params.max_tokens is not None:
                req.max_new_tokens = int(req.params.max_tokens)
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
        self.stats.submitted += 1
        self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                         len(self.queue))

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
        self._clear_table_row(i)
        comp = Completion(
            rid=slot.req.rid, tokens=slot.tokens, finish_reason=reason,
            submit_t=slot.submit_t, first_token_t=slot.first_token_t,
            done_t=now, admit_t=slot.admit_t)
        self.slots[i] = None
        self._rids.discard(slot.req.rid)
        self.cache.active[i] = False
        self.stats.record(comp)
        return comp

    def _retire_due(self) -> List[Completion]:
        """Retire in-flight slots whose deadline passed, before the next
        dispatch."""
        out: List[Completion] = []
        for i, slot in enumerate(self.slots):
            if (slot is not None and slot.deadline_t is not None
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

    def _verify(self, vw: int, draft: np.ndarray, dlen: np.ndarray):
        """One fused verify step over the pool: commit each row's accepted
        run, then apply the plain chunk's retirement rule on the device —
        an EOS inside the committed run, or the budget spent (``max_commit
        = budget - emitted`` caps the run, so a row retires at exactly
        its budget). Returns ``[n_slots, K + 3]`` int32: the window, the
        committed count n and the next committed token."""
        max_commit = (self.budget - self.emitted).clamp_min(1)
        window, n, self.logits, self.cache = gen.verify_step_paged(
            self.cfg, self.params, _to_device(draft, self.device),
            _to_device(dlen, self.device), self.logits, self.cache, self.eos,
            max_commit, view_width=vw, attn_impl=self.attn_impl)
        self.emitted = self.emitted + n              # n = 0 on inactive rows
        in_commit = (torch.arange(window.shape[1], device=self.device)[None, :]
                     < n[:, None])
        committed_eos = ((window == self.eos[:, None])
                         & (self.eos[:, None] >= 0) & in_commit).any(1)
        active = self.cache.active
        done = active & (committed_eos | (self.emitted >= self.budget))
        self.cache.active = active & ~done
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
        admission stops for this step."""
        self._shed_queued()
        while self.queue:
            try:
                slot = self.slots.index(None)
            except ValueError:
                return                      # slots full
            q = self.queue.popleft()
            req = q.req
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
                prefill=prefill)
            self.stats.admitted += 1
            self.stats.record_queue_wait(now - q.submit_t)

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

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return (not self.queue and self.n_active == 0
                and self._pending is None and not self._done_buf)

    def step(self) -> List[Completion]:
        """One scheduling quantum, pipelined one dispatch deep:

        0. flush buffered sheds and deadline-retire due slots (their
           device rows go inactive before the dispatch below);
        1. dispatch the next fused decode chunk over the pool;
        2. book the PREVIOUS dispatch's tokens while the device works;
        3. admit waiting requests into freed slots and advance every
           slot's prefill by one chunk.

        Returns the requests that finished this quantum.
        ``spec_decode=True`` engines run :meth:`_step_spec` instead."""
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
        """Dispatch the pipelined plain chunk when any slot decodes: the
        ``(token fetch, snapshot)`` to book next quantum, or None."""
        if not any(s is not None for s in snapshot):
            return None
        self._push_tables()
        return _Fetch(self._decode_chunk(self._view_width())), snapshot

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
                out = _Fetch(self._verify(self._view_width(), draft,
                                          dlen)).numpy()
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
        self._clear_table_row(i)
        comp = Completion(
            rid=req.rid, tokens=slot.tokens,
            finish_reason="eos" if done_eos else "length",
            submit_t=slot.submit_t, first_token_t=slot.first_token_t,
            done_t=now, admit_t=slot.admit_t)
        self.slots[i] = None
        self._rids.discard(req.rid)
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
                (r.max_new_tokens + 2)
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
