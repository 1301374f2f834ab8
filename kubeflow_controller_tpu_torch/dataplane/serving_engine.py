"""Continuous-batching LM decode engine over the paged KV pool.

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
  copy only the partial boundary page;
* ``prefix_cache=True`` (bucketed prefill): a radix trie over the pool
  (``dataplane/kv_blocks.py``). Admission walks it with the prompt and
  puts the matched chain's page ids into the slot's table row (no byte
  moves), and prefill starts at the matched offset; the final prefill
  chunk and the natural retirement publish the slot's own full pages
  into the trie (ownership moves, no copy); a reservation short of pages
  evicts cold chains. ``host_kv_mb > 0`` adds a pinned-host tier beneath
  the trie: evicted pages spill there and a later admission installs
  them back, bytes verbatim. ``proposer="radix"`` drafts from the trie;
  :meth:`register_prefix` ingests an external contiguous cache.

Parameters from ``generate.inference_params(quant="int8")`` serve with
weight-only int8 projections. A MoE model serves its routed FFN in every
path (``models/generate.py``), with the counters
``moe_tokens_dispatched`` and ``moe_experts_per_shard``.

Tensor parallelism (``tp`` or ``mesh``, and ``tp_compute``): one process
a tp rank of a ``torch.distributed`` gang (``parallel.mesh.
serving_mesh``), each running this engine on the same requests. A rank
stores its chunks of the weights (``parallel.sharding.
shard_serving_params``) and its ``KVH / tp`` heads of every pool page;
the scheduler is mesh-blind, its block tables, lengths and logits whole
on every rank, and every kernel call runs over the mesh (``"gathered"``:
the one-device arithmetic, greedy streams bit for bit; ``"parallel"``:
Megatron's split, within ``generate.tp_parallel_tolerance``; a MoE
model's experts split over tp in both). The decisions the host takes
from the clock (deadlines, queue waits, the drain's grace) read rank
0's clock, broadcast to the gang at every read, and :meth:`run`'s
``stop`` is rank 0's: every rank books, retires and admits alike. The
KV budget is per device, and the host tier counts whole pages' bytes.

The fleet (``dataplane/router.py``) drives several engines on one card
(they share one set of weight tensors, each with its own pool):

* ``Request.prefill_only`` (bucketed prefill): the finished prefill
  parks export-ready, its row inactive and its prompt-final logits row
  copied; :meth:`ServingEngine.export_request` ships its pool pages (one
  gather on the device, one copy to pinned host memory) and that row as
  a :class:`MigrationPayload`, :meth:`ServingEngine.admit_migrated`
  installs them on another engine, bytes verbatim, and activates the
  slot from the row as a fork activates from its parent's; a re-sent
  payload after a lost ACK is deduplicated by rid;
* :meth:`ServingEngine.export_prefix` and
  :meth:`ServingEngine.admit_prefix_to_tier` move a cached prefix chain
  into another engine's host tier (a fleet prefix pull);
* ``tracer`` (``obs/trace.py``) records the request lifecycle spans of
  the JAX engine, with its names and attributes, in host time (no
  device synchronization); ``injector`` (``dataplane/faults.py``) fires
  the ``engine.step``, ``engine.submit`` and ``engine.admit_migrated``
  faults, and the host tier's ``tier.read``.

``stats.summary()`` publishes the JAX engine's keys (``cancelled``, the
pool and tp gauges, the analytic traffic model of
:meth:`ServingEngine._traffic_model`, the migration, fault and span
counters) but its jit-cache counts; ``paged=False`` raises the JAX
engine's ``ValueError``. Under tensor parallelism the fleet paths
(``prefill_only``, migration and prefix pulls) raise "not yet ported".
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from kubeflow_controller_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_controller_tpu_torch.parallel import sharding as sharding_lib


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
    # Radix-trie nodes this request pins (prefix cache): the matched
    # prefix from admission, extended by the publish at the final prefill
    # chunk; released on every retirement path (_release_pins).
    path: List[kv_blocks.RadixNode] = field(default_factory=list)
    # Pool pages this slot owns; a publish that adopts pages into the trie
    # removes them.
    owned: List[int] = field(default_factory=list)
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
    # Prefill/decode disaggregation: a prefill_only request parks here
    # once its prefill finishes: its device row stays inactive, its
    # pages pinned, and a COPY of its prompt-final logits row (taken at
    # the final chunk: the engine's logits buffer takes in-place writes)
    # seeds the first decode token on the engine that receives it.
    export_ready: bool = False
    export_logits: Optional[torch.Tensor] = None


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


@dataclass
class MigrationPayload:
    """The cross-engine wire format of one finished prefill: what the
    decode engine needs to resume the request where the prefill engine
    left it. The pages travel raw (int8 codes and fp32 scales for an
    int8 pool, never dequantized), so the hop is bit-invisible.
    ``page_starts[i]`` is the token offset of ``pages_*[:, i]`` in the
    prompt, a multiple of ``block_size``; ``skip_tokens`` leading prompt
    tokens are omitted because the receiver's trie holds them (they
    travel as pointers). Every tensor is on the host (pinned when the
    exporter's pool is on the card), in the JAX payload's layout."""

    rid: int
    prompt: np.ndarray                # [prompt_len] int32
    max_new_tokens: int
    eos_id: Optional[int]
    params: Optional[SamplingParams]
    submit_t: float                   # fleet clock: TTFT spans the hop
    admit_t: float
    deadline_t: Optional[float]
    logits_row: torch.Tensor          # [vocab] f32, prefill-final logits
    pages_k: torch.Tensor             # [L, m, bs, KVH, D] pool dtype
    pages_v: torch.Tensor
    scales_k: Optional[torch.Tensor]  # [L, m, bs, KVH] f32 (int8 KV only)
    scales_v: Optional[torch.Tensor]
    page_starts: List[int]            # token offset of each shipped page
    prompt_len: int
    skip_tokens: int                  # leading tokens omitted (zero-copy)
    block_size: int
    kv_quant: str
    nbytes: int = 0                   # payload bytes (pages + scales)
    # The router stamps the attempt number on each (re-)send; the
    # receiver dedupes installs by rid while the rid is live, so a lost
    # ACK can never install twice.
    attempt: int = 0


@dataclass
class PrefixPayload:
    """The fleet prefix-pull wire format: one cached prefix chain,
    copied out of the owning engine's pool and host tier in raw pool
    types (never requantized), so that installing it in another
    engine's host tier and rehydrating later is a local hit's bits.
    ``chunks[i]`` is the i-th trie edge's token key, ``pages_*[:, i]``
    its page; host tensors."""

    chunks: List[Tuple[int, ...]]     # trie edge keys, root outward
    pages_k: torch.Tensor             # [L, m, bs, KVH, D] pool dtype
    pages_v: torch.Tensor
    scales_k: Optional[torch.Tensor]  # [L, m, bs, KVH] f32 (int8 only)
    scales_v: Optional[torch.Tensor]
    block_size: int
    kv_quant: str
    n_tokens: int                     # chain coverage in tokens
    nbytes: int                       # payload bytes (pages + scales)


def _parts_nbytes(*parts) -> int:
    return int(sum(t.numel() * t.element_size() for t in parts
                   if t is not None))


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
        mesh=None,
        tp_compute: str = "gathered",
        attn_impl: str = "kernel",
        paged: bool = True,
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
        if not paged:
            # The reference engine's own refusal: it serves from the block
            # pool only (its contiguous cache survives in models/generate.py
            # and serve(turns > 1) without the prefix cache).
            raise ValueError(
                "paged=False is unsupported: the block pool is the only KV "
                "storage of the engine (the contiguous cache serves "
                "serve(turns > 1) without the prefix cache)")
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
        # Tensor parallelism: the head split is checked first (the JAX
        # engine's message), then the mesh resolves (an explicit mesh
        # wins; tp > 1 without a gang of that many ranks raises the mesh's
        # ValueError). The weights are stored as this rank's chunks.
        if tp_compute not in gen.TP_COMPUTE:
            raise ValueError(
                f"tp_compute must be 'gathered' or 'parallel' "
                f"(got {tp_compute!r})")
        self.tp_compute = tp_compute
        self.tp = gen.tp_size(mesh) if mesh is not None else max(1, int(tp))
        gen.check_tp_heads(cfg, self.tp, tp_compute)
        self._mesh = (mesh if mesh is not None else
                      mesh_lib.serving_mesh(self.tp, device_type=self.device.type))
        self._host_group = None
        if self._mesh is not None:
            params = sharding_lib.shard_serving_params(
                cfg, params, self._mesh, gen.weight_quant(params))
            self._host_group = self._agreement_group(self._mesh)
            self._host_src = int(self._mesh.devices.reshape(-1)[0])
        self.cfg = cfg
        self.params = params
        # Every kernel call's tensor-parallel arguments.
        self._tp_kw = dict(mesh=self._mesh, tp_compute=tp_compute)
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
        # Weight-only int8 params (inference_params(quant="int8")); read
        # by the traffic model.
        self._w_quant = gen.weight_quant(params)
        # The view width of the latest dispatch: the traffic model's input.
        self._last_vw = 0
        # Pool sizing: explicit page count > memory budget > one full
        # context per slot (twice that with the prefix cache: an equal
        # allowance for the trie's tenancy, or every published chain
        # would be evicted by the next wave's reservations).
        if kv_pool_blocks is None:
            if kv_hbm_budget_mb is not None:
                # The budget is per device: a rank holds 1 / tp of every
                # page's bytes.
                kv_pool_blocks = kv_blocks.blocks_for_budget(
                    cfg, self.block_size, int(kv_hbm_budget_mb * (1 << 20)),
                    kv_quant, tp=self.tp)
            elif prefix_cache:
                kv_pool_blocks = 2 * n_slots * self._max_blocks
            else:
                kv_pool_blocks = n_slots * self._max_blocks
        self._kv_pool_blocks = int(kv_pool_blocks)
        self.pool = kv_blocks.BlockPool(self._kv_pool_blocks)
        # The host tier beneath the trie; 0 builds none, and eviction
        # discards.
        if host_kv_mb < 0:
            raise ValueError(f"host_kv_mb must be >= 0 (got {host_kv_mb})")
        if host_kv_mb > 0 and not prefix_cache:
            raise ValueError(
                "host_kv_mb > 0 requires prefix_cache=True (the host "
                "tier spills radix-cache pages; without the trie there "
                "is nothing to spill)")
        # Fault injection: None leaves every instrumented path as it is.
        # ``fault_target`` is the replica name specs match; the router
        # stamps it (the setter mirrors it into the host tier).
        self._injector = injector
        self._fault_target = ""
        # Quantum-stretch phase of an injected ``slow`` fault: one step()
        # in ``factor`` does work while it is active.
        self._slow_phase = 0
        # (rid -> attempt) of the migration installs this engine made,
        # LRU-capped: the ledger admit_migrated dedupes re-sends against.
        self._install_log: "OrderedDict[int, int]" = OrderedDict()
        self._host_tier: Optional[kv_blocks.HostKVTier] = None
        if host_kv_mb > 0:
            self._host_tier = kv_blocks.HostKVTier(
                int(host_kv_mb * (1 << 20)), injector=injector,
                shards=self.tp)
        # The rid an eviction spill is attributed to in the trace (set
        # around the admission that made the pressure).
        self._spill_rid: Optional[str] = None
        self._prefix_store: Optional[kv_blocks.PrefixStore] = None
        if prefix_cache:
            self._prefix_store = kv_blocks.PrefixStore(
                cfg, self.block_size, self._kv_pool_blocks, pool=self.pool,
                tier=self._host_tier)
        self._clock = clock if self._host_group is None else (
            lambda: self._agreed(clock()))
        # The tracer stamps its spans from the raw clock: on a tp gang a
        # trace read must not be a collective (rank 0's raw clock is the
        # agreed one).
        self._tracer = tracer
        self._tclock = clock
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
                self._proposer = spec_mod.make_proposer(
                    proposer, self._prefix_store)
            elif isinstance(proposer, spec_mod.DraftProposer):
                self._proposer = proposer
            else:
                raise ValueError(
                    f"proposer must be 'prompt', 'radix', or a "
                    f"DraftProposer (got {proposer!r})")

        self.cache = gen.init_paged_cache(
            cfg, n_slots, self._max_blocks, self._kv_pool_blocks,
            self.block_size, kv_quant, device=self.device, tp=self.tp)
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
        self.stats = ServingStats(n_slots=n_slots, tp=self.tp)
        # One-deep dispatch pipeline: (token fetch, slot snapshot).
        self._pending: Optional[Tuple[_Fetch, List[Optional[_Slot]]]] = None
        self._rids: set = set()
        self._done_buf: List[Completion] = []
        self._draining = False

    @staticmethod
    def _agreement_group(mesh):
        """The group rank 0's host values reach the other tp ranks over:
        the tp group on gloo, a gloo group over the same ranks on another
        backend (the values are host scalars, which NCCL does not
        carry). Every rank of the world takes part in making it."""
        if str(dist.get_backend()) == "gloo":
            return mesh.group("tp")
        return dist.new_group([int(r) for r in mesh.devices.reshape(-1)],
                              backend="gloo")

    def _agreed(self, value: float) -> float:
        """Rank 0's ``value`` on every tp rank (``value`` itself on one
        device)."""
        if self._host_group is None:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.broadcast(t, src=self._host_src, group=self._host_group)
        return float(t.item())

    def agreed_flag(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every tp rank: a stop signal or any other
        host event that must act on every rank at the same step."""
        return bool(self._agreed(1.0 if flag else 0.0))

    @property
    def fault_target(self) -> str:
        """Replica name fault specs match this engine under (set by the
        router at ``add_replica``; "" standalone)."""
        return self._fault_target

    @fault_target.setter
    def fault_target(self, name: str) -> None:
        self._fault_target = str(name)
        if self._host_tier is not None:
            self._host_tier.target = self._fault_target

    def reset(self) -> None:
        """Drop every queued and in-flight request and zero the pool and
        the stats, keeping the configuration. The prefix store is
        mutated in place (a ``RadixProposer`` holds it) over a fresh pool
        and a fresh tier; the lanes' speculation backoff stays (it is
        adaptation to the traffic)."""
        self.pool = kv_blocks.BlockPool(self._kv_pool_blocks)
        if self._host_tier is not None:
            self._host_tier = kv_blocks.HostKVTier(
                self._host_tier.budget_bytes,
                injector=self._host_tier.injector,
                target=self._host_tier.target, shards=self.tp)
        self._spill_rid = None
        self._slow_phase = 0
        self._install_log.clear()
        if self._prefix_store is not None:
            self._prefix_store.pool = self.pool
            self._prefix_store.tier = self._host_tier
            self._prefix_store.trie = kv_blocks.RadixCache(
                self.pool, self.block_size, tier=self._host_tier)
        self._tables = np.full(
            (self.n_slots, self._max_blocks), self._kv_pool_blocks, np.int32)
        self._tables_dirty = False
        self._slot_blocks = np.zeros(self.n_slots, np.int64)
        # The old pool goes before the new one is allocated.
        self.cache = None
        self.cache = gen.init_paged_cache(
            self.cfg, self.n_slots, self._max_blocks, self._kv_pool_blocks,
            self.block_size, self.kv_quant, device=self.device, tp=self.tp)
        self.logits.zero_()
        self.eos.fill_(-1)
        self.budget.zero_()
        self.emitted.zero_()
        self._temp_h[:] = 0.0
        self._topk_h[:] = 0
        self._topp_h[:] = 1.0
        self._seed_h[:] = 0
        self._gen_h[:] = 0
        self._samp_d = None
        self._gen_key_d = None
        self._fork_sources = []
        self._rid_gens = {}
        self.slots = [None] * self.n_slots
        self.queue.clear()
        self.stats = ServingStats(n_slots=self.n_slots, tp=self.tp)
        self._pending = None
        self._rids = set()
        self._done_buf = []
        self._draining = False

    def register_prefix(self, tokens, cache: gen.KVCache, row: int = 0) -> int:
        """Seed the prefix trie from an external contiguous cache: the
        multi-turn path, where a ``generate_from_cache(...,
        return_state=True)`` session registers its KV (prompt and
        replies) so the next turn's admission reuses it. ``tokens`` are
        the ids the cache row holds from position 0, ``row`` the batch
        row. Only full blocks register; blocks the trie lacks get pages
        (evicting if need be) and their KV is copied in
        (``scatter_row_into_pool``, quantized on write for int8 pools).
        Returns the tokens now cached for this prefix (0 without a
        prefix store)."""
        if self._prefix_store is None:
            return 0
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.size)
        if n > cache.k.shape[2]:
            raise ValueError(
                f"{n} tokens exceed cache capacity {cache.k.shape[2]}")
        path, new = self._prefix_store.trie.insert(tokens)
        if new:
            gen.scatter_row_into_pool(
                self.cache, cache.k, cache.v, row,
                [node.block for node, _ in new], [off for _, off in new],
                self.block_size, mesh=self._mesh)
        return len(path) * self.block_size

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request. Raises ``ValueError`` on malformed input and
        :class:`Rejected` on admission control (or an injected
        ``refuse_admit``); ``prefill_only`` under tensor parallelism
        raises ``NotImplementedError``."""
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
        if prompt.size + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {prompt.size} + "
                f"{req.max_new_tokens} new exceeds max_seq {self.max_seq}")
        if req.prefill_only and self.prefill_mode != "bucketed":
            # Only the chunked path leaves the device row inactive with
            # the final logits in hand.
            raise ValueError(
                f"request {req.rid}: prefill_only requires "
                "prefill_mode='bucketed'")
        if req.prefill_only and self._mesh is not None:
            raise not_yet_ported(
                "prefill/decode disaggregation under tensor parallelism")
        # A prefill-only request never decodes here: admission reserves
        # only the prompt's span (the receiver reserves the budget).
        needed = self._blocks_needed(
            prompt.size, 0 if req.prefill_only else req.max_new_tokens)
        if needed > self._kv_pool_blocks:
            raise ValueError(
                f"request {req.rid}: needs {needed} pool pages, pool "
                f"holds {self._kv_pool_blocks} (raise kv_pool_blocks / "
                f"kv_hbm_budget_mb, or shrink the request)")
        if req.rid in self._rids:
            raise ValueError(f"request {req.rid}: duplicate rid "
                             "among queued/in-flight requests")
        if self._injector is not None:
            # An admission-control flake: a typed Rejected, after the
            # ValueError checks (a fault never masks a caller bug).
            if self._injector.fires(
                    "engine", "engine.submit", target=self._fault_target,
                    rid=req.rid, kinds=("refuse_admit",)) is not None:
                self.stats.faults_injected += 1
                self.stats.rejected += 1
                raise Rejected(req.rid, "fault_injected")
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
        if self._tracer is not None:
            self._tracer.add_event(
                "submit", now, rid=str(req.rid),
                prompt_tokens=int(prompt.size),
                max_new=int(req.max_new_tokens))

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

    def _record_completion(self, comp: Completion) -> None:
        """The one funnel every recorded Completion passes through, so
        the stats and the trace agree: one ``retire`` event a recorded
        completion, with its finish reason."""
        self.stats.record(comp)
        if self._tracer is not None:
            self._tracer.add_event(
                "retire", comp.done_t, rid=str(comp.rid),
                finish_reason=comp.finish_reason,
                n_tokens=len(comp.tokens))

    def _finish_completion(self, comp: Completion) -> None:
        """Record a completion made outside a step's booking (a shed) and
        buffer it for the next step()'s return."""
        self._record_completion(comp)
        self._done_buf.append(comp)

    # -- block-table plumbing ----------------------------------------------

    def _push_tables(self) -> None:
        """Mirror the host block tables to the device cache; a no-op
        while clean."""
        if not self._tables_dirty:
            return
        t0 = self._tclock() if self._tracer is not None else 0.0
        self.cache.tables = _to_device(self._tables, self.device)
        self._tables_dirty = False
        if self._tracer is not None:
            self._tracer.add_span("push_tables", t0, self._tclock())

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
        self._last_vw = nb * self.block_size
        return self._last_vw

    def _blocks_needed(self, prompt_size: int, max_new: int) -> int:
        return -(-(prompt_size + max_new) // self.block_size)

    def _alloc_block(self) -> Optional[int]:
        """One pool page, evicting cold trie leaves while the free list
        is dry; None when every page is held by a live table."""
        bid = self.pool.alloc()
        while bid is None:
            if (self._prefix_store is None
                    or self._prefix_store.trie.evict_one(
                        spill=self._spill_cb()) is None):
                return None
            bid = self.pool.alloc()
        return bid

    def _reserve_blocks(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pool pages, evicting (and spilling, with the
        tier) cold prefix chains in one ``evict_chain`` call a deficit;
        None (every page unwound) when the pool cannot cover them even
        then.

        A page evicted here may still be named by the device table of
        the chunk in flight, but only by an inactive row, which reads it
        and writes nothing: its next tenant's writes are enqueued after
        that chunk on the same stream."""
        owned: List[int] = []
        while len(owned) < n:
            bid = self.pool.alloc()
            if bid is not None:
                owned.append(bid)
                continue
            if (self._prefix_store is None
                    or not self._prefix_store.trie.evict_chain(
                        n - len(owned), spill=self._spill_cb())):
                for b in owned:
                    self.pool.unref(b)
                return None
        return owned

    def _spill_cb(self):
        """The eviction spill callback, or None without a tier
        (eviction then discards)."""
        return self._spill_nodes if self._host_tier is not None else None

    def _spill_nodes(self, nodes: List[kv_blocks.RadixNode]) -> List[bool]:
        """Stage the victims' pool pages in the host tier: one gather of
        the wave, which returns once the bytes are on the host (so the
        pages may be freed and reused as soon as this returns), each page
        its own tier entry in the pool's storage types (never
        requantized). Returns each node's keep decision; False (the tier
        refused a page over its budget) discards."""
        tier = self._host_tier
        t0 = self._tclock() if self._tracer is not None else 0.0
        keep: List[bool] = []
        pages = 0
        nbytes = 0
        for node, payload in zip(nodes, gen.gather_pool_pages(
                self.cache, [n.block for n in nodes])):
            h = tier.put(payload)
            if h is None:
                keep.append(False)
                continue
            node.host_handle = h
            keep.append(True)
            pages += 1
            nbytes += tier.page_nbytes(payload)
        self.stats.spilled_pages += pages
        self.stats.spill_bytes += nbytes
        reg = registry()
        reg.counter("kv_spilled_pages", "dataplane").inc(pages)
        reg.counter("kv_spill_bytes", "dataplane").inc(nbytes)
        if self._tracer is not None and pages:
            span = {"pages": pages, "bytes": nbytes}
            if self._spill_rid is not None:
                span["rid"] = self._spill_rid
            self._tracer.add_span("kv_spill", t0, self._tclock(), **span)
        return keep

    def _rehydrate_nodes(self, nodes: List[kv_blocks.RadixNode],
                         rid=None) -> int:
        """Install spilled nodes' host pages back into the pool: the
        ``match_for_admission`` rehydrate callback. The payloads leave
        the tier FIRST (our own allocations below may spill, and must not
        drop them), then pages are allocated (evicting in one call a
        deficit), then one install writes the bytes verbatim. Each
        restored node is resident again and pinned for the admitting
        request. Returns how many leading nodes were restored; a tail the
        pool could not take goes back to the tier under fresh handles.

        The host-to-device copies read pinned tensors this function drops
        when it returns: the caching host allocator keeps each block
        until the copy's stream has passed it (it records an event on
        the stream at the copy)."""
        tier = self._host_tier
        if tier is None or not nodes:
            return 0
        trie = self._prefix_store.trie
        t0 = self._tclock() if self._tracer is not None else 0.0
        payloads: List[tuple] = []
        usable: List[kv_blocks.RadixNode] = []
        for node in nodes:
            payload = tier.pop(node.host_handle)
            if payload is None:
                trie.prune_subtree(node)    # a dead handle never restores
                break
            payloads.append(payload)
            usable.append(node)
        bids: List[int] = []
        while len(bids) < len(usable):
            bid = self.pool.alloc()
            if bid is not None:
                bids.append(bid)
                continue
            if not trie.evict_chain(len(usable) - len(bids),
                                    spill=self._spill_cb()):
                j = len(bids)
                for node2, payload2 in zip(usable[j:], payloads[j:]):
                    h = tier.put(payload2)
                    if h is None:
                        trie.prune_subtree(node2)
                        break
                    node2.host_handle = h
                usable = usable[:j]
                payloads = payloads[:j]
                break
        if not bids:
            return 0
        dev = self.device

        def joined(part: int) -> Optional[torch.Tensor]:
            if payloads[0][part] is None:
                return None
            return torch.cat([p[part].to(dev, non_blocking=True)
                              for p in payloads], 1)

        gen.install_pool_pages(self.cache, joined(0), joined(1), joined(2),
                               joined(3), bids)
        for node, bid in zip(usable, bids):
            trie.rehydrated(node, bid)
        trie.acquire(usable)
        tokens = len(bids) * self.block_size
        self.stats.rehydrate_hits += 1
        self.stats.rehydrate_tokens += tokens
        reg = registry()
        reg.counter("kv_rehydrate_hits", "dataplane").inc()
        reg.counter("kv_rehydrate_tokens", "dataplane").inc(tokens)
        if self._tracer is not None:
            self._tracer.add_span(
                "kv_rehydrate", t0, self._tclock(),
                rid=str(rid), pages=len(bids), tokens=tokens)
        return len(usable)

    def _release_pins(self, slot: _Slot) -> None:
        """Drop the slot's trie pins. Called on every retirement path
        (eos, length, deadline, cancel, shed of a slot and drain)
        beside :meth:`_free_owned` and :meth:`_free_shared`."""
        if self._prefix_store is not None and slot.path:
            self._prefix_store.release(slot.path)
            slot.path = []

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
        at a time (mid-prefill and export-parked slots do not count)."""
        return any(s is not None and s.prefill is None
                   and not s.export_ready
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
        self._release_pins(slot)
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
        self._record_completion(comp)
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
                attn_impl=self.attn_impl, **self._tp_kw)
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
                attn_impl=self.attn_impl, **self._tp_kw)
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
            attn_impl=self.attn_impl, **self._tp_kw)
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
                    self.emitted, view_width=vw, attn_impl=self.attn_impl,
                    **self._tp_kw)
        else:
            window, n, self.logits, self.cache = gen.verify_step_paged(
                self.cfg, self.params, draft_d, dlen_d, self.logits,
                self.cache, self.eos, max_commit, view_width=vw,
                attn_impl=self.attn_impl, **self._tp_kw)
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
            attn_impl=self.attn_impl, **self._tp_kw)
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
            path: List[kv_blocks.RadixNode] = []
            matched = 0
            if self._prefix_store is not None:
                rehydrate = None
                if self._host_tier is not None:
                    rid_ = req.rid
                    rehydrate = (
                        lambda nodes: self._rehydrate_nodes(nodes, rid_))
                self._spill_rid = str(req.rid)
                rt0 = self.stats.rehydrate_tokens
                path, matched = self._prefix_store.match_for_admission(
                    req.prompt, rehydrate=rehydrate)
                self._spill_rid = None
                self.stats.prefix_lookup_tokens += req.prompt.size
                self.stats.prefix_hit_tokens += matched
                # Rehydrated pages moved host -> device bytes: only the
                # resident share of the hit is zero-copy.
                self.stats.prefix_zero_copy_tokens += matched - (
                    self.stats.rehydrate_tokens - rt0)
            needed = self._blocks_needed(
                req.prompt.size, 0 if req.prefill_only else req.max_new_tokens)
            self._spill_rid = str(req.rid)
            owned = self._reserve_blocks(needed - len(path))
            self._spill_rid = None
            if owned is None:
                if path:
                    self._prefix_store.release(path)
                self.queue.appendleft(q)    # FIFO order is a fairness contract
                return
            row = self._tables[slot]
            row[:] = self._kv_pool_blocks
            row[:len(path)] = [n.block for n in path]
            row[len(path):needed] = owned
            self._slot_blocks[slot] = needed
            self._tables_dirty = True
            eos_val = -1 if req.eos_id is None else req.eos_id
            prefill = None
            if self.prefill_mode == "exact":
                # The whole prompt in one forward; the row is live at once
                # and decodes in the next dispatch.
                self._push_tables()
                self._note_moe_dispatch(req.prompt.size)
                t_p0 = self._tclock() if self._tracer is not None else 0.0
                row_logits, self.cache = gen.prefill_into_paged(
                    self.cfg, self.params,
                    _to_device(req.prompt[None], self.device), self.cache,
                    slot, **self._tp_kw)
                self.logits[slot] = row_logits[0]
                self.eos[slot] = eos_val
                self.budget[slot] = req.max_new_tokens
                self.emitted[slot] = 0
                if self._tracer is not None:
                    # One final chunk, so that the span names are those
                    # of both prefill modes.
                    self._tracer.add_span(
                        "prefill_chunk", t_p0, self._tclock(),
                        rid=str(req.rid), offset=0,
                        width=int(req.prompt.size), final=True)
            else:
                # Prefill starts at the matched offset: the matched pages
                # are already in the slot's table.
                prefill = _Prefill(tokens=req.prompt, next_off=matched,
                                   eos_val=eos_val,
                                   budget_val=req.max_new_tokens)
            self.slots[slot] = _Slot(
                req=req, submit_t=q.submit_t, admit_t=now,
                deadline_t=q.deadline_t, path=path, owned=owned,
                spec_k=self.draft_k,
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
            if self._tracer is not None:
                r = str(req.rid)
                self._tracer.add_span("queue_wait", q.submit_t, now, rid=r)
                self._tracer.add_event(
                    "admit", now, rid=r, slot=slot,
                    prefix_hit=int(matched), pages_reserved=int(needed))
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
            self._note_moe_dispatch(w_real)
            self._push_tables()
            t0 = self._tclock() if self._tracer is not None else 0.0
            # A prefill_only slot never activates: its row stays out of
            # decode dispatches while it parks export-ready.
            self._chunk(i, buf, off, w_real, p,
                        final and not slot.req.prefill_only)
            if self._tracer is not None:
                # Host time of scheduling the chunk (the launch is
                # asynchronous).
                self._tracer.add_span(
                    "prefill_chunk", t0, self._tclock(),
                    rid=str(slot.req.rid), offset=int(off), width=int(w),
                    final=bool(final))
            self.stats.prefill_chunks += 1
            p.next_off = off + w_real
            if final:
                if self._prefix_store is not None:
                    # Publish the prompt's full pages: blocks the trie
                    # lacks adopt this slot's pages in place, then the
                    # slot's pin extends over the whole chain. A block
                    # another slot published first stays this slot's
                    # duplicate until retirement.
                    owned_map = {
                        o: int(self._tables[i, o // bs])
                        for o in range(len(slot.path) * bs,
                                       (p.tokens.size // bs) * bs, bs)}
                    full, adopted = self._prefix_store.trie.insert_owned(
                        p.tokens, owned_map, known_path=slot.path)
                    for o in adopted:
                        slot.owned.remove(owned_map[o])
                    ext = full[len(slot.path):]
                    self._prefix_store.trie.acquire(ext)
                    slot.path = slot.path + ext
                slot.prefill = None
                if slot.req.prefill_only:
                    # Park export-ready with a copy of the prompt-final
                    # logits row: the engine's logits buffer takes
                    # in-place writes, and a view could ship a later
                    # step's row. Forks (n > 1) happen on the decode
                    # side, after migration.
                    slot.export_logits = self.logits[i].clone()
                    slot.export_ready = True
                elif slot.sp.n > 1:
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
        owned: List[int] = []
        for _ in range(src.needed - fp):
            bid = self._alloc_block()
            if bid is None:
                for b in owned:
                    self.pool.unref(b)
                return False
            owned.append(bid)
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
        if self._tracer is not None:
            self._tracer.add_event(
                "fork", self._tclock(), rid=str(src.req.rid), gen=g,
                slot=slot_idx, shared_pages=fp,
                cow_pages=int(src.boundary_bid is not None))
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

    # -- cross-engine migration (prefill/decode disaggregation) ---------------

    def _fleet_path(self, what: str) -> None:
        if self._mesh is not None:
            raise not_yet_ported(f"{what} under tensor parallelism")

    def _host_copy(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A host tensor of its own (pinned on a card engine, so that a
        later install copies it without stopping the host)."""
        if t is None:
            return None
        if self.device.type == "cuda":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t)
            return out
        return t.clone()

    def export_ready_rids(self) -> List[int]:
        """Rids parked export-ready (finished prefill_only requests)
        awaiting migration, read fresh from the slots. Cancelled or
        deadlined slots are left out: the next step's retirement
        surfaces their outcome."""
        now = self._clock()
        return [s.req.rid for s in self.slots
                if s is not None and s.export_ready and not s.cancelled
                and (s.deadline_t is None or now < s.deadline_t)]

    def _find_export(self, rid: int) -> Tuple[int, _Slot]:
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid == rid and s.export_ready:
                return i, s
        raise KeyError(f"rid {rid} is not export-ready on this engine")

    def migration_probe(self, prompt) -> Tuple[List, int]:
        """Receiver-side half of the zero-copy rule: match ``prompt``
        against this engine's trie and pin the matched chain. Returns
        ``(path, matched_tokens)``; the exporter then ships only the
        pages at offsets >= matched_tokens. The caller balances the pin
        with :meth:`admit_migrated` (which adopts it) or
        :meth:`release_probe` (an abandoned handoff)."""
        if self._prefix_store is None:
            return [], 0
        path = self._prefix_store.trie.match(np.asarray(prompt, np.int32))
        self._prefix_store.trie.acquire(path)
        return path, len(path) * self.block_size

    def release_probe(self, path) -> None:
        """Drop a :meth:`migration_probe` pin whose handoff was
        abandoned."""
        if self._prefix_store is not None and path:
            self._prefix_store.release(list(path))

    def export_request(self, rid: int,
                       skip_tokens: int = 0) -> MigrationPayload:
        """An export-ready request's state for migration: its pool pages
        but the first ``skip_tokens`` worth (the receiver's trie holds
        them, per :meth:`migration_probe`), gathered in one device
        ``index_select`` and copied to pinned host memory in one copy a
        part, plus the copied prefill-final logits row. The copies are
        enqueued, not waited for: the install on the receiver is ordered
        after them on the stream. Frees nothing: the slot stays parked
        until :meth:`finish_export`, so a failed install can export
        again. ``migration_bytes`` counts each shipped payload here."""
        self._fleet_path("migration")
        i, slot = self._find_export(rid)
        bs = self.block_size
        n_prompt = int(slot.req.prompt.size)
        if skip_tokens % bs or not (0 <= skip_tokens <= n_prompt):
            raise ValueError(
                f"rid {rid}: skip_tokens {skip_tokens} not a block "
                f"multiple within the prompt ({n_prompt} tokens)")
        t0 = self._tclock()
        nb = -(-n_prompt // bs)
        ship = list(range(skip_tokens // bs, nb))
        ids = [int(self._tables[i, b]) for b in ship]
        pk, pv, sk, sv = gen.export_pool_pages(self.cache, ids, wait=False)
        logits_row = slot.export_logits
        if logits_row.device.type == "cuda":
            host = torch.empty(logits_row.shape, dtype=logits_row.dtype,
                               pin_memory=True)
            host.copy_(logits_row, non_blocking=True)
            logits_row = host
        else:
            logits_row = logits_row.clone()
        nbytes = _parts_nbytes(pk, pv, sk, sv)
        self.stats.migration_bytes += nbytes
        now = self._tclock()
        if self._tracer is not None:
            self._tracer.add_span(
                "migrate_export", t0, now, rid=str(rid),
                pages=len(ids), bytes=nbytes, skip_tokens=int(skip_tokens))
        return MigrationPayload(
            rid=rid, prompt=slot.req.prompt,
            max_new_tokens=slot.req.max_new_tokens,
            eos_id=slot.req.eos_id,
            # The resolved sampling contract (the request's params or
            # this engine's defaults): the receiver decodes the stream a
            # single engine would have.
            params=slot.sp,
            submit_t=slot.submit_t, admit_t=slot.admit_t,
            deadline_t=slot.deadline_t, logits_row=logits_row,
            pages_k=pk, pages_v=pv, scales_k=sk, scales_v=sv,
            page_starts=[b * bs for b in ship], prompt_len=n_prompt,
            skip_tokens=int(skip_tokens), block_size=bs,
            kv_quant=self.kv_quant, nbytes=nbytes)

    def finish_export(self, rid: int) -> None:
        """Release an exported request's local tenancy once the receiver
        admitted it: pins, pages, table row, slot; no Completion (the
        request moved, and the receiver produces its outcome). The
        books close with ``submitted == finished + rejected +
        migrated_out``."""
        i, slot = self._find_export(rid)
        self._release_pins(slot)
        self._free_owned(slot)
        self._free_shared(slot)
        self._clear_table_row(i)
        self.slots[i] = None
        self._rids.discard(rid)
        self._rid_gens.pop(rid, None)
        self.stats.migrated_out += 1
        if self._tracer is not None:
            self._tracer.add_event("migrate_out", self._tclock(),
                                   rid=str(rid))

    def admit_migrated(self, payload: MigrationPayload, path=()) -> None:
        """Receiver-side install of a migrated prefill: reserve the
        request's whole prompt + budget span (the chain
        :meth:`migration_probe` pinned, plus fresh pages), install the
        shipped page bytes, and activate the slot from the payload's
        fp32 logits row (no cast), as a fork activates from its
        parent's. On any failure the probe pin is released here. Raises
        :class:`Rejected` when this engine cannot take the request now
        (no slot, no pages, draining, an injected refusal) and
        ``ValueError`` on a wire-format mismatch.

        Idempotent by rid while the request is live here: a re-send
        after a lost ACK is a success no-op (``migrate_dedups``). A
        ledger entry whose rid is no longer live is stale, and a fresh
        migration of that rid installs normally."""
        try:
            if payload.rid in self._install_log:
                if payload.rid in self._rids:
                    self.stats.migrate_dedups += 1
                    self.release_probe(path)
                    if self._tracer is not None:
                        self._tracer.add_event(
                            "migrate_dedup", self._tclock(),
                            rid=str(payload.rid),
                            attempt=int(payload.attempt))
                    return
                self._install_log.pop(payload.rid, None)
            if self._injector is not None:
                if self._injector.fires(
                        "engine", "engine.admit_migrated",
                        target=self._fault_target, rid=payload.rid,
                        kinds=("refuse_admit",)) is not None:
                    self.stats.faults_injected += 1
                    self.stats.rejected += 1
                    raise Rejected(payload.rid, "fault_injected")
            self._fleet_path("migration")
            bs = self.block_size
            if payload.block_size != bs:
                raise ValueError(
                    f"rid {payload.rid}: block_size "
                    f"{payload.block_size} != engine {bs}")
            if payload.kv_quant != self.kv_quant:
                raise ValueError(
                    f"rid {payload.rid}: kv_quant "
                    f"{payload.kv_quant!r} != engine {self.kv_quant!r}")
            if payload.logits_row.numel() != self.cfg.vocab_size:
                raise ValueError(
                    f"rid {payload.rid}: logits vocab "
                    f"{payload.logits_row.numel()} != model "
                    f"{self.cfg.vocab_size}")
            if payload.skip_tokens != len(path) * bs:
                raise ValueError(
                    f"rid {payload.rid}: payload skips "
                    f"{payload.skip_tokens} tokens but the probe path "
                    f"covers {len(path) * bs}")
            if payload.prompt_len + payload.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"rid {payload.rid}: prompt {payload.prompt_len} + "
                    f"{payload.max_new_tokens} new exceeds max_seq "
                    f"{self.max_seq}")
            if payload.rid in self._rids:
                raise ValueError(f"rid {payload.rid}: duplicate rid "
                                 "among queued/in-flight requests")
            if self._draining:
                raise Rejected(payload.rid, "draining")
            try:
                slot_idx = self.slots.index(None)
            except ValueError:
                raise Rejected(payload.rid, "no_slot") from None
            needed = self._blocks_needed(payload.prompt_len,
                                         payload.max_new_tokens)
            if needed > self._kv_pool_blocks:
                raise Rejected(payload.rid, "pool_too_small")
            self._spill_rid = str(payload.rid)
            owned = self._reserve_blocks(needed - len(path))
            self._spill_rid = None
            if owned is None:
                raise Rejected(payload.rid, "no_pages")
        except BaseException:
            self.release_probe(path)
            raise
        t0 = self._tclock()
        row = self._tables[slot_idx]
        row[:] = self._kv_pool_blocks
        row[:len(path)] = [n.block for n in path]
        row[len(path):needed] = owned
        self._slot_blocks[slot_idx] = needed
        self._tables_dirty = True
        # The shipped bytes land in the fresh pages covering
        # [skip_tokens, prompt_len), verbatim; pages before skip_tokens
        # came as pointers.
        dst_ids, sel = [], []
        for j, start in enumerate(payload.page_starts):
            if start >= payload.skip_tokens:
                dst_ids.append(int(row[start // bs]))
                sel.append(j)
        if dst_ids:
            parts = (payload.pages_k, payload.pages_v, payload.scales_k,
                     payload.scales_v)
            if len(sel) != len(payload.page_starts):
                parts = tuple(None if t is None else t[:, sel]
                              for t in parts)
            gen.install_pool_pages(self.cache, *parts, dst_ids)
        self.logits[slot_idx].copy_(payload.logits_row, non_blocking=True)
        self.eos[slot_idx] = -1 if payload.eos_id is None else payload.eos_id
        self.budget[slot_idx] = payload.max_new_tokens
        self.emitted[slot_idx] = 0
        self.cache.length[slot_idx] = payload.prompt_len
        self.cache.active[slot_idx] = True
        sp = (payload.params if payload.params is not None
              else self._default_params)
        req = Request(rid=payload.rid, prompt=payload.prompt,
                      max_new_tokens=payload.max_new_tokens,
                      eos_id=payload.eos_id, params=payload.params)
        slot = _Slot(
            req=req, submit_t=payload.submit_t, admit_t=payload.admit_t,
            deadline_t=payload.deadline_t, path=list(path),
            spec_k=self.draft_k, owned=owned, sp=sp, mask=sp.logit_mask,
            mask_state=(sp.logit_mask.init_state()
                        if sp.logit_mask is not None else None))
        self.slots[slot_idx] = slot
        self._set_slot_sampling(slot_idx, sp, 0)
        self._rids.add(payload.rid)
        if self._prefix_store is not None:
            # Publish the migrated prompt's full blocks to this trie, so
            # the next shared-prefix migration ships pointers.
            owned_map = {
                o: int(row[o // bs])
                for o in range(len(path) * bs,
                               (payload.prompt_len // bs) * bs, bs)}
            full, adopted = self._prefix_store.trie.insert_owned(
                payload.prompt, owned_map, known_path=list(path))
            for o in adopted:
                slot.owned.remove(owned_map[o])
            ext = full[len(path):]
            self._prefix_store.trie.acquire(ext)
            slot.path = list(path) + ext
        if sp.n > 1:
            # Forks materialize here, on the decode side.
            self._rid_gens[payload.rid] = sp.n
            self._capture_fork_source(slot_idx, slot)
        if not sp.is_greedy:
            self.stats.sampled_requests += 1
        self.stats.submitted += 1
        self.stats.admitted += 1
        self.stats.migrated_in += 1
        self.stats.pages_migrated += len(dst_ids)
        self.stats.migrated_zero_copy_tokens += payload.skip_tokens
        self._install_log[payload.rid] = int(payload.attempt)
        self._install_log.move_to_end(payload.rid)
        while len(self._install_log) > 4096:
            self._install_log.popitem(last=False)
        now = self._tclock()
        if self._tracer is not None:
            self._tracer.add_span(
                "migrate_install", t0, now, rid=str(payload.rid),
                slot=slot_idx, pages=len(dst_ids),
                zero_copy_tokens=int(payload.skip_tokens))

    # -- fleet prefix pulls (tiered KV) ------------------------------------------

    def _tiered_match(self, prompt) -> List[kv_blocks.RadixNode]:
        toks = np.asarray(prompt, np.int32).reshape(-1)
        trie = self._prefix_store.trie
        return (trie.match_tiered(toks) if self._host_tier is not None
                else trie.match(toks))

    def probe_prefix_len(self, prompt) -> int:
        """Tokens of ``prompt`` this engine holds in either tier (the
        device trie and the host spill): what the router weighs a pull
        against."""
        if self._prefix_store is None:
            return 0
        return len(self._tiered_match(prompt)) * self.block_size

    def export_prefix(self, prompt) -> Optional[PrefixPayload]:
        """Exporter-side half of a fleet prefix pull: the longest cached
        chain matching ``prompt``, resident pages through one
        :func:`generate.export_pool_pages` (waited for: the receiver
        reads the bytes on the host), spilled pages out of the host
        tier, in raw pool types. Nothing is pinned or freed: the
        payload is a snapshot copy."""
        if self._prefix_store is None:
            return None
        self._fleet_path("a fleet prefix pull")
        path = self._tiered_match(prompt)
        if not path:
            return None
        resident = [n for n in path if n.block >= 0]
        res = {}
        if resident:
            parts = gen.export_pool_pages(self.cache,
                                          [n.block for n in resident])
            res = {id(n): j for j, n in enumerate(resident)}
        pages = []
        for n in path:
            if n.block >= 0:
                j = res[id(n)]
                pages.append(tuple(None if t is None else t[:, j:j + 1]
                                   for t in parts))
            else:
                pages.append(self._host_tier.get(n.host_handle))

        def joined(part: int) -> Optional[torch.Tensor]:
            if pages[0][part] is None:
                return None
            return torch.cat([p[part] for p in pages], 1)

        pk, pv, sk, sv = (joined(k) for k in range(4))
        return PrefixPayload(
            chunks=[n.key for n in path], pages_k=pk, pages_v=pv,
            scales_k=sk, scales_v=sv, block_size=self.block_size,
            kv_quant=self.kv_quant, n_tokens=len(path) * self.block_size,
            nbytes=_parts_nbytes(pk, pv, sk, sv))

    def admit_prefix_to_tier(self, payload: PrefixPayload) -> int:
        """Receiver-side half of a fleet prefix pull: land the pulled
        pages in this engine's HOST tier as spilled trie nodes (no
        device work now; the next admission that hits the chain
        rehydrates it). Chunks this trie already holds are skipped.
        Returns the pages admitted."""
        if self._prefix_store is None or self._host_tier is None:
            return 0
        if payload.block_size != self.block_size:
            raise ValueError(
                f"prefix pull: block_size {payload.block_size} != "
                f"engine {self.block_size}")
        if payload.kv_quant != self.kv_quant:
            raise ValueError(
                f"prefix pull: kv_quant {payload.kv_quant!r} != "
                f"engine {self.kv_quant!r}")
        tier = self._host_tier
        trie = self._prefix_store.trie
        node = trie.root
        admitted = 0
        for j, key in enumerate(payload.chunks):
            child = node.children.get(key)
            if child is not None and (
                    child.block >= 0 or tier.has(child.host_handle)):
                node = child      # already held here: a pointer, no copy
                continue
            page = tuple(
                None if t is None else self._host_copy(t[:, j:j + 1])
                for t in (payload.pages_k, payload.pages_v,
                          payload.scales_k, payload.scales_v))
            h = tier.put(page)
            if h is None:
                break             # the tier is too small for one page
            if child is None:
                child = kv_blocks.RadixNode(
                    key=key, block=-1, parent=node, host_handle=h)
                node.children[key] = child
            else:
                child.host_handle = h    # revive a dead spilled handle
            admitted += 1
            node = child
        return admitted

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return (not self.queue and self.n_active == 0
                and self._pending is None and not self._done_buf
                and not self._fork_sources)

    def _fault_step_skip(self) -> bool:
        """Injected hang or slow: True when this quantum makes no
        progress. The early return in :meth:`step` comes before
        ``_sync_stats``, so ``stats.heartbeat`` freezes: the signal the
        router's progress watchdog strikes on. ``hang`` skips every
        quantum of its window; ``slow`` lets one quantum in ``factor``
        through."""
        if self._injector is None:
            return False
        spec = self._injector.fires(
            "engine", "engine.step", target=self._fault_target,
            kinds=("hang", "slow"))
        if spec is None:
            return False
        self.stats.faults_injected += 1
        if spec.kind == "hang":
            return True
        self._slow_phase += 1
        return self._slow_phase % max(1, int(spec.factor)) != 0

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
        :meth:`_step_spec`. An injected hang or slow quantum returns
        nothing and does nothing."""
        if self._fault_step_skip():
            return []
        if self._masked_decoding():
            return self._step_constrained()
        if self.spec_decode:
            return self._step_spec()
        tr = self._tracer
        t_q0 = self._tclock() if tr is not None else 0.0
        finished: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        finished.extend(self._retire_due())
        snapshot = self._decoding_snapshot()
        n_decoding = sum(s is not None for s in snapshot)
        dispatched = self._dispatch_plain(snapshot, span=True)
        finished.extend(self._process_pending())
        self._pending = dispatched
        self._admit_waiting()
        self._advance_prefills()
        if tr is not None:
            tr.add_span("decode_quantum", t_q0, self._tclock(),
                        slots=n_decoding, finished=len(finished))
        self._sync_stats()
        return finished

    def _decoding_snapshot(self) -> List[Optional[_Slot]]:
        """The slots past prefill. A mid-prefill or export-parked slot's
        device row is inactive, and snapshotting it as None keeps its
        chunk garbage out of the books."""
        return [s if (s is not None and s.prefill is None
                      and not s.export_ready) else None
                for s in self.slots]

    def _note_moe_dispatch(self, n_tokens: int) -> None:
        """Count expert routings as the reference does: every token a
        dispatched forward carries routes to ``top_k`` experts (once a
        forward, not once a layer). No-op for a dense model."""
        if self.cfg.moe_experts:
            self.stats.moe_tokens_dispatched += (
                int(n_tokens) * self.cfg.moe_top_k)

    def _dispatch_plain(self, snapshot, span: bool = False):
        """Dispatch the pipelined plain chunk when any slot decodes — the
        sampled twin when a decoding row samples, else the greedy chunk:
        the ``(token fetch, snapshot)`` to book next quantum, or None.
        ``span`` records the ``dispatch`` span where the JAX engine
        does."""
        n_decoding = sum(s is not None for s in snapshot)
        if not n_decoding:
            return None
        self._push_tables()
        tr = self._tracer if span else None
        t_d0 = self._tclock() if tr is not None else 0.0
        self._note_moe_dispatch(self.n_active * self.decode_chunk)
        sampled = self._sampled_in(snapshot)
        chunk = self._decode_chunk_sampled if sampled else self._decode_chunk
        out = _Fetch(chunk(self._view_width())), snapshot
        if tr is not None:
            tr.add_span("dispatch", t_d0, self._tclock(), slots=n_decoding,
                        sampled=sampled)
        return out

    def _step_constrained(self) -> List[Completion]:
        """One quantum while a decoding slot carries a grammar mask. The
        automaton must see token i before it can admit token i+1, so the
        quantum books the pipelined chunk still in flight, then
        dispatches ONE masked micro-step and books it at once. Unmasked
        rows ride along under all-True mask rows; since draws are keyed
        by (seed, gen, position), their streams do not change with the
        kind of quantum. A masked slot whose grammar admits nothing (and
        that has no EOS to carry the end) retires as an EOS finish."""
        tr = self._tracer
        t_q0 = self._tclock() if tr is not None else 0.0
        finished: List[Completion] = list(self._done_buf)
        self._done_buf.clear()
        finished.extend(self._retire_due())
        finished.extend(self._process_pending())  # booking order = stream order
        snapshot = self._decoding_snapshot()
        vocab = self.cfg.vocab_size
        mask = np.ones((self.n_slots, vocab), bool)
        n_masked = 0
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
            n_masked += 1
        n_decoding = sum(s is not None for s in snapshot)
        if n_decoding:
            self._push_tables()
            self._note_moe_dispatch(self.n_active)
            t_d0 = self._tclock() if tr is not None else 0.0
            sampled = self._sampled_in(snapshot)
            toks = _Fetch(self._masked_step(
                self._view_width(), mask, sampled > 0)).numpy()
            if tr is not None:
                tr.add_span("sample", t_d0, self._tclock(),
                            slots=n_decoding, masked=n_masked,
                            sampled=sampled)
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
                    self._record_completion(comp)
                    finished.append(comp)
        self._admit_waiting()
        self._advance_prefills()
        if tr is not None:
            tr.add_span("decode_quantum", t_q0, self._tclock(),
                        slots=n_decoding, constrained=True,
                        finished=len(finished))
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
        tr = self._tracer
        t_q0 = self._tclock() if tr is not None else 0.0
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
            dispatched = self._dispatch_plain(snapshot, span=True)
            finished.extend(self._process_pending())
            self._pending = dispatched
            self._admit_waiting()
            self._advance_prefills()
            if tr is not None:
                tr.add_span("decode_quantum", t_q0, self._tclock(),
                            spec=False, finished=len(finished))
            self._sync_stats()
            return finished
        finished.extend(self._process_pending())
        snapshot = self._decoding_snapshot()
        if any(s is not None for s in snapshot):
            self.stats.spec_probe_steps += 1
            t_p0 = self._tclock() if tr is not None else 0.0
            proposal = self._propose_drafts(snapshot)
            if tr is not None:
                tr.add_span("spec_probe", t_p0, self._tclock(),
                            drafted=proposal is not None)
            if proposal is not None:
                draft, dlen = proposal
                self._push_tables()
                self._note_moe_dispatch(self.n_active * (self.draft_k + 1))
                t_v0 = self._tclock() if tr is not None else 0.0
                out = _Fetch(self._verify(
                    self._view_width(), draft, dlen,
                    sampled=self._sampled_in(snapshot) > 0)).numpy()
                if tr is not None:
                    tr.add_span("spec_verify", t_v0, self._tclock(),
                                draft_tokens=int(np.sum(dlen)))
                k1 = draft.shape[1] + 1
                finished.extend(self._book_spec(
                    snapshot, out[:, :k1], out[:, k1], out[:, k1 + 1], dlen))
            else:
                self._pending = self._dispatch_plain(snapshot)
        self._admit_waiting()
        self._advance_prefills()
        if tr is not None:
            tr.add_span("decode_quantum", t_q0, self._tclock(),
                        spec=True, finished=len(finished))
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
            self._record_completion(c)
        return finished

    def _traffic_model(self, phase: str = "decode") -> Tuple[float, float]:
        """The reference engine's analytic traffic for one attention
        ``phase``, per tp rank: ``(hbm_bytes_per_step,
        flops_per_token_per_shard)``.

        * Weights: every projection is read once a step, one byte an
          element under weight-only int8, else the compute dtype's size.
          Under ``tp_compute="parallel"`` the column- and row-parallel
          weights are read as this rank's chunks (1 / tp of them); under
          ``"gathered"`` whole. The head is counted whole.
        * KV: the view width's span of pool pages that the phase's query
          rows attend (every slot for decode and verify, one row for a
          prefill chunk), this rank's heads, read once by the kernels
          and three times by the gather path (pool read, view write,
          view read), as ``attn_impl`` says.
        * FLOPs a token: 2 a weight element, plus the two attention
          products over the view width on this rank's heads.
        * MoE: the experts a step can touch take the dense FFN's place,
          ``min(E, n_slots * top_k)`` on one device and the ``E / tp``
          resident on a rank under tp, plus the fp32 router; a token
          computes its ``top_k`` experts and the router.

        Both are models, not counters. On the card the eager dequant of
        int8 weights writes a compute-dtype copy of each weight first,
        which this model (the reference's, where XLA fuses the dequant
        into the matmul) does not count."""
        cfg = self.cfg
        tp = self.tp
        hd = cfg.head_dim
        L = cfg.n_layers
        weight_bytes, local_params, ffn_flops = self._weights_model()
        vw = self._last_vw or self._view_width()
        kv_factor = 1 if self.attn_impl == "kernel" else 3
        kv_rows = 1 if phase == "prefill" else self.n_slots
        kv_bytes = (kv_factor * kv_rows * vw
                    * kv_blocks.kv_bytes_per_token(cfg, self.kv_quant, tp))
        flops = (2.0 * local_params + ffn_flops
                 + 4.0 * vw * (cfg.n_heads // tp) * hd * L)
        return weight_bytes + kv_bytes, flops

    def _weights_model(self) -> Tuple[float, float, float]:
        """The weight half of :meth:`_traffic_model`: ``(weight bytes a
        step reads on a rank, the dense parameters a token multiplies,
        the MoE FFN's FLOPs a token)``."""
        cfg = self.cfg
        tp = self.tp
        L = cfg.n_layers
        div = tp if self.tp_compute == "parallel" and tp > 1 else 1
        per_elem = (1 if self._w_quant == "int8"
                    else torch.empty((), dtype=cfg.dtype).element_size())
        attn_params = (cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                       * cfg.head_dim)
        head_params = cfg.d_model * cfg.vocab_size
        ffn_each = 3 * cfg.d_model * cfg.d_ff
        if not cfg.moe_experts:
            local_params = L * (attn_params + ffn_each) / div + head_params
            return local_params * per_elem, local_params, 0.0
        local_params = L * attn_params / div + head_params
        e_resident = (cfg.moe_experts // tp if tp > 1 else
                      min(cfg.moe_experts, self.n_slots * cfg.moe_top_k))
        weight_bytes = ((local_params + L * e_resident * ffn_each) * per_elem
                        + L * cfg.d_model * cfg.moe_experts * 4)
        ffn_flops = L * (2.0 * cfg.moe_top_k * ffn_each
                         + 2.0 * cfg.d_model * cfg.moe_experts)
        return weight_bytes, local_params, ffn_flops

    def _sync_stats(self) -> None:
        self.stats.heartbeat += 1
        self.stats.pool_blocks_total = self.pool.n_blocks
        self.stats.pool_blocks_in_use = self.pool.used_blocks
        self.stats.pool_blocks_resident = self.pool.used_blocks
        self.stats.kv_bytes_per_token = kv_blocks.kv_bytes_per_token(
            self.cfg, self.kv_quant)
        # A rank's pool holds every page at 1 / tp of its bytes.
        self.stats.tp = self.tp
        self.stats.pool_blocks_per_shard = self.pool.n_blocks
        self.stats.kv_hbm_per_device_mb = (
            self.pool.n_blocks * self.block_size
            * kv_blocks.kv_bytes_per_token(self.cfg, self.kv_quant, self.tp)
            / (1 << 20))
        phase_bytes = {}
        for phase in ("prefill", "decode", "verify"):
            phase_bytes[phase], flops = self._traffic_model(phase)
        self.stats.hbm_bytes_per_step = phase_bytes["decode"]
        self.stats.hbm_bytes_per_step_prefill = phase_bytes["prefill"]
        self.stats.hbm_bytes_per_step_decode = phase_bytes["decode"]
        self.stats.hbm_bytes_per_step_verify = phase_bytes["verify"]
        self.stats.flops_per_token_per_shard = flops
        self.stats.moe_experts_per_shard = self.cfg.moe_experts // self.tp
        self.stats.host_pages_resident = (
            self._host_tier.resident_pages
            if self._host_tier is not None else 0)
        if self._tracer is not None:
            self.stats.spans_recorded = self._tracer.spans_recorded
            self.stats.spans_dropped = self._tracer.spans_dropped
        reg = registry()
        reg.gauge("queue_depth", "serving").set(len(self.queue))
        reg.gauge("pool_blocks_in_use", "serving").set(self.pool.used_blocks)
        reg.gauge("active_slots", "serving").set(self.n_active)
        for name in ("pages_migrated", "migration_bytes",
                     "migrated_zero_copy_tokens",
                     "spilled_pages", "spill_bytes", "rehydrate_hits",
                     "rehydrate_tokens", "host_pages_resident",
                     "moe_experts_per_shard", "moe_tokens_dispatched"):
            reg.gauge(name, "serving").set(getattr(self.stats, name))

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
        if self._prefix_store is not None and not slot.shared:
            # The reply joins the trie too (every committed token's KV is
            # in the slot's pages, and the row is inactive on the device),
            # so a follow-up turn reuses reply blocks. Fork children never
            # publish: their rows name pages the parent owns.
            full = np.concatenate([req.prompt,
                                   np.asarray(slot.tokens, np.int32)])
            bs = self.block_size
            owned_map = {
                o: int(self._tables[i, o // bs])
                for o in range(len(slot.path) * bs, (full.size // bs) * bs,
                               bs)}
            _, adopted = self._prefix_store.trie.insert_owned(
                full, owned_map, known_path=slot.path)
            for o in adopted:
                slot.owned.remove(owned_map[o])
        self._release_pins(slot)
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
        t_g0 = self._tclock() if self._tracer is not None else 0.0
        toks_np = fetch.numpy()                       # [chunk (+1), B]
        if self._tracer is not None:
            # This read waits for the previous dispatch: its span is the
            # visible device time of that chunk.
            self._tracer.add_span(
                "device_get", t_g0, self._tclock(),
                chunk=int(toks_np.shape[0]) - (1 if self.spec_decode else 0))
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
            self._record_completion(c)
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
            self._record_completion(comp)
            out.append(comp)
        deadline = now + grace_s
        while not self.idle and self._clock() < deadline:
            if (not self.queue and self._pending is None
                    and not self._fork_sources
                    and all(s is None or s.export_ready
                            for s in self.slots)):
                # Only export-parked prefills remain, and stepping never
                # finishes them (their rows are inactive).
                break
            out.extend(self.step())
        # Grace exhausted: book the chunk still in flight (those tokens
        # were decoded — keep them), then force-retire stragglers. An
        # export-parked prefill_only slot retires as "shed": no token was
        # lost, and the router re-dispatches sheds.
        out.extend(self._process_pending())
        now = self._clock()
        for i, slot in enumerate(self.slots):
            if slot is not None:
                reason = "shed" if slot.req.prefill_only else "deadline"
                out.append(self._retire_slot(i, slot, reason, now))
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
        close it, and flush the trace; idempotent, and called from every
        exit path (drain, a run() overrun)."""
        if self._metrics is not None:
            scalars = self.stats.summary()
            scalars.update(extra)
            self._metrics.write(self.stats.steps, scalars)
            self._metrics.close()
            self._metrics = None
        if self._tracer is not None:
            self._tracer.flush()

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
            if stop is not None and self.agreed_flag(stop.is_set()):
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
