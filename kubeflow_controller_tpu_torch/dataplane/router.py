"""Fleet router: prefix-affinity dispatch over N serving-engine replicas.

Counterpart of ``kubeflow_controller_tpu/dataplane/router.py``, with the
same names, decisions, counters and summary keys. One
:class:`~serving_engine.ServingEngine` is one replica's decode pool; a
fleet runs N of them (on one card they share one set of weight
tensors, each with its own KV pool), and something has to decide which
replica each request lands on. Random
spreading is load-fair but cache-hostile: the radix prefix cache
(docs/serving.md) only pays when requests sharing a system prompt land
on the replica that already holds those blocks. This router makes that
placement decision and owns the fleet-level robustness contract:

* **prefix affinity** — the prompt's longest block-aligned prefix is
  looked up in an LRU owner map (prefix bytes -> replica). A hit routes
  to the owning replica, so same-system-prompt traffic converges on the
  replica whose trie holds those pages; a cold prefix falls back to the
  least-loaded routable replica and RECORDS ownership for every prefix
  length of the prompt, so the next request sharing any of them sticks.
* **retry with capped jittered backoff** — a replica-level
  :class:`~serving_engine.Rejected` (queue full, draining) retries on a
  DIFFERENT replica immediately; when every routable replica refuses,
  the request parks and retries after :func:`backoff_delay` (the
  capped-exponential + deterministic-jitter curve of the controller's
  workqueue, imported from ``controller/workqueue.py``). After ``max_retries`` parks the fleet
  itself sheds the request — a typed rejection, not an infinite queue.
* **accounting** — every submitted request ends in EXACTLY ONE of
  {completed, rejected, cancelled} (``outcome(rid)``), at most once per
  rid: a late duplicate completion (a re-dispatched request whose first
  replica somehow finished it too) is counted and dropped, never
  surfaced twice. Nothing is silently dropped — the conservation law
  ``submitted == completed + rejected + cancelled`` holds whenever the
  fleet is idle, and the tests assert it under chaos.
* **health** — per-replica eject/re-admit hysteresis driven by the
  engine's own metrics (queue depth, recent TTFT tail vs the service
  SLO). An ejected replica takes no new work but keeps stepping so its
  in-flight requests finish; it re-admits once the signals clear.
* **chaos kill** — :meth:`kill` models a replica dying WITHOUT drain
  (SIGKILL, preemption): every rid assigned there that has no outcome
  yet re-dispatches to a surviving replica. Its stats fold into the
  fleet aggregate so prefix-hit accounting survives the body.
* **rolling restart** — :meth:`rolling_restart` cordons ONE replica
  (no new dispatches), ``drain(grace_s)``s it (in-flight requests
  finish inside the grace budget; queued ones come back ``"shed"``),
  re-dispatches the sheds to the rest of the fleet, and only then
  swaps in the replacement engine and uncordons. Zero dropped requests
  across a full-fleet rollout is the acceptance test, not a hope.

The router is deliberately single-threaded and clock-driven (share
``clock`` with the engines for simulated time): `step()` is the only
place completions surface and retries fire, which is what makes the
accounting assertions exact.

Over a tensor-parallel gang (one process a tp rank, each running this
router over its own rank's engines) every rank must take the same
decisions in the same order, or the ranks' next collectives pair up
wrongly: ``clock`` is then a :class:`~..serving_engine.AgreedClock`
(rank 0's reading at every read; rank 0's tracer stamps spans from its
``local`` clock). One thread steps the replicas in registration order,
so their collectives are issued in the same order on every rank.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from kubeflow_controller_tpu_torch.controller.workqueue import backoff_delay
from kubeflow_controller_tpu_torch.dataplane.metrics import percentile
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Completion, Rejected, Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.obs.telemetry import registry

#: terminal outcome kinds — every submitted rid ends in exactly one.
OUTCOMES = ("completed", "rejected", "cancelled")


def _fnv(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


#: replica roles for prefill/decode disaggregation. "mixed" (the
#: default) serves requests end-to-end — a fleet of all-mixed replicas
#: behaves exactly as before this field existed. When the fleet holds
#: BOTH a "prefill" and a "decode" replica, the router goes two-stage:
#: fresh requests dispatch to prefill/mixed replicas only (prefix
#: affinity preserved), prefill-role replicas run prefill_only
#: admissions, and finished prefills migrate to decode/mixed replicas
#: by KV-page transfer (docs/serving.md).
ROLES = ("prefill", "decode", "mixed")


@dataclass
class ReplicaHandle:
    """One replica as the router sees it. ``healthy``/``cordoned`` gate
    NEW dispatches only — an unhealthy or cordoned replica still steps,
    so its in-flight work finishes rather than being abandoned."""

    name: str
    engine: ServingEngine
    role: str = "mixed"
    healthy: bool = True
    cordoned: bool = False
    strikes: int = 0        # consecutive bad health checks
    clears: int = 0         # consecutive good checks while ejected
    ttft_seen: int = 0      # stats.ttfts_s high-water (windowed checks)
    hb_seen: int = -1       # stats.heartbeat high-water (watchdog)
    hb_t: float = 0.0       # clock when heartbeat last advanced
    watchdog_hit: bool = False  # last strike came from the watchdog

    @property
    def routable(self) -> bool:
        return self.healthy and not self.cordoned

    @property
    def load(self) -> int:
        return len(self.engine.queue) + self.engine.n_active

    @property
    def free_slots(self) -> int:
        return self.engine.n_slots - self.engine.n_active

    @property
    def free_pages(self) -> int:
        pool = self.engine.pool
        return pool.n_blocks - pool.used_blocks


@dataclass
class _Parked:
    due_t: float
    rid: int
    attempt: int


class FleetRouter:
    def __init__(
        self,
        clock: Callable[[], float],
        block_size: int = 4,
        affinity: bool = True,
        max_retries: int = 4,
        retry_base_s: float = 0.05,
        retry_max_s: float = 2.0,
        owner_map_cap: int = 4096,
        eject_queue_depth: Optional[int] = None,
        ttft_slo_ms: Optional[float] = None,
        eject_after: int = 2,
        readmit_after: int = 2,
        ttft_window: int = 16,
        prefix_pull: Optional[bool] = None,
        tracer=None,
        injector=None,
        watchdog_stale_s: Optional[float] = None,
    ):
        self._clock = clock
        # The clock span times are read from. Over a tp gang's engines
        # ``clock`` is an AgreedClock, a collective every rank reads
        # alike, and only rank 0 traces: its spans read this rank's own
        # clock, never the agreed one.
        self._tclock = getattr(clock, "local", clock)
        # Optional obs.Tracer: dispatch/failover/park/outcome spans on
        # the "router" track, keyed by rid — the same rid string the
        # engines use, so a fleet request's hops stitch into one trace
        # (share ONE tracer between the router and its engines).
        self._tracer = tracer
        self.block_size = int(block_size)
        # affinity=False is the random-dispatch baseline: deterministic
        # pseudo-random by rid, no owner map; same code path, placement
        # policy isolated.
        self.affinity = affinity
        self.max_retries = max_retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.eject_queue_depth = eject_queue_depth
        self.ttft_slo_ms = ttft_slo_ms
        self.eject_after = eject_after
        self.readmit_after = readmit_after
        self.ttft_window = ttft_window
        # Fleet-global prefix pooling (docs/serving.md "Tiered KV"):
        # when a request routes to a replica that does NOT own its
        # prefix, pull the owner's cached pages into the receiver's
        # host tier before submit — the admission then rehydrates them
        # locally instead of re-prefilling. None = auto: on iff the
        # receiving replica runs a host tier (needs affinity's owner
        # map either way).
        self.prefix_pull = prefix_pull
        # Fault injection (docs/chaos.md). None = off and byte-identical
        # to today; share ONE injector (and clock) with the engines so
        # a plan's activation windows line up across planes.
        self._injector = injector
        # Progress watchdog: a replica that is BUSY (active slots or a
        # queue) but whose quantum heartbeat has not advanced for this
        # many seconds strikes as unhealthy. None = off (default). This
        # is the hang detector the TTFT hysteresis cannot be: TTFT
        # samples only on COMPLETION, so a wedged replica that finishes
        # nothing never trips the latency signal.
        self.watchdog_stale_s = watchdog_stale_s

        self._replicas: "OrderedDict[str, ReplicaHandle]" = OrderedDict()
        # prefix bytes -> owning replica name, LRU-bounded. Entries may
        # go stale (owner killed); _route checks routability and falls
        # back, and the fallback re-records ownership.
        self._owners: "OrderedDict[bytes, str]" = OrderedDict()
        self._owner_map_cap = owner_map_cap
        self._requests: Dict[int, Request] = {}     # live (no outcome yet)
        self._assigned: Dict[int, str] = {}         # rid -> replica name
        self._outcomes: Dict[int, Tuple[str, object]] = {}
        self._parked: List[_Parked] = []
        # Deadline budget, fleet-side: rid -> router submit time and
        # absolute deadline on the router clock. The budget spans the
        # request's WHOLE fleet lifetime — parked retries and the
        # prefill->decode hop included — so a request cannot burn
        # backoff past its own deadline.
        self._submit_t: Dict[int, float] = {}
        self._deadline_t: Dict[int, float] = {}
        # Migration-hop retry state: rid -> attempt ordinal (stamped on
        # the payload so installs are attributable) and rid -> receiver
        # the un-ACKed install landed on (a re-send after a lost ACK
        # MUST return to the same receiver, where the install ledger
        # dedupes it — a different receiver would double-install).
        self._migr_attempts: Dict[int, int] = {}
        self._migr_sticky: Dict[int, str] = {}
        self.completions: List[Completion] = []
        # rid -> delivered generation ids, for n>1 requests: every gen's
        # Completion delivers (dedup key is (rid, gen)), and the rid's
        # single terminal outcome records only when the LAST gen lands.
        self._gens_done: Dict[int, set] = {}

        # Fleet counters (see docstring accounting contract).
        self.submitted = 0
        self.retries = 0
        self.redispatched = 0
        self.duplicate_completions = 0
        self.ejections = 0
        self.readmissions = 0
        self.affinity_hits = 0
        # Completed prefill->decode handoffs (two-stage fleets).
        self.migrations = 0
        # Fleet prefix pulls (tiered KV): cross-replica prefix copies
        # landed in a receiver's host tier, and their page/byte volume.
        self.prefix_pulls = 0
        self.prefix_pull_pages = 0
        self.prefix_pull_bytes = 0
        # Hang/timeout hardening counters.
        self.watchdog_strikes = 0
        self.dispatch_timeouts = 0
        self.migration_timeouts = 0
        self.deadline_sheds = 0
        # Prefix + speculative-decoding + migration accounting folded in
        # from killed/replaced engines so fleet rates and counters
        # survive chaos AND rolling restarts (every engine passes
        # through _fold_stats before the router lets go of it).
        self._retired_hit_tokens = 0
        self._retired_lookup_tokens = 0
        self._retired_draft_proposed = 0
        self._retired_draft_accepted = 0
        self._retired_pages_migrated = 0
        self._retired_migration_bytes = 0
        self._retired_migrated_zero_copy = 0
        self._retired_samples_dropped = 0
        self._retired_spilled_pages = 0
        self._retired_spill_bytes = 0
        self._retired_rehydrate_hits = 0
        self._retired_rehydrate_tokens = 0
        self._retired_faults_injected = 0
        self._retired_migrate_dedups = 0

    # -- fleet membership --------------------------------------------------

    @property
    def replicas(self) -> List[ReplicaHandle]:
        return list(self._replicas.values())

    def get_replica(self, name: str) -> Optional[ReplicaHandle]:
        return self._replicas.get(name)

    def add_replica(self, name: str, engine: ServingEngine,
                    role: str = "mixed") -> ReplicaHandle:
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already registered")
        if role not in ROLES:
            raise ValueError(f"replica {name!r}: role must be one of "
                             f"{ROLES} (got {role!r})")
        if role == "prefill" and engine.prefill_mode != "bucketed":
            # prefill_only admissions require the chunked path (the
            # engine rejects them at submit otherwise) — catch the
            # misconfiguration at membership time, not per request.
            raise ValueError(
                f"replica {name!r}: prefill role requires "
                "prefill_mode='bucketed'")
        h = ReplicaHandle(name=name, engine=engine, role=role)
        # Fault specs scope by replica name; stamp it so the engine's
        # own injector checks (step/submit/tier) match this replica.
        # Guarded: test fakes need not grow the attribute.
        if hasattr(engine, "fault_target"):
            engine.fault_target = name
        self._replicas[name] = h
        return h

    @property
    def two_stage(self) -> bool:
        """True while the fleet holds BOTH a prefill- and a decode-role
        replica — the condition for disaggregated scheduling. Degenerate
        fleets (chaos killed every decode replica) fall back to
        single-stage dispatch: serving beats starving."""
        roles = {h.role for h in self._replicas.values()}
        return "prefill" in roles and "decode" in roles

    def kill(self, name: str) -> List[int]:
        """Chaos: the replica dies with NO drain (SIGKILL/preemption).
        Every rid assigned to it without an outcome re-dispatches to the
        surviving fleet (the decoded-so-far tokens are lost with the
        pod — the request restarts; at-most-once on COMPLETION is the
        contract, not exactly-once on decode work). Returns the
        re-dispatched rids."""
        h = self._replicas.pop(name, None)
        if h is None:
            return []
        self._fold_stats(h.engine)
        victims = sorted(
            rid for rid, n in self._assigned.items() if n == name)
        moved = []
        for rid in victims:
            del self._assigned[rid]
            if rid in self._outcomes:
                continue
            self.redispatched += 1
            self._dispatch(rid, attempt=0, exclude=frozenset((name,)))
            moved.append(rid)
        return moved

    def rolling_restart(
        self,
        engine_factory: Callable[[str], ServingEngine],
        grace_s: float = 5.0,
    ) -> None:
        """Replace every replica's engine, one at a time, dropping
        nothing: cordon (new traffic routes around it), drain within
        ``grace_s`` (in-flight finishes; queued comes back ``"shed"``),
        re-dispatch the sheds to the rest of the fleet, then install the
        factory's fresh engine and uncordon. One replica is out at any
        moment — the fleet serves throughout."""
        for name in list(self._replicas):
            h = self._replicas[name]
            h.cordoned = True
            comps = h.engine.drain(grace_s)
            for c in comps:
                if c.rid in self._outcomes:
                    self.duplicate_completions += 1
                    continue
                self._assigned.pop(c.rid, None)
                if c.finish_reason == "shed":
                    # Never reached a slot here — another replica can
                    # still serve it in full.
                    self.redispatched += 1
                    self._dispatch(c.rid, attempt=0,
                                   exclude=frozenset((name,)))
                else:
                    self._complete(c)
            self._fold_stats(h.engine)
            h.engine = engine_factory(name)
            h.cordoned = False
            h.healthy = True
            h.strikes = h.clears = h.ttft_seen = 0
            h.hb_seen = -1
            h.hb_t = 0.0
            if hasattr(h.engine, "fault_target"):
                h.engine.fault_target = name

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Accept a request into the fleet. From here the router owns it
        until it reaches a terminal outcome — including across replica
        rejections, kills, and restarts."""
        if req.rid in self._requests or req.rid in self._outcomes:
            raise ValueError(f"request {req.rid}: duplicate rid")
        self._requests[req.rid] = req
        self.submitted += 1
        now = self._clock()
        self._submit_t[req.rid] = now
        if req.deadline_s is not None:
            # Deadline budget pinned at FLEET intake: retries, parking,
            # and the prefill->decode hop all spend from this one
            # budget (engines additionally enforce their local share).
            self._deadline_t[req.rid] = now + req.deadline_s
        self._dispatch(req.rid, attempt=0, exclude=frozenset())

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request currently lives: parked retries
        resolve immediately; queued/in-flight ones cancel inside their
        replica and surface at the next step. False if already
        terminal."""
        if rid in self._outcomes or rid not in self._requests:
            return False
        name = self._assigned.get(rid)
        if name is not None:
            return self._replicas[name].engine.cancel(rid)
        self._parked = [p for p in self._parked if p.rid != rid]
        self._finish(rid, "cancelled", None)
        return True

    # -- dispatch ----------------------------------------------------------

    def _prefix_keys(self, prompt: np.ndarray) -> List[bytes]:
        """Block-aligned prefixes, shortest -> longest, as hashable
        bytes. Matches the radix trie's block granularity so "owns the
        prefix" and "holds the blocks" agree."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        bs = self.block_size
        n = (toks.size // bs) * bs
        return [toks[:end].tobytes() for end in range(bs, n + 1, bs)]

    def _route(self, req: Request,
               excluded: FrozenSet[str]) -> Optional[ReplicaHandle]:
        # Two-stage fleets dispatch fresh requests to prefill/mixed
        # replicas only; decode-role replicas receive work exclusively
        # through migration (_run_migrations), placed by slot/page
        # headroom rather than affinity.
        two = self.two_stage
        usable = [h for h in self._replicas.values()
                  if h.routable and h.name not in excluded
                  and not (two and h.role == "decode")]
        if not usable:
            return None
        if not self.affinity:
            return usable[_fnv(str(req.rid).encode()) % len(usable)]
        for key in reversed(self._prefix_keys(req.prompt)):
            owner = self._owners.get(key)
            if owner is None:
                continue
            self._owners.move_to_end(key)
            h = self._replicas.get(owner)
            if h is not None and h.routable and owner not in excluded:
                self.affinity_hits += 1
                return h
        return min(usable, key=lambda h: (h.load, h.name))

    def _record_owner(self, req: Request, name: str) -> None:
        if not self.affinity:
            return
        for key in self._prefix_keys(req.prompt):
            self._owners[key] = name
            self._owners.move_to_end(key)
        while len(self._owners) > self._owner_map_cap:
            self._owners.popitem(last=False)

    def _dispatch(self, rid: int, attempt: int,
                  exclude: FrozenSet[str]) -> None:
        req = self._requests.get(rid)
        if req is None or rid in self._outcomes:
            return
        dl = self._deadline_t.get(rid)
        if dl is not None and self._clock() >= dl:
            # Past deadline before reaching any replica (parked through
            # it, or a failover storm ate the budget) — shed NOW as a
            # typed deadline completion instead of burning a slot on
            # work nobody is waiting for.
            self._shed_deadline(rid)
            return
        tried = set(exclude)
        tr = self._tracer
        t0 = self._tclock() if tr is not None else 0.0
        while True:
            h = self._route(req, frozenset(tried))
            if h is None:
                self._park_or_shed(rid, attempt)
                return
            # Per-dispatch, not per-request: a re-dispatch (failover,
            # restart shed) may land on a mixed replica, which serves
            # it end-to-end.
            req.prefill_only = self.two_stage and h.role == "prefill"
            if self._injector is not None and self._injector.fires(
                    "router", "router.dispatch", target=h.name,
                    rid=rid, kinds=("hang",)) is not None:
                # Submit RPC timed out (injected): deadline-aware
                # failover — count it, skip this replica, try the rest
                # of the fleet. The replica itself got nothing.
                self.dispatch_timeouts += 1
                registry().counter("dispatch_timeouts", "router").inc()
                if tr is not None:
                    tr.add_event("dispatch_timeout", track="router",
                                 rid=str(rid), replica=h.name)
                tried.add(h.name)
                continue
            try:
                h.engine.submit(req)
            except Rejected as e:
                # This replica said no (full/draining) — try the rest
                # of the fleet before parking.
                if tr is not None:
                    tr.add_event("failover", track="router",
                                 rid=str(rid), replica=h.name,
                                 reason=e.reason)
                tried.add(h.name)
                continue
            # Pull BEFORE _record_owner rewrites the map: the pull
            # needs the previous owner. submit() only queued the
            # request, so pulled pages land in h's host tier ahead of
            # its admission — which rehydrates them locally.
            self._maybe_pull_prefix(h, req)
            self._assigned[rid] = h.name
            self._record_owner(req, h.name)
            if tr is not None:
                tr.add_span("dispatch", t0, self._tclock(),
                            track="router", rid=str(rid),
                            replica=h.name, attempt=attempt)
            return

    def _maybe_pull_prefix(self, h: ReplicaHandle, req: Request) -> None:
        """Fleet-global prefix pooling: if another replica owns this
        request's prefix and ``h`` holds less of it, copy the owner's
        cached chain into ``h``'s HOST tier (no device work here — the
        admission rehydrates on hit). Turns N per-replica caches into
        one pooled cache: a local miss becomes a remote hit anywhere
        the fleet holds the prefix. Best-effort: any owner staleness or
        a tier-less receiver just skips the pull."""
        enabled = self.prefix_pull
        if enabled is None:
            enabled = getattr(h.engine, "_host_tier", None) is not None
        if not enabled or not self.affinity:
            return
        if getattr(h.engine, "_host_tier", None) is None:
            return
        for key in reversed(self._prefix_keys(req.prompt)):
            owner = self._owners.get(key)
            if owner is None or owner == h.name:
                continue
            src = self._replicas.get(owner)
            if src is None:
                continue
            local = h.engine.probe_prefix_len(req.prompt)
            payload = src.engine.export_prefix(req.prompt)
            if payload is None or payload.n_tokens <= local:
                return
            pages = h.engine.admit_prefix_to_tier(payload)
            if pages:
                self.prefix_pulls += 1
                self.prefix_pull_pages += pages
                self.prefix_pull_bytes += payload.nbytes
                if self._tracer is not None:
                    self._tracer.add_event(
                        "prefix_pull", self._tclock(), track="router",
                        rid=str(req.rid), src=owner, dst=h.name,
                        pages=pages, bytes=payload.nbytes)
            return

    def _park_or_shed(self, rid: int, attempt: int) -> None:
        """No replica would take it right now. Park with the workqueue's
        capped-jittered backoff curve and retry; past ``max_retries``
        the FLEET sheds — a typed rejection the caller can act on,
        instead of an unbounded secret queue in the router."""
        if attempt >= self.max_retries:
            self._finish(rid, "rejected", "fleet_saturated")
            return
        delay = backoff_delay(
            self.retry_base_s, self.retry_max_s, rid, attempt)
        dl = self._deadline_t.get(rid)
        if dl is not None and self._clock() + delay >= dl:
            # The next retry slot lands past the request's deadline —
            # retrying is pure waste (the engine would deadline-retire
            # it on arrival). Shed at PARK time as a typed deadline
            # completion; conservation stays exact. Without this check
            # the backoff curve can keep a doomed request bouncing for
            # the full max_retries ladder after its deadline passed.
            self._shed_deadline(rid)
            return
        self.retries += 1
        if self._tracer is not None:
            self._tracer.add_event(
                "park", track="router", rid=str(rid),
                attempt=attempt, delay_s=delay)
        self._parked.append(_Parked(
            due_t=self._clock() + delay, rid=rid, attempt=attempt + 1))

    def _shed_deadline(self, rid: int) -> None:
        """Terminal deadline shed, router-side: the request never got
        (or will never get) a slot in time. Surfaces as a Completion
        with ``finish_reason="deadline"`` and no tokens — the same
        shape an engine's deadline retirement produces — so callers see
        ONE vocabulary for deadline misses wherever they happen."""
        if rid in self._outcomes:
            return
        now = self._clock()
        comp = Completion(
            rid=rid, tokens=[], finish_reason="deadline",
            submit_t=self._submit_t.get(rid, now),
            first_token_t=None, done_t=now)
        self.deadline_sheds += 1
        registry().counter("deadline_sheds", "router").inc()
        if self._tracer is not None:
            self._tracer.add_event("deadline_shed", track="router",
                                   rid=str(rid))
        self._finish(rid, "completed", comp)
        self.completions.append(comp)

    # -- outcomes ----------------------------------------------------------

    def _finish(self, rid: int, kind: str, payload) -> None:
        if rid in self._outcomes:
            self.duplicate_completions += 1
            return
        self._outcomes[rid] = (kind, payload)
        self._requests.pop(rid, None)
        self._assigned.pop(rid, None)
        self._gens_done.pop(rid, None)
        self._submit_t.pop(rid, None)
        self._deadline_t.pop(rid, None)
        self._migr_attempts.pop(rid, None)
        self._migr_sticky.pop(rid, None)
        if self._tracer is not None:
            self._tracer.add_event("fleet_outcome", track="router",
                                   rid=str(rid), kind=kind)
        registry().counter(f"outcome_{kind}", "router").inc()

    def _complete(self, comp: Completion) -> None:
        kind = ("cancelled" if comp.finish_reason == "cancelled"
                else "completed")
        if comp.rid in self._outcomes:
            self.duplicate_completions += 1
            return
        req = self._requests.get(comp.rid)
        n = (req.params.n if req is not None and req.params is not None
             else 1)
        if n > 1 and kind == "completed":
            # Parallel generations: each gen delivers its own
            # Completion; the rid stays live (and re-dispatchable on a
            # kill) until every gen has landed, and at-most-once holds
            # per (rid, gen) instead of per rid.
            done = self._gens_done.setdefault(comp.rid, set())
            if comp.gen in done:
                self.duplicate_completions += 1
                return
            done.add(comp.gen)
            self.completions.append(comp)
            if len(done) < n:
                return
            self._finish(comp.rid, kind, comp)
            return
        self._finish(comp.rid, kind, comp)
        self.completions.append(comp)

    def outcome(self, rid: int) -> Optional[Tuple[str, object]]:
        return self._outcomes.get(rid)

    @property
    def outcome_counts(self) -> Dict[str, int]:
        out = {k: 0 for k in OUTCOMES}
        for kind, _ in self._outcomes.values():
            out[kind] += 1
        return out

    @property
    def pending(self) -> int:
        """Requests the router still owes an outcome."""
        return len(self._requests)

    @property
    def idle(self) -> bool:
        return (not self._requests and not self._parked
                and all(h.engine.idle for h in self._replicas.values()))

    # -- drive -------------------------------------------------------------

    def step(self) -> List[Completion]:
        """One fleet quantum: fire due parked retries, step every
        replica (ejected and cordoned ones included — their in-flight
        work must finish), book completions, refresh health."""
        now = self._clock()
        due = [p for p in self._parked if p.due_t <= now]
        if due:
            self._parked = [p for p in self._parked if p.due_t > now]
            for p in due:
                self._dispatch(p.rid, attempt=p.attempt,
                               exclude=frozenset())
        out: List[Completion] = []
        for h in list(self._replicas.values()):
            if self._injector is not None and self._injector.fires(
                    "router", "router.replica_step", target=h.name,
                    kinds=("crash",)) is not None:
                # Injected SIGKILL/preemption: same path real chaos
                # takes — fold stats, re-dispatch its in-flight rids.
                # Plans should scope crash specs by target or max_fires;
                # a bare wildcard kills the whole fleet, as asked.
                self.kill(h.name)
                continue
            for c in h.engine.step():
                self._complete(c)
                out.append(c)
        self._run_migrations()
        self._update_health()
        return out

    # -- prefill -> decode migration ---------------------------------------

    def _run_migrations(self) -> None:
        """Move every export-ready prefill to a decode-capable replica.
        A rid with no receiver this quantum stays parked on its prefill
        replica and retries next step — its deadline (or a drain) bounds
        the wait, so starvation is typed, never silent."""
        for src in list(self._replicas.values()):
            if src.role != "prefill":
                continue
            for rid in src.engine.export_ready_rids():
                self._migrate_one(src, rid)

    def _migrate_one(self, src: ReplicaHandle, rid: int) -> bool:
        """One prefill->decode handoff: pick receivers by decode
        headroom (free slots, then free pages), probe the receiver's
        trie for the prompt's cached prefix (zero-copy rule), export
        only the uncached suffix pages, install, and ONLY THEN release
        the prefill replica's copy — at no point does any page of the
        request exist zero times, so a crash on either side leaves a
        re-runnable request, never a lost one (at-most-once on
        COMPLETION, the same contract kill() keeps)."""
        req = self._requests.get(rid)
        if req is None or rid in self._outcomes:
            # Terminal already — typically the receiver of a LOST-ACK
            # install completed the rid before this re-send fired. The
            # prefill replica still parks the exported slot waiting for
            # its ACK; release that orphan tenancy here or the slot (and
            # its pages) leak for the engine's lifetime.
            try:
                src.engine.finish_export(rid)
            except KeyError:
                pass
            return False
        tr = self._tracer
        attempt = self._migr_attempts.get(rid, 0)
        if self._injector is not None and self._injector.fires(
                "router", "router.migrate", target=src.name, rid=rid,
                kinds=("drop_migration",)) is not None:
            # Payload lost in flight before any receiver saw it. The
            # exporter still holds everything (export_request does not
            # free), so the retry next quantum re-exports losslessly.
            self.migration_timeouts += 1
            registry().counter("migration_timeouts", "router").inc()
            self._migr_attempts[rid] = attempt + 1
            if tr is not None:
                tr.add_event("migrate_timeout", track="router",
                             rid=str(rid), src=src.name,
                             attempt=attempt)
            return False
        sticky = self._migr_sticky.get(rid)
        if sticky is not None:
            # A previous install on this receiver may have landed (its
            # ACK was lost) — the re-send MUST go back there so the
            # install ledger can dedupe; any other receiver would
            # double-install. If the receiver died, the un-ACKed
            # install died with it and a fresh pick is safe.
            d = self._replicas.get(sticky)
            if d is None:
                self._migr_sticky.pop(rid, None)
                candidates = []
            else:
                candidates = [d]
        if sticky is None or not candidates:
            candidates = sorted(
                (d for d in self._replicas.values()
                 if d.role != "prefill" and d.routable
                 and d.name != src.name and d.free_slots > 0),
                key=lambda d: (-d.free_slots, -d.free_pages, d.name))
        for d in candidates:
            path, matched = d.engine.migration_probe(req.prompt)
            try:
                payload = src.engine.export_request(
                    rid, skip_tokens=matched)
            except KeyError:
                # Retired between listing and export (deadline/cancel
                # raced the clock) — the probe pin must not leak.
                d.engine.release_probe(path)
                return False
            payload.attempt = attempt
            try:
                d.engine.admit_migrated(payload, path=path)
            except Rejected as e:
                # admit_migrated released the probe pin itself. Try the
                # next receiver; the re-probe re-pins.
                if tr is not None:
                    tr.add_event("migrate_reject", track="router",
                                 rid=str(rid), replica=d.name,
                                 reason=e.reason)
                continue
            if self._injector is not None and self._injector.fires(
                    "router", "router.migrate_ack", target=d.name,
                    rid=rid, kinds=("drop_migration",)) is not None:
                # Install landed but its ACK was lost: the router acts
                # as if the hop never happened — no finish_export, no
                # assignment — and pins the receiver so the re-send
                # next quantum returns HERE, where admit_migrated's
                # ledger dedupes it into a success no-op. The src copy
                # stays held until the acked retry releases it:
                # at no point does the request exist zero times.
                self.migration_timeouts += 1
                registry().counter("migration_timeouts", "router").inc()
                self._migr_attempts[rid] = attempt + 1
                self._migr_sticky[rid] = d.name
                if tr is not None:
                    tr.add_event("migrate_ack_lost", track="router",
                                 rid=str(rid), dst=d.name,
                                 attempt=attempt)
                return False
            src.engine.finish_export(rid)
            self._assigned[rid] = d.name
            self._migr_attempts.pop(rid, None)
            self._migr_sticky.pop(rid, None)
            self.migrations += 1
            if tr is not None:
                tr.add_event(
                    "migrate", track="router", rid=str(rid),
                    src=src.name, dst=d.name, bytes=payload.nbytes,
                    zero_copy_tokens=payload.skip_tokens)
            return True
        return False

    def run_until_idle(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(
            f"fleet did not go idle in {max_steps} steps "
            f"({self.pending} pending, {len(self._parked)} parked)")

    # -- health ------------------------------------------------------------

    def _unhealthy_signal(self, h: ReplicaHandle) -> bool:
        h.watchdog_hit = False
        depth = len(h.engine.queue)
        cap = self.eject_queue_depth
        if cap is None and h.engine.max_queue is not None:
            cap = h.engine.max_queue
        if cap is not None and depth >= cap:
            return True
        if self.watchdog_stale_s is not None:
            # Progress watchdog: strike a replica that is BUSY but whose
            # quantum heartbeat has not advanced for watchdog_stale_s.
            # This is the only signal that catches a HUNG replica: the
            # queue-depth check needs saturation, and the TTFT reservoir
            # below samples completions — a replica completing nothing
            # never feeds it. Idle replicas are exempt (no work, no
            # progress expected), and so are replicas whose quanta still
            # run (export-parked prefills heartbeat without decoding).
            now = self._clock()
            hb = h.engine.stats.heartbeat
            if hb != h.hb_seen:
                h.hb_seen = hb
                h.hb_t = now
            else:
                busy = (h.engine.n_active > 0
                        or len(h.engine.queue) > 0)
                if busy and now - h.hb_t >= self.watchdog_stale_s:
                    h.watchdog_hit = True
                    self.watchdog_strikes += 1
                    registry().counter(
                        "watchdog_strikes", "router").inc()
                    if self._tracer is not None:
                        self._tracer.add_event(
                            "watchdog_strike", track="router",
                            replica=h.name,
                            stale_s=round(now - h.hb_t, 6))
                    return True
        if self.ttft_slo_ms is not None:
            # Only TTFTs recorded since the last check: an ejected
            # replica must be judged on what it does now, not on the
            # backlog that got it ejected. The high-water mark is the
            # reservoir's LOGICAL append count (``total``), not its
            # length — the capped ring evicts old samples, and
            # ``since()`` keeps the window exact across eviction.
            ttfts = h.engine.stats.ttfts_s.since(h.ttft_seen)
            h.ttft_seen = h.engine.stats.ttfts_s.total
            if ttfts:
                window = ttfts[-self.ttft_window:]
                if percentile(window, 99) * 1e3 > self.ttft_slo_ms:
                    return True
        return False

    def _update_health(self) -> None:
        for h in self._replicas.values():
            if self._unhealthy_signal(h):
                h.strikes += 1
                h.clears = 0
            else:
                h.clears += 1
            if h.healthy and h.strikes >= self.eject_after:
                h.healthy = False
                self.ejections += 1
                if h.watchdog_hit:
                    # A hung replica's in-flight work will NEVER surface
                    # on its own — unlike a slow replica's, which the
                    # eject merely routes around. Re-dispatch its rids
                    # to the live fleet now; if the hang later clears
                    # and the stale copies complete, outcome dedup
                    # swallows them (at-most-once on completion).
                    victims = sorted(
                        rid for rid, n in self._assigned.items()
                        if n == h.name)
                    for rid in victims:
                        if rid in self._outcomes:
                            continue
                        del self._assigned[rid]
                        self.redispatched += 1
                        self._dispatch(rid, attempt=0,
                                       exclude=frozenset((h.name,)))
            elif not h.healthy and h.clears >= self.readmit_after:
                h.healthy = True
                h.strikes = 0
                self.readmissions += 1

    # -- stats -------------------------------------------------------------

    def _fold_stats(self, engine: ServingEngine) -> None:
        """Fold a departing engine's counters into the fleet aggregate.
        EVERY path that discards an engine object — kill() AND
        rolling_restart's replace — must call this first, or the fleet
        summary silently loses that replica's history (the
        rolling-restart fold is pinned by tests/test_torch_fleet.py)."""
        self._retired_hit_tokens += engine.stats.prefix_hit_tokens
        self._retired_lookup_tokens += engine.stats.prefix_lookup_tokens
        self._retired_draft_proposed += engine.stats.draft_proposed
        self._retired_draft_accepted += engine.stats.draft_accepted
        self._retired_pages_migrated += engine.stats.pages_migrated
        self._retired_migration_bytes += engine.stats.migration_bytes
        self._retired_migrated_zero_copy += (
            engine.stats.migrated_zero_copy_tokens)
        self._retired_samples_dropped += engine.stats.samples_dropped
        self._retired_spilled_pages += engine.stats.spilled_pages
        self._retired_spill_bytes += engine.stats.spill_bytes
        self._retired_rehydrate_hits += engine.stats.rehydrate_hits
        self._retired_rehydrate_tokens += engine.stats.rehydrate_tokens
        self._retired_faults_injected += engine.stats.faults_injected
        self._retired_migrate_dedups += engine.stats.migrate_dedups

    @property
    def prefix_hit_rate(self) -> float:
        """Fleet-level hit rate across live AND retired engines — the
        number the affinity policy is judged by."""
        hit = self._retired_hit_tokens + sum(
            h.engine.stats.prefix_hit_tokens
            for h in self._replicas.values())
        lookup = self._retired_lookup_tokens + sum(
            h.engine.stats.prefix_lookup_tokens
            for h in self._replicas.values())
        return hit / lookup if lookup else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Fleet-level draft acceptance across live AND retired engines
        — the health signal for speculative decoding: a fleet-wide
        collapse toward 0 means the traffic mix stopped rewarding
        drafts (the engines' per-slot backoff is already limiting the
        cost; this number says whether speculation is worth running at
        all)."""
        proposed = self._retired_draft_proposed + sum(
            h.engine.stats.draft_proposed
            for h in self._replicas.values())
        accepted = self._retired_draft_accepted + sum(
            h.engine.stats.draft_accepted
            for h in self._replicas.values())
        return accepted / proposed if proposed else 0.0

    def fleet_summary(self) -> Dict[str, float]:
        counts = self.outcome_counts
        return {
            "replicas": float(len(self._replicas)),
            "submitted": float(self.submitted),
            "completed": float(counts["completed"]),
            "rejected": float(counts["rejected"]),
            "cancelled": float(counts["cancelled"]),
            "pending": float(self.pending),
            "retries": float(self.retries),
            "redispatched": float(self.redispatched),
            "duplicate_completions": float(self.duplicate_completions),
            "ejections": float(self.ejections),
            "readmissions": float(self.readmissions),
            "affinity_hits": float(self.affinity_hits),
            "prefix_hit_rate": self.prefix_hit_rate,
            "spec_acceptance_rate": self.spec_acceptance_rate,
            # Prefill/decode disaggregation: completed handoffs plus the
            # engine-side migration counters (live + retired engines, so
            # chaos/restart cannot lose them).
            "migrations": float(self.migrations),
            "pages_migrated": float(
                self._retired_pages_migrated + sum(
                    h.engine.stats.pages_migrated
                    for h in self._replicas.values())),
            "migration_bytes": float(
                self._retired_migration_bytes + sum(
                    h.engine.stats.migration_bytes
                    for h in self._replicas.values())),
            "migrated_zero_copy_tokens": float(
                self._retired_migrated_zero_copy + sum(
                    h.engine.stats.migrated_zero_copy_tokens
                    for h in self._replicas.values())),
            # Tiered KV + fleet-global prefix pooling (live + retired
            # engine counters, plus the router-side pull volume).
            "spilled_pages": float(
                self._retired_spilled_pages + sum(
                    h.engine.stats.spilled_pages
                    for h in self._replicas.values())),
            "spill_bytes": float(
                self._retired_spill_bytes + sum(
                    h.engine.stats.spill_bytes
                    for h in self._replicas.values())),
            "rehydrate_hits": float(
                self._retired_rehydrate_hits + sum(
                    h.engine.stats.rehydrate_hits
                    for h in self._replicas.values())),
            "rehydrate_tokens": float(
                self._retired_rehydrate_tokens + sum(
                    h.engine.stats.rehydrate_tokens
                    for h in self._replicas.values())),
            "host_pages_resident": float(sum(
                getattr(h.engine, "_host_tier").resident_pages
                if getattr(h.engine, "_host_tier", None) is not None
                else 0
                for h in self._replicas.values())),
            "prefix_pulls": float(self.prefix_pulls),
            "prefix_pull_pages": float(self.prefix_pull_pages),
            "prefix_pull_bytes": float(self.prefix_pull_bytes),
            # Fault injection + hang/timeout hardening (docs/chaos.md):
            # injected-fault fires seen by engines (live + retired), the
            # receivers' dedup saves, and the router's own watchdog /
            # timeout / deadline-shed activity.
            "faults_injected": float(
                self._retired_faults_injected + sum(
                    h.engine.stats.faults_injected
                    for h in self._replicas.values())),
            "migrate_dedups": float(
                self._retired_migrate_dedups + sum(
                    h.engine.stats.migrate_dedups
                    for h in self._replicas.values())),
            "watchdog_strikes": float(self.watchdog_strikes),
            "dispatch_timeouts": float(self.dispatch_timeouts),
            "migration_timeouts": float(self.migration_timeouts),
            "deadline_sheds": float(self.deadline_sheds),
            # Observability counters ride in the fleet JSONL so a
            # postmortem knows whether the trace it is reading is
            # complete (spans_dropped > 0 means the ring wrapped).
            "spans_recorded": float(
                self._tracer.spans_recorded
                if self._tracer is not None else 0),
            "spans_dropped": float(
                self._tracer.spans_dropped
                if self._tracer is not None else 0),
            "samples_dropped": float(
                self._retired_samples_dropped + sum(
                    h.engine.stats.samples_dropped
                    for h in self._replicas.values())),
        }


def sync_fleet_from_pods(
    router: FleetRouter,
    pods,
    engine_factory: Callable[[str], ServingEngine],
) -> Tuple[List[str], List[str]]:
    """Converge router membership onto the control plane's view: one
    replica per RUNNING, non-deleting pod. A pod the controller
    recreated after a crash joins with a fresh engine; a pod that
    vanished (chaos, scale-down) is treated as killed — its in-flight
    requests re-dispatch. Returns (added, removed) replica names.

    This is the dataplane half of the LMService reconcile loop: the
    controller converges pods onto spec.replicas, and this converges
    engines onto pods — both level-triggered, so calling it repeatedly
    is idempotent.

    Each pod's serving role rides on its ``naming.LABEL_ROLE`` label
    (set by the controller from ``spec.prefill_replicas`` — see
    ``naming.lmservice_pod_role``); pods without the label join as
    "mixed", so pre-disaggregation controllers keep byte-identical
    router membership."""
    # Local import: naming sits in the control-plane layer, and the
    # dataplane must stay importable without it at module load.
    from kubeflow_controller_tpu_torch.tpu import naming
    running = set()
    roles: Dict[str, str] = {}
    for pod in pods:
        phase = getattr(pod.status, "phase", None)
        if (getattr(phase, "value", phase) == "Running"
                and pod.metadata.deletion_timestamp is None):
            name = pod.metadata.name
            running.add(name)
            labels = getattr(pod.metadata, "labels", None) or {}
            roles[name] = labels.get(naming.LABEL_ROLE, "mixed")
    added, removed = [], []
    for name in sorted(set(router._replicas) - running):
        router.kill(name)
        removed.append(name)
    for name in sorted(running - set(router._replicas)):
        router.add_replica(name, engine_factory(name),
                           role=roles.get(name, "mixed"))
        added.append(name)
    return added, removed
