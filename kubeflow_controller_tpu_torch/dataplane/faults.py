"""Deterministic, seeded fault injection for the serving fleet.

Counterpart of ``kubeflow_controller_tpu/dataplane/faults.py``; the port
keeps its own copy of this standard-library module. Gray failures (a
replica that *hangs*: accepts submits, never completes a quantum; a
migration payload lost mid-hop; a host-tier page that fails to read
back) are injected deterministically:

* a :class:`FaultPlan` is a list of :class:`FaultSpec` entries, each
  scoping ONE fault kind to a (plane, site, target replica, rid)
  match plus an activation window on the shared clock;
* a :class:`FaultInjector` evaluates the plan at instrumented call
  sites: engine step/submit/admit_migrated, the router's
  dispatch/replica-step/migrate paths and the
  :class:`~kubeflow_controller_tpu_torch.dataplane.kv_blocks.HostKVTier`
  read path. Each site asks ``injector.fires(plane, site, ...)`` and
  interprets the matched spec's ``kind`` locally (a hang at
  ``engine.step`` returns an empty quantum; a hang at
  ``router.dispatch`` models a submit RPC timeout). ``informer.deliver``
  stays a valid site name; the port instruments no control plane yet.

**Determinism contract**: every decision is a pure function of (plan,
seed, clock reading, per-site check counter): no wall clock, no global
RNG. Two runs with the same plan, seed and driven clock inject the same
fault schedule, and so do this module and the JAX package's on one
clock. ``injector=None`` is the default everywhere and leaves every
instrumented path as it is without the injector; an injector with an
EMPTY plan matches nothing.

Fault kinds and the recovery each one exercises:

==================  =====================================================
kind                 expected recovery
==================  =====================================================
``crash``            ``router.step`` kills the replica; in-flight rids
                     re-dispatch (at-most-once on completion).
``hang``             the router's progress watchdog strikes the replica
                     out on quantum-heartbeat staleness and re-dispatches
                     its in-flight rids.
``slow``             x``factor`` quantum stretch; deadline budgets and
                     the TTFT hysteresis absorb or eject it.
``drop_migration``   the prefill->decode hop times out and retries
                     idempotently (``admit_migrated`` dedupes by rid:
                     a re-send can never double-install).
``tier_io_error``    host-tier reads degrade to the discard path: the
                     spilled subtree prunes and admission re-prefills.
``refuse_admit``     typed ``Rejected`` at admission; the router's
                     failover/park/shed ladder absorbs it.
==================  =====================================================
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubeflow_controller_tpu_torch.obs.telemetry import registry

#: every fault kind a spec may carry.
KINDS = ("crash", "hang", "slow", "drop_migration", "tier_io_error",
         "refuse_admit")

#: planes an instrumented site lives on. "engine" = ServingEngine
#: internals, "router" = FleetRouter paths, "tier" = HostKVTier reads,
#: "control" = informer delivery.
PLANES = ("engine", "router", "tier", "control")

#: instrumented sites (a spec's ``site`` must be one of these or "*").
#: Kept as one registry so plans fail loudly on typos instead of
#: silently never matching.
SITES = (
    "engine.step",            # hang / slow: quantum makes no progress
    "engine.submit",          # refuse_admit: typed Rejected at intake
    "engine.admit_migrated",  # refuse_admit: migration install refused
    "router.dispatch",        # hang: submit RPC timeout -> failover
    "router.replica_step",    # crash: replica dies (SIGKILL) this quantum
    "router.migrate",         # drop_migration: payload lost in flight
    "router.migrate_ack",     # drop_migration: install ACK lost (dedup leg)
    "tier.read",              # tier_io_error: host page fails to read back
    "informer.deliver",       # hang: watch delivery stalls (resync heals)
)


def _fnv(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


@dataclass
class FaultSpec:
    """One scoped fault. Matches a check when every scope field does:
    ``plane``/``site``/``target`` are exact-or-``"*"``, ``rid`` is
    exact-or-``None`` (None = any rid, including rid-less sites), and
    the injector clock lies in ``[after, until)``. ``prob`` thins
    matches with a seeded per-site counter hash; ``max_fires`` caps the
    total. ``factor`` only applies to ``slow`` (quantum stretch)."""

    kind: str
    plane: str = "*"
    site: str = "*"
    target: str = "*"
    rid: Optional[int] = None
    after: float = 0.0
    until: float = math.inf
    prob: float = 1.0
    factor: float = 2.0
    max_fires: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} not in {KINDS}")
        if self.plane != "*" and self.plane not in PLANES:
            raise ValueError(
                f"fault plane {self.plane!r} not in {PLANES}")
        if self.site != "*" and self.site not in SITES:
            raise ValueError(
                f"fault site {self.site!r} not in {SITES}")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1] (got {self.prob})")
        if self.factor < 1.0:
            raise ValueError(
                f"slow factor must be >= 1 (got {self.factor})")
        if self.until < self.after:
            raise ValueError(
                f"window until {self.until} < after {self.after}")

    def matches(self, plane: str, site: str, target: str,
                rid: Optional[int], now: float) -> bool:
        return (
            (self.plane == "*" or self.plane == plane)
            and (self.site == "*" or self.site == site)
            and (self.target == "*" or self.target == target)
            and (self.rid is None or self.rid == rid)
            and self.after <= now < self.until
        )


@dataclass
class FaultPlan:
    """An ordered list of specs; the FIRST active match at a site wins
    (order your specs most-specific first)."""

    specs: List[FaultSpec] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        specs = d.get("specs", d if isinstance(d, list) else [])
        return cls(specs=[FaultSpec(**s) for s in specs])

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        out = []
        for s in self.specs:
            rec = {
                "kind": s.kind, "plane": s.plane, "site": s.site,
                "target": s.target, "rid": s.rid, "after": s.after,
                "prob": s.prob, "factor": s.factor,
                "max_fires": s.max_fires,
            }
            if math.isfinite(s.until):
                rec["until"] = s.until
            out.append(rec)
        return {"specs": out}


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at instrumented sites.

    Share ONE injector (and one ``clock``) across the router, its
    engines, their tiers, and the informers — the plan's windows are on
    that shared clock, which is what makes a fault schedule replayable
    under simulated time. The injector is also the fault LEDGER: every
    fire increments ``dataplane.faults_total`` / ``faults_<kind>`` in
    the process registry, lands a ``fault_injected`` event on the
    tracer (site, kind, rid, target), and counts into
    :meth:`summary` so chaos runs are attributable in the stitched
    trace.

    Over a tensor-parallel gang each rank holds its own injector over
    the same plan and seed, on an
    :class:`~..serving_engine.AgreedClock` (rank 0's reading at every
    check): with the ranks making the same checks in the same order,
    every rank fires the same specs at the same sites, and every rank's
    ledger is rank 0's."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 clock: Callable[[], float] = None,
                 seed: int = 0, tracer=None):
        self.plan = plan if plan is not None else FaultPlan()
        self._clock = clock if clock is not None else (lambda: 0.0)
        self.seed = int(seed)
        self._tracer = tracer
        self.total_fires = 0
        #: (site, kind) -> fire count
        self.fired: Dict[Tuple[str, str], int] = {}
        # per-spec fire counts (max_fires) and per-(spec, site) check
        # counters (the prob hash input — deterministic, no RNG state).
        self._spec_fires: Dict[int, int] = {}
        self._checks: Dict[Tuple[int, str], int] = {}

    def fires(self, plane: str, site: str, *, target: str = "",
              rid: Optional[int] = None,
              kinds: Optional[Sequence[str]] = None
              ) -> Optional[FaultSpec]:
        """First active spec matching this check, or None. ``kinds``
        restricts which fault kinds the call site can interpret (a spec
        of another kind at the same site is skipped, not mis-fired).
        A non-None return IS a fire: counted, metered, traced."""
        now = self._clock()
        for idx, spec in enumerate(self.plan.specs):
            if kinds is not None and spec.kind not in kinds:
                continue
            if not spec.matches(plane, site, target, rid, now):
                continue
            if (spec.max_fires is not None
                    and self._spec_fires.get(idx, 0) >= spec.max_fires):
                continue
            if spec.prob < 1.0:
                ck = (idx, site)
                n = self._checks.get(ck, 0)
                self._checks[ck] = n + 1
                h = _fnv(f"{self.seed}:{idx}:{site}:{n}".encode())
                if h / 4294967296.0 >= spec.prob:
                    continue
            self._spec_fires[idx] = self._spec_fires.get(idx, 0) + 1
            self.total_fires += 1
            key = (site, spec.kind)
            self.fired[key] = self.fired.get(key, 0) + 1
            reg = registry()
            reg.counter("faults_total", "dataplane").inc()
            reg.counter(f"faults_{spec.kind}", "dataplane").inc()
            if self._tracer is not None:
                self._tracer.add_event(
                    "fault_injected", now, track="router",
                    rid=(str(rid) if rid is not None else None),
                    site=site, kind=spec.kind, target=target)
            return spec
        return None

    def summary(self) -> Dict[str, float]:
        out = {"faults_total": float(self.total_fires)}
        for (site, kind), n in sorted(self.fired.items()):
            out[f"faults.{site}.{kind}"] = float(n)
        return out


def load_plan(path: str) -> FaultPlan:
    """Load a plan from a JSON file (the ``serve_lm --fault-plan``
    format — see docs/chaos.md for the schema)."""
    return FaultPlan.from_json(path)
