"""The reconcile core — level-triggered sync loop over TPUJobs.

Rebuild of ``pkg/controller/controller.go`` (NewController ``:74-152``, Run
``:158-182``, processNextWorkItem ``:194-243``, syncHandler ``:248-341``,
manageTFJob ``:343-428``, resource handlers ``:430-590``) with the stubs and
bugs closed (SURVEY.md §8): deletion handlers re-enqueue (reference logged
"To Be Implemented"), status writes are conflict-retried (reference did a raw
whole-object PUT), the informer cache is never mutated (cache entries are
frozen shared snapshots — writes raise; see docs/object_ownership.md), and
pod creation is gang-batched, not incremental.

Effects happen only through the ClusterClient seam; decisions come only from
the pure planner/updater/checker modules.

Counterpart of ``kubeflow_controller_tpu/controller/controller.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import string
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from kubeflow_controller_tpu_torch.api.core import (
    Container,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    is_frozen,
)
from kubeflow_controller_tpu_torch.api.types import (
    ConditionStatus,
    ConditionType,
    LMService,
    LMServicePhase,
    TPUJob,
)
from kubeflow_controller_tpu_torch.api.validation import (
    ValidationError,
    validate_job,
    validate_lmservice,
)
from kubeflow_controller_tpu_torch.checker import assess_health
from kubeflow_controller_tpu_torch.cluster.client import ClusterClient
from kubeflow_controller_tpu_torch.cluster.events import EventType, WatchEvent
from kubeflow_controller_tpu_torch.cluster.store import AlreadyExists, Conflict, NotFound
from kubeflow_controller_tpu_torch.controller.claim import claim_objects
from kubeflow_controller_tpu_torch.controller.expectations import ControllerExpectations
from kubeflow_controller_tpu_torch.controller.informer import Informer
from kubeflow_controller_tpu_torch.controller.workqueue import RateLimitingQueue
from kubeflow_controller_tpu_torch.obs.telemetry import registry
from kubeflow_controller_tpu_torch.tpu import naming
from kubeflow_controller_tpu_torch.tpu.plan import Plan, plan_job
from kubeflow_controller_tpu_torch.updater import compute_status

logger = logging.getLogger("tpujob.controller")

_RUNTIME_ID_ALPHABET = string.ascii_lowercase + string.digits

# LMService keys share the TPUJob workqueue; the prefix keeps the two key
# spaces disjoint so rate-limit/expectation state never collides with a
# same-named job.
LMSVC_KEY_PREFIX = "lmsvc:"

# Sentinel fp value for the native path: the candidate fingerprint is parked
# inside the C++ index (oix_fp_probe), not materialized in Python; recording
# a steady pass promotes it verbatim via oix_fp_commit.
_NATIVE_FP = ("__native_pending__",)


def generate_runtime_id(rng: Optional[random.Random] = None) -> str:
    """5-char random suffix, the shape of k8s SimpleNameGenerator as the
    reference uses it (``pkg/tensorflow/util.go:24-26``) — but stamped ONCE."""
    r = rng or random
    return "".join(r.choice(_RUNTIME_ID_ALPHABET) for _ in range(5))


@dataclass
class ControllerOptions:
    workers: int = 2                      # reference runs 2 (main.go:54)
    # Key-range shards for the workqueue: >1 splits the queue into
    # independently-locked sub-queues (FNV-routed, so a key's dedup/backoff
    # state stays on one shard) and run(workers=N) binds each worker to its
    # shard group — steady-state resync then scales with workers instead of
    # serializing on one queue lock. 1 == the single-queue behavior every
    # existing test pins.
    queue_shards: int = 1
    resync_period: float = 30.0           # reference: 30s informers
    now_fn: Callable[[], float] = time.time
    rng: Optional[random.Random] = None
    # Exponential backoff between FAILURE gang restarts (in now_fn units):
    # a crash-looping workload must not re-gang as fast as reconcile can
    # run. First restart is immediate; the Nth failure waits
    # min(base * 2^(N-1), max). Voluntary resizes are never delayed.
    restart_backoff_base: float = 10.0
    restart_backoff_max: float = 300.0
    # Wall-clock requeue cadence while a backoff is pending (now_fn may be
    # a simulated clock, so the queue polls and re-checks it).
    backoff_poll: float = 0.05
    # Optional control-plane tracer (docs/observability.md): workqueue
    # enqueue->dequeue latency, per-key sync spans (outcome-tagged, the
    # noop short-circuit included), and requeue/backoff events, all on
    # the "control" track keyed by workqueue key. None = zero overhead.
    tracer: Optional[object] = None
    # Optional dataplane.faults.FaultInjector (docs/chaos.md): threaded
    # onto every informer this controller wires handlers to, so a plan
    # can stall watch delivery ("informer.deliver" hangs) and prove the
    # resync sweep heals the loss. None = off, byte-identical.
    injector: Optional[object] = None


@dataclass
class SyncTrace:
    """Per-sync structured trace record (SURVEY.md §5.1: the reference has
    no tracing at all — glog only)."""

    key: str
    start: float
    duration: float = 0.0
    outcome: str = ""
    note: str = ""
    error: str = ""


class Controller:
    def __init__(
        self,
        client: ClusterClient,
        job_informer: Informer,
        pod_informer: Informer,
        service_informer: Informer,
        options: Optional[ControllerOptions] = None,
        lmservice_informer: Optional[Informer] = None,
    ):
        self.client = client
        self.jobs = job_informer
        self.pods = pod_informer
        self.services = service_informer
        self.lmservices = lmservice_informer
        self.opts = options or ControllerOptions()
        # Hot-path structures come from the C++ core when it is loadable
        # (csrc/tpujob_native.cc); the pure-Python implementations are the
        # behavioural reference and the fallback. TPUJOB_NATIVE=0 forces
        # Python.
        from kubeflow_controller_tpu_torch.native.queue import (
            make_expectations, make_queue,
        )

        if self.opts.queue_shards > 1:
            from kubeflow_controller_tpu_torch.controller.workqueue import (
                ShardedRateLimitingQueue,
            )

            self.queue = ShardedRateLimitingQueue(
                self.opts.queue_shards, make_queue)
        else:
            self.queue = make_queue()
        self.expectations = make_expectations()
        # Native object index (cluster/store.py write-through mirror): when
        # the client exposes one, the no-op-sync fingerprint probe runs
        # entirely inside the C++ core — no Python pod/service traversals
        # on a steady resync. None routes through _sync_fingerprint.
        self._nix = getattr(client, "native_index", None)
        # Pre-encoded constant probe arguments (the per-sync fp probe is
        # the steady-resync hot path; encoding these 6 strings per call
        # was measurable at 10k+ objects).
        self._b_job_label = naming.LABEL_JOB.encode()
        self._b_lmsvc_label = naming.LABEL_LMSERVICE.encode()
        # Ring buffer of the last 1000 traces. deque(maxlen=) trims on
        # append under the GIL — safe with concurrent workers, unlike the
        # old unlocked append + del[:-1000] pair.
        self.traces: Deque[SyncTrace] = deque(maxlen=1000)
        self.sync_count = 0                 # total syncs, never truncated
        self.sync_wall_s = 0.0              # wall seconds inside sync()
        self.syncs_skipped_noop = 0         # fingerprint fast-path exits
        self.fp_misses = 0                  # fingerprint probes that missed
        self._count_lock = threading.Lock()
        # key -> fingerprint of the last fully-steady sync; a matching
        # fingerprint lets sync() exit before claim/plan/status work.
        self._last_sync_fp: Dict[str, Tuple] = {}
        # Sim-clock backoff deadlines (key -> now_fn deadline); see
        # _requeue_after / _kick_sim_backoffs.
        self._sim_backoffs: Dict[str, float] = {}
        # Earliest pending enqueue time per key (tracer clock units),
        # stamped by the informer handlers and popped by _process — the
        # enqueue->dequeue latency span. setdefault/pop are single
        # bytecode dict ops, safe across informer + worker threads.
        self._enqueue_t: Dict[str, float] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

        if self.opts.injector is not None:
            for inf in (job_informer, pod_informer, service_informer,
                        lmservice_informer):
                if inf is not None and hasattr(inf, "injector"):
                    inf.injector = self.opts.injector

        job_informer.add_handler(self._on_job_event)
        pod_informer.add_handler(self._on_resource_event)
        service_informer.add_handler(self._on_resource_event)
        if lmservice_informer is not None:
            lmservice_informer.add_handler(self._on_lmservice_event)

    # -- event handlers (informer side) -------------------------------------

    def _note_enqueue(self, key: str) -> None:
        """Stamp the key's earliest pending enqueue for the
        enqueue->dequeue latency span (coalesced adds keep the FIRST
        stamp — the latency a watch event actually waited)."""
        tr = self.opts.tracer
        if tr is not None:
            self._enqueue_t.setdefault(key, tr.clock())

    def _on_job_event(self, ev: WatchEvent) -> None:
        key = f"{ev.obj.metadata.namespace}/{ev.obj.metadata.name}"
        if ev.type == EventType.DELETED:
            # Deletion path the reference stubbed (controller.go:505-508).
            self.expectations.delete_expectations(key)
            self._forget_fp(key)
        self._note_enqueue(key)
        self.queue.add(key)

    def _on_lmservice_event(self, ev: WatchEvent) -> None:
        key = (f"{LMSVC_KEY_PREFIX}"
               f"{ev.obj.metadata.namespace}/{ev.obj.metadata.name}")
        if ev.type == EventType.DELETED:
            self.expectations.delete_expectations(key)
            self._forget_fp(key)
        self._note_enqueue(key)
        self.queue.add(key)

    def _forget_fp(self, key: str) -> None:
        """Invalidate the steady-sync fingerprint (both paths) on DELETED —
        a recreated same-name object must never inherit a stale skip."""
        with self._count_lock:
            self._last_sync_fp.pop(key, None)
        if self._nix is not None:
            self._nix.fp_forget(key)

    @staticmethod
    def _owner_key(namespace: str, ref) -> Optional[str]:
        """Workqueue key for a resource's controlling owner (TPUJob or
        LMService), or None for foreign owners."""
        if ref is None:
            return None
        if ref.kind == "TPUJob":
            return f"{namespace}/{ref.name}"
        if ref.kind == "LMService":
            return f"{LMSVC_KEY_PREFIX}{namespace}/{ref.name}"
        return None

    def _on_resource_event(self, ev: WatchEvent) -> None:
        """Pod/Service watch events: resolve the owning job, settle
        expectations, enqueue (reference addPod/updatePod/… controller.go:430-590)."""
        obj = ev.obj
        if (
            ev.type == EventType.MODIFIED
            and ev.old_obj is not None
            and ev.old_obj.metadata.resource_version
            == obj.metadata.resource_version
        ):
            # Periodic-resync redelivery (old == new; real store writes
            # always bump rv). The k8s job-controller idiom: updatePod
            # returns early on equal ResourceVersions — the PRIMARY
            # informer's resync re-enqueues every owner, so re-adding the
            # key once per child object here only multiplies queue traffic
            # by the fan-out (2 pods + 1 service per job at 10k jobs is
            # 30k redundant adds per resync wave).
            return
        keys = set()
        key = self._owner_key(obj.metadata.namespace,
                              obj.metadata.controller_ref())
        if key is not None:
            keys.add(key)
        if ev.type == EventType.MODIFIED and ev.old_obj is not None:
            old_key = self._owner_key(obj.metadata.namespace,
                                      ev.old_obj.metadata.controller_ref())
            if old_key is not None:
                keys.add(old_key)
        for key in keys:
            if ev.type == EventType.ADDED:
                self.expectations.creation_observed(key)
            elif ev.type == EventType.DELETED:
                self.expectations.deletion_observed(key)
            self._note_enqueue(key)
            self.queue.add(key)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start informers (list+watch). Call before run()/drain()."""
        self.jobs.start()
        self.pods.start()
        self.services.start()
        if self.lmservices is not None:
            self.lmservices.start()

    def run(self, workers: Optional[int] = None) -> None:
        """Spawn worker threads (reference Run, controller.go:158-182).
        With a sharded workqueue each worker binds to its key-range shard
        group, so workers block on independent locks instead of contending
        on one queue head."""
        n = workers if workers is not None else self.opts.workers
        for i in range(n):
            t = threading.Thread(
                target=self._worker_loop, args=(i, n),
                name=f"tpujob-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=5)
        self.jobs.stop()
        self.pods.stop()
        self.services.stop()
        if self.lmservices is not None:
            self.lmservices.stop()

    def _worker_loop(self, index: int = 0, nworkers: int = 1) -> None:
        source = self.queue
        worker_source = getattr(source, "worker_source", None)
        if worker_source is not None:
            source = worker_source(index, nworkers)
        while not self._stop.is_set():
            item = source.get()
            if item is None:
                return
            self._process(item)

    def drain(self, max_items: int = 1000) -> int:
        """Synchronously process every ready queue item — the deterministic
        test-mode alternative to run()."""
        self._kick_sim_backoffs()
        self._flush_informers()
        n = 0
        while n < max_items:
            item = self.queue.get(timeout=0)
            if item is None:
                # A dispatcher on another thread may still be delivering
                # watch events that will enqueue more work: quiesce the
                # pipeline and look again before declaring the queue dry.
                self._flush_informers()
                item = self.queue.get(timeout=0)
                if item is None:
                    return n
            self._process(item)
            n += 1
        return n

    def _flush_informers(self) -> None:
        """Quiesce the async watch pipeline: every event from a completed
        store write is delivered before this returns (no-op for watch
        sources without a flush hook, e.g. wire watches)."""
        for inf in (self.jobs, self.pods, self.services, self.lmservices):
            if inf is None:
                continue
            flush = getattr(inf, "flush", None)
            if flush is not None:
                flush()

    def _process(self, key: str) -> None:
        import time as _time

        tr = self.opts.tracer
        if tr is not None:
            t_enq = self._enqueue_t.pop(key, None)
            if t_enq is not None:
                tr.add_span("queue_wait", t_enq, tr.clock(),
                            track="control", rid=key)
        trace = SyncTrace(key=key, start=self.opts.now_fn())
        t0 = _time.perf_counter()
        t_s0 = tr.clock() if tr is not None else 0.0
        try:
            self.sync(key, trace)
        except Exception as e:  # requeue with backoff (controller.go:228-242)
            trace.error = f"{type(e).__name__}: {e}"
            logger.exception("sync %s failed", key)
            self.queue.add_rate_limited(key)
            if tr is not None:
                tr.add_event("requeue_backoff", track="control", rid=key,
                             error=trace.error)
        else:
            self.queue.forget(key)
        finally:
            self.queue.done(key)
            trace.duration = self.opts.now_fn() - trace.start
            wall = _time.perf_counter() - t0
            if tr is not None:
                tr.add_span("sync", t_s0, tr.clock(), track="control",
                            rid=key, outcome=trace.outcome,
                            noop=trace.outcome == "noop-skip",
                            error=trace.error)
            with self._count_lock:   # worker threads increment concurrently
                self.sync_count += 1
                # Wall-clock seconds spent INSIDE sync handlers — the
                # denominator for a per-sync cost metric that harness
                # overhead (benchmark polling, cluster ticks) cannot
                # pollute. trace.duration above is sim-time and reads 0
                # under the simulated clock.
                self.sync_wall_s += wall
            self.traces.append(trace)
            registry().counter("syncs", "control").inc()
            registry().histogram("sync_wall_s", "control").observe(wall)

    # -- the sync handler ----------------------------------------------------

    def sync(self, key: str, trace: Optional[SyncTrace] = None) -> None:
        trace = trace or SyncTrace(key=key, start=self.opts.now_fn())
        if key.startswith(LMSVC_KEY_PREFIX):
            self._sync_lmservice(key, trace)
            return
        namespace, name = key.split("/", 1)
        satisfied = self.expectations.satisfied(key)
        job = self.jobs.get(namespace, name)
        if job is None:
            self._cleanup_deleted(namespace, name)
            trace.outcome = "deleted-cleanup"
            return
        deleting = job.metadata.deletion_timestamp is not None

        # No-op short-circuit (training-operator generation/observedGeneration
        # skip): when the job's spec generation has been observed by status
        # and nothing in the observable world — job rv, owned pod/service
        # rvs, slice health — moved since the last fully-steady sync, the
        # whole validate/claim/plan/status pass is provably a no-op. Any
        # store change emits a watch event that re-enqueues the key and
        # shifts this fingerprint, so the skip is self-correcting; eventless
        # health flips (sim fault injection) shift the slice component and
        # are caught on the next resync.
        fp = None
        if (
            satisfied and not deleting
            and job.status.observed_generation == job.metadata.generation
        ):
            if self._nix is not None:
                if self._native_fp_probe(key, namespace, name, job):
                    with self._count_lock:
                        self.syncs_skipped_noop += 1
                    trace.outcome = "noop-skip"
                    return
                fp = _NATIVE_FP
                with self._count_lock:
                    self.fp_misses += 1
            else:
                fp = self._sync_fingerprint(namespace, name, job)
                with self._count_lock:
                    if fp == self._last_sync_fp.get(key):
                        self.syncs_skipped_noop += 1
                        trace.outcome = "noop-skip"
                        return
                    self.fp_misses += 1

        try:
            validate_job(job)
        except ValidationError as e:
            self.client.record_event("TPUJob", name, "InvalidSpec", str(e),
                                     namespace=namespace)
            trace.outcome = "invalid"
            return

        # Stamp runtime id exactly once (fixing the regenerate-per-sync bug,
        # distributed.go:208-209).
        if not job.spec.runtime_id:
            rid = generate_runtime_id(self.opts.rng)
            def stamp(j: TPUJob) -> None:
                if not j.spec.runtime_id:
                    j.spec.runtime_id = rid
            job = self._stamp_runtime_id(namespace, name, stamp)
            if job is None:
                return

        selector = naming.job_selector(job)
        pods = claim_objects(
            job, selector,
            self.client.list_pods(namespace, {naming.LABEL_JOB: name}),
            self.client.update_pod,
        )
        services = claim_objects(
            job, selector,
            self.client.list_services(namespace, {naming.LABEL_JOB: name}),
            self.client.update_service,
        )

        # Slice-health assessment (the wired-in checker): pods still running
        # on an unhealthy slice trigger proactive recovery through the
        # planner, before the kubelet fails them. Fetched only when the
        # planner will read it — for local/terminal/suspended/unstamped jobs
        # the slice query (an HTTP round-trip on the REST backend) is waste.
        health = None
        if self._wants_health(job):
            health = assess_health(
                pods, self.client.job_slices(
                    job.metadata.uid, job.metadata.name))
        plan = plan_job(job, pods, services, health=health)

        executed = False
        if satisfied and not deleting:
            executed = self._execute(key, job, plan)
        elif not satisfied:
            trace.outcome = "expectations-pending"

        # Status update (conflict-retried, unlike controller.go:630-636).
        now = self.opts.now_fn()
        wrote = self._update_status(
            namespace, name, pods, now,
            fail_reason=plan.fail_reason,
            recovering=plan.gang_restart,
            suspended=plan.suspend,
        )
        # Suspend releases slices only on a sync that actually acted (or
        # once no pods remain): with expectations unsatisfied the deletes
        # were skipped, and freeing slices still occupied by live pods
        # would invite double-occupancy.
        suspend_released = plan.suspend and (satisfied or not pods)
        if plan.recycle or plan.fail_reason or suspend_released:
            self.client.release_slices(job.metadata.uid)

        # ttlSecondsAfterFinished: auto-delete terminal jobs after the TTL
        # (k8s Job / training-operator semantics). Deletion flows through
        # the deleted-job cleanup path, removing pods/services too.
        ttl = job.spec.ttl_seconds_after_finished
        requeued = False
        if ttl is not None and job.is_done():
            cur = self.client.get_job_snapshot(namespace, name)  # read-only
            # guard on the phase, not on completion_time's truthiness —
            # t=0.0 is a legitimate completion time on a simulated clock
            if cur is not None and cur.is_done():
                remaining = cur.status.completion_time + ttl - now
                if remaining <= 0:
                    try:
                        self.client.delete_job(namespace, name)
                    except NotFound:
                        pass
                    trace.outcome = "ttl-deleted"
                    return
                self._requeue_after(key, remaining)
                requeued = True

        if trace.outcome == "":
            trace.outcome = "executed" if executed else "steady"
        trace.note = plan.note

        # Record the fingerprint only after a *provably* steady pass: the
        # planner found nothing to do, nothing was executed or written, and
        # no deferred work (TTL timer, restart backoff — the latter keeps
        # plan.gang_restart set, failing is_noop) is pending. Recording on
        # any other pass could freeze out a sync the deferral depends on.
        if (
            fp is not None and not executed and not wrote
            and not requeued and plan.is_noop()
        ):
            if fp is _NATIVE_FP:
                self._nix.fp_commit(key)
            else:
                with self._count_lock:
                    self._last_sync_fp[key] = fp

    def fp_stats(self) -> Tuple[int, int]:
        """(hits, misses) of the no-op-sync fingerprint probe, whichever
        path served it. Native counters are authoritative when the C++
        index is wired (the Python `syncs_skipped_noop`/`fp_misses` pair
        matches them; the native pair also counts probes issued by other
        controllers sharing the index)."""
        if self._nix is not None:
            return self._nix.fp_counts()
        with self._count_lock:
            return (self.syncs_skipped_noop, self.fp_misses)

    def publish_store_metrics(self) -> Dict[str, float]:
        """Push fingerprint + store gauges into the `control.store`
        registry subsystem (objects per kind, index
        buckets, fingerprint hits/misses, watch-queue depth high-water,
        per-shard lock wait) and return the values."""
        hits, misses = self.fp_stats()
        vals: Dict[str, float] = {
            "fingerprint_hits": float(hits),
            "fingerprint_misses": float(misses),
        }
        for inf in (self.jobs, self.pods, self.services, self.lmservices):
            store = getattr(inf, "_store", None) if inf is not None else None
            publish = getattr(store, "publish_metrics", None)
            if publish is not None:
                vals.update(publish())
        reg = registry()
        reg.gauge("fingerprint_hits", "control.store").set(float(hits))
        reg.gauge("fingerprint_misses", "control.store").set(float(misses))
        return vals

    @staticmethod
    def _wants_health(job: TPUJob) -> bool:
        """Whether the planner will read slice health for this job (shared
        gate between the full sync path and the fingerprint)."""
        return bool(
            job.spec.runtime_id and not job.is_done()
            and not job.spec.suspend and job.worker_spec() is not None
        )

    def _native_fp_probe(
        self, key: str, namespace: str, name: str, job: TPUJob
    ) -> bool:
        """Fingerprint probe through the native object index: same
        observable world as _sync_fingerprint (job identity, owned pod and
        service rvs by label bucket, slice health), but BOTH the pod/service
        traversal AND the slice-health term are composed inside the C++
        core against write-through mirrors (stores for objects, the slice
        pool for health) — the steady probe is fully traversal-free.
        Returns True on a steady hit; on a miss the candidate parks
        native-side for fp_commit."""
        meta = job.metadata
        ident = f"{meta.uid}|{meta.resource_version}|{meta.generation}"
        return self._nix.fp_probe_mirrored(
            key, ident, namespace,
            b"Pod", self._b_job_label, name,
            b"Service", self._b_job_label, name,
            meta.uid, self._wants_health(job),
        )

    def _sync_fingerprint(self, namespace: str, name: str, job: TPUJob) -> Tuple:
        """The observable world a sync would act on, as a cheap comparable:
        job identity/rv/generation, owned pod and service resource versions
        (label-selected, pre-claim — an adoptable orphan shifts it), and
        the slice-health picture the planner would see. Store lists are
        label-indexed, so this is O(owned objects), no claim writes, no
        planning, no status diff."""
        pods = self.client.list_pods(namespace, {naming.LABEL_JOB: name})
        services = self.client.list_services(
            namespace, {naming.LABEL_JOB: name})
        health_key = None
        if self._wants_health(job):
            health_key = tuple(sorted(
                (s.name, s.healthy)
                for s in self.client.job_slices(
                    job.metadata.uid, job.metadata.name)
            ))
        return (
            job.metadata.uid,
            job.metadata.resource_version,
            job.metadata.generation,
            tuple(sorted(
                (p.metadata.uid, p.metadata.resource_version)
                for p in pods)),
            tuple(sorted(
                (s.metadata.uid, s.metadata.resource_version)
                for s in services)),
            health_key,
        )

    def _stamp_runtime_id(
        self, namespace: str, name: str, stamp: Callable[[TPUJob], None]
    ) -> Optional[TPUJob]:
        try:
            job = self.client.get_job(namespace, name)
            if job is None:
                return None
            stamp(job)
            return self.client.update_job(job)
        except Conflict:
            # Another worker raced us; requeue resolves it.
            self.queue.add(f"{namespace}/{name}")
            return None

    # -- plan execution (the only place effects happen) ----------------------

    def _execute(self, key: str, job: TPUJob, plan: Plan) -> bool:
        acted = False
        ns = job.metadata.namespace

        if plan.gang_restart and not plan.resize:
            # Failure-restart backoff: a crash-looping workload re-gangs on
            # an exponential schedule, not at reconcile speed. (Voluntary
            # resizes skip this.) The whole restart — including deletion of
            # the failed epoch — defers, so the evidence stays visible.
            st = job.status
            failures = st.restarts - st.resizes
            if failures > 0 and st.last_restart_time:
                # exponent capped before materializing 2**N: huge
                # max_restarts must saturate at the max, not overflow
                backoff = min(
                    self.opts.restart_backoff_base
                    * (2 ** min(failures - 1, 60)),
                    self.opts.restart_backoff_max,
                )
                remaining = (
                    st.last_restart_time + backoff - self.opts.now_fn()
                )
                if remaining > 0:
                    self._requeue_after(key, remaining)
                    return False

        if plan.gang_restart:
            if plan.health_restart:
                self.client.record_event(
                    "TPUJob", job.metadata.name, "SliceUnhealthy",
                    plan.restart_reason, namespace=ns)
            # Persist the epoch bump FIRST so a crash between delete and
            # create cannot strand the job: stale-epoch pods are deleted by
            # rule on every future sync.
            def bump(j: TPUJob) -> None:
                j.status.restarts += 1
                if plan.resize:
                    # voluntary: epoch advances; failure budget AND the
                    # failure-backoff clock stay untouched
                    j.status.resizes += 1
                else:
                    j.status.last_restart_time = self.opts.now_fn()
                j.status.set_condition(
                    ConditionType.RECOVERING, ConditionStatus.TRUE,
                    "GangRestart", plan.restart_reason,
                    now=self.opts.now_fn())
            self._mutate_job(ns, job.metadata.name, bump)
            self.client.record_event(
                "TPUJob", job.metadata.name, "GangRestart",
                plan.restart_reason, namespace=ns)
            acted = True

        if plan.delete_pods:
            self.expectations.expect_deletions(key, len(plan.delete_pods))
            for pod_name in plan.delete_pods:
                try:
                    self.client.delete_pod(ns, pod_name)
                except NotFound:
                    self.expectations.deletion_observed(key)
            acted = True

        n_creates = len(plan.create_pods) + len(plan.create_services)
        if n_creates:
            self.expectations.expect_creations(key, n_creates)
            batch = (
                [(s, self.client.create_service) for s in plan.create_services]
                + [(p, self.client.create_pod) for p in plan.create_pods]
            )
            for i, (obj, create) in enumerate(batch):
                try:
                    create(obj)
                except AlreadyExists:
                    self.expectations.creation_observed(key)
                except Exception:
                    # No watch events will come for this create NOR for the
                    # never-attempted remainder of the batch — un-expect them
                    # all or the job stalls until the TTL (the reference's
                    # slow-start batch does the same accounting).
                    for _ in range(len(batch) - i):
                        self.expectations.creation_observed(key)
                    raise
            self.client.record_event(
                "TPUJob", job.metadata.name, "GangCreate",
                f"created {len(plan.create_pods)} pods, "
                f"{len(plan.create_services)} services", namespace=ns)
            acted = True

        if plan.delete_services:
            for svc_name in plan.delete_services:
                try:
                    self.client.delete_service(ns, svc_name)
                except NotFound:
                    pass
            acted = True

        if plan.fail_reason:
            if plan.health_restart:
                # Health-triggered but budget-exhausted: still record WHICH
                # slice killed the job, not just that it failed.
                self.client.record_event(
                    "TPUJob", job.metadata.name, "SliceUnhealthy",
                    plan.fail_reason, namespace=ns)
            self.client.record_event(
                "TPUJob", job.metadata.name, "JobFailed", plan.fail_reason,
                namespace=ns)
        return acted

    def _requeue_after(self, key: str, remaining: float) -> None:
        """Requeue a key once ``remaining`` now_fn-seconds elapse.

        With the real clock the queue's monotonic delay is the same
        timebase, so one exact requeue suffices. A simulated clock cannot
        be slept on: record the sim-clock deadline (drain() fires due keys
        exactly when the sim clock reaches them — the deterministic path)
        and ALSO park a backoff_poll wall-clock requeue as the threaded-
        mode fallback, where workers only wake via the queue."""
        if self.opts.now_fn is time.time:
            self.queue.add_after(key, remaining)
            return
        deadline = self.opts.now_fn() + remaining
        with self._count_lock:
            cur = self._sim_backoffs.get(key)
            if cur is None or deadline < cur:
                self._sim_backoffs[key] = deadline
        self.queue.add_after(key, self.opts.backoff_poll)

    def _kick_sim_backoffs(self) -> None:
        """Promote sim-clock backoff deadlines that have come due into
        immediate queue adds. No-op on the real clock (the queue's own
        timer is exact there)."""
        if not self._sim_backoffs:
            return
        now = self.opts.now_fn()
        with self._count_lock:
            due = [k for k, d in self._sim_backoffs.items() if d <= now]
            for k in due:
                del self._sim_backoffs[k]
        for k in due:
            self.queue.add(k)

    def _mutate_job(self, ns: str, name: str, fn: Callable[[TPUJob], None]) -> None:
        """Conflict-retried read-modify-write against the job store."""
        for _ in range(10):
            job = self.client.get_job(ns, name)
            if job is None:
                return
            fn(job)
            try:
                self.client.update_job(job)
                return
            except Conflict:
                continue

    def _update_status(
        self, ns: str, name: str, pods: List[Pod], now: float,
        fail_reason: str, recovering: bool, suspended: bool = False,
    ) -> bool:
        """Returns True when a status write happened (or was attempted and
        kept conflicting) — the no-op fingerprint must not be recorded on
        such a pass, because the write's own MODIFIED event will re-enqueue
        the key with a new resource version."""
        # Write only when something changed (the reference's ShouldUpdate
        # contract) — an unconditional write would emit MODIFIED, re-enqueue
        # the job, and reconcile would chase its own tail forever.
        #
        # Runs every sync, so it must not copy the whole job: the scratch
        # object shares the snapshot's frozen metadata/spec and carries a
        # private status copy — compute_status writes only .status, and
        # update_job_status persists only .status (structurally sharing the
        # spec store-side too). Steady-state syncs copy one status and
        # write nothing.
        for _ in range(10):
            snap = self.client.get_job_snapshot(ns, name)
            if snap is None:
                return False
            if is_frozen(snap):
                job = dataclasses.replace(
                    snap, status=snap.status.deepcopy())
            else:
                job = snap  # wire parse: already a private copy
            changed = compute_status(
                job, pods, now, fail_reason=fail_reason,
                recovering=recovering, suspended=suspended,
            )
            if not changed:
                return False
            try:
                self.client.update_job_status(job)
                return True
            except Conflict:
                continue
        return True

    # -- deleted-job cleanup -------------------------------------------------

    def _cleanup_deleted(self, namespace: str, name: str) -> None:
        """Job object is gone: delete owned resources, release slices.
        (The reference leaks everything here — deletion handlers are stubs.)"""
        self.expectations.delete_expectations(f"{namespace}/{name}")
        self._forget_fp(f"{namespace}/{name}")
        uids = set()
        for pod in self.client.list_pods(namespace, {naming.LABEL_JOB: name}):
            ref = pod.metadata.controller_ref()
            if ref is not None and ref.kind == "TPUJob" and ref.name == name:
                uids.add(ref.uid)
                try:
                    self.client.delete_pod(namespace, pod.metadata.name)
                except NotFound:
                    pass
        for svc in self.client.list_services(namespace, {naming.LABEL_JOB: name}):
            ref = svc.metadata.controller_ref()
            if ref is not None and ref.kind == "TPUJob" and ref.name == name:
                uids.add(ref.uid)
                try:
                    self.client.delete_service(namespace, svc.metadata.name)
                except NotFound:
                    pass
        for uid in uids:
            self.client.release_slices(uid)

    # -- LMService reconcile -------------------------------------------------
    #
    # The fleet analog of the job sync: drive N long-running serving-replica
    # pods toward spec.replicas through the same claim/expectations
    # machinery. Replica pods are index-named (lmservice_pod_name), so a
    # crashed replica is deleted this sync and recreated (same name, new
    # uid) on the next — level-triggered crash recovery with no extra state.
    # Request-side behavior (routing, drain, failover) lives in
    # dataplane/router.py; the controller only manages pod existence.

    def _sync_lmservice(self, key: str, trace: SyncTrace) -> None:
        namespace, name = key[len(LMSVC_KEY_PREFIX):].split("/", 1)
        satisfied = self.expectations.satisfied(key)
        svc = None
        if self.lmservices is not None:
            svc = self.lmservices.get(namespace, name)
        if svc is None:
            self._cleanup_deleted_lmservice(key, namespace, name)
            trace.outcome = "deleted-cleanup"
            return
        deleting = svc.metadata.deletion_timestamp is not None

        # No-op short-circuit, same contract as the job path: once status
        # has observed the spec generation and neither the service rv nor
        # any owned replica-pod rv moved since the last fully-steady sync,
        # the claim/scale/status pass below is provably a no-op. (LMService
        # fingerprints have no service bucket and no slice-health term —
        # replica pods are the whole observable world.)
        fp = None
        if (
            satisfied and not deleting
            and svc.status.observed_generation == svc.metadata.generation
        ):
            meta = svc.metadata
            if self._nix is not None:
                ident = (f"{meta.uid}|{meta.resource_version}|"
                         f"{meta.generation}")
                if self._nix.fp_probe(
                    key, ident, namespace,
                    b"Pod", self._b_lmsvc_label, name,
                    b"", b"", b"", b"-",
                ):
                    with self._count_lock:
                        self.syncs_skipped_noop += 1
                    trace.outcome = "noop-skip"
                    return
                fp = _NATIVE_FP
                with self._count_lock:
                    self.fp_misses += 1
            else:
                fp = (
                    meta.uid, meta.resource_version, meta.generation,
                    tuple(sorted(
                        (p.metadata.uid, p.metadata.resource_version)
                        for p in self.client.list_pods(
                            namespace, {naming.LABEL_LMSERVICE: name})
                    )),
                )
                with self._count_lock:
                    if fp == self._last_sync_fp.get(key):
                        self.syncs_skipped_noop += 1
                        trace.outcome = "noop-skip"
                        return
                    self.fp_misses += 1

        try:
            validate_lmservice(svc)
        except ValidationError as e:
            self.client.record_event("LMService", name, "InvalidSpec", str(e),
                                     namespace=namespace)
            trace.outcome = "invalid"
            return

        if not svc.spec.runtime_id:
            rid = generate_runtime_id(self.opts.rng)
            cur = self.client.get_lmservice(namespace, name)
            if cur is None:
                return
            if not cur.spec.runtime_id:
                cur.spec.runtime_id = rid
                try:
                    svc = self.client.update_lmservice(cur)
                except Conflict:
                    self.queue.add(key)
                    return
            else:
                svc = cur

        selector = naming.lmservice_selector(svc)
        pods = claim_objects(
            svc, selector,
            self.client.list_pods(namespace, {naming.LABEL_LMSERVICE: name}),
            self.client.update_pod,
        )

        desired = {
            naming.lmservice_pod_name(svc, i): i
            for i in range(svc.spec.replicas)
        }
        existing = {p.metadata.name: p for p in pods}
        terminal = (PodPhase.SUCCEEDED, PodPhase.FAILED)
        to_delete = sorted(
            n for n, p in existing.items()
            if n not in desired or p.status.phase in terminal
        )
        to_create = sorted(
            i for n, i in desired.items() if n not in existing
        )

        executed = False
        if satisfied and not deleting:
            if to_delete:
                self.expectations.expect_deletions(key, len(to_delete))
                for pod_name in to_delete:
                    try:
                        self.client.delete_pod(namespace, pod_name)
                    except NotFound:
                        self.expectations.deletion_observed(key)
                executed = True
            if to_create:
                self.expectations.expect_creations(key, len(to_create))
                for j, i in enumerate(to_create):
                    pod = self._lmservice_pod(svc, i)
                    try:
                        self.client.create_pod(pod)
                    except AlreadyExists:
                        self.expectations.creation_observed(key)
                    except Exception:
                        # Same un-expect accounting as the job batch: no
                        # watch events will come for the unattempted rest.
                        for _ in range(len(to_create) - j):
                            self.expectations.creation_observed(key)
                        raise
                self.client.record_event(
                    "LMService", name, "ScaleReplicas",
                    f"created {len(to_create)} replica pods",
                    namespace=namespace)
                executed = True
        elif not satisfied:
            trace.outcome = "expectations-pending"

        ready = sum(
            1 for n, p in existing.items()
            if n in desired and p.status.phase == PodPhase.RUNNING
            and p.metadata.deletion_timestamp is None
        )
        wrote = self._update_lmservice_status(namespace, name, ready)
        if trace.outcome == "":
            trace.outcome = "executed" if executed else "steady"

        # Record only after a provably steady pass (see the job path): the
        # runtime-id stamp above counts as neither executed nor wrote, but
        # its MODIFIED event re-enqueues the key with a new rv, so a
        # prematurely recorded fingerprint self-corrects on the next sync.
        if fp is not None and not executed and not wrote:
            if fp is _NATIVE_FP:
                self._nix.fp_commit(key)
            else:
                with self._count_lock:
                    self._last_sync_fp[key] = fp

    def _lmservice_pod(self, svc: LMService, index: int) -> Pod:
        """One fully-specified serving-replica pod. No scheduling_group:
        replicas bind individually (no gang) — losing one must not affect
        the others."""
        pod = Pod()
        pod.metadata.name = naming.lmservice_pod_name(svc, index)
        pod.metadata.namespace = svc.metadata.namespace
        pod.metadata.labels = naming.lmservice_pod_labels(svc, index)
        pod.metadata.owner_references = [OwnerReference(
            api_version=svc.api_version,
            kind=svc.kind,
            name=svc.metadata.name,
            uid=svc.metadata.uid,
        )]
        env = {
            "LMSERVICE_NAME": svc.metadata.name,
            "LMSERVICE_REPLICA_INDEX": str(index),
            "LMSERVICE_MAX_QUEUE": str(svc.spec.max_queue),
        }
        if svc.spec.slo.deadline_s > 0:
            env["LMSERVICE_DEADLINE_S"] = str(svc.spec.slo.deadline_s)
        pod.spec = PodSpec(
            containers=[Container(
                name="engine",
                image="tpujob/serve:latest",
                command=["python", "-m",
                         "kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm"],
                args=["--config", svc.spec.model],
                env=env,
            )],
            restart_policy="Always",
        )
        return pod

    def _update_lmservice_status(
        self, ns: str, name: str, ready: int
    ) -> bool:
        for _ in range(10):
            snap = self.client.get_lmservice_snapshot(ns, name)
            if snap is None:
                return False
            replicas = snap.spec.replicas
            if ready >= replicas:
                phase = LMServicePhase.READY
            elif ready > 0:
                phase = LMServicePhase.DEGRADED
            else:
                phase = LMServicePhase.PENDING
            if (
                snap.status.ready_replicas == ready
                and snap.status.phase == phase
                and snap.status.observed_generation == snap.metadata.generation
            ):
                return False
            if is_frozen(snap):
                svc = dataclasses.replace(snap, status=snap.status.deepcopy())
            else:
                svc = snap
            svc.status.ready_replicas = ready
            svc.status.phase = phase
            svc.status.observed_generation = snap.metadata.generation
            svc.status.set_condition(
                ConditionType.READY,
                ConditionStatus.TRUE if phase == LMServicePhase.READY
                else ConditionStatus.FALSE,
                "ReplicasReady", f"{ready}/{replicas} replicas ready",
                now=self.opts.now_fn())
            try:
                self.client.update_lmservice_status(svc)
                return True
            except Conflict:
                continue
        return True

    def _cleanup_deleted_lmservice(
        self, key: str, namespace: str, name: str
    ) -> None:
        """LMService object is gone: delete its replica pods."""
        self.expectations.delete_expectations(key)
        self._forget_fp(key)
        for pod in self.client.list_pods(
            namespace, {naming.LABEL_LMSERVICE: name}
        ):
            ref = pod.metadata.controller_ref()
            if ref is not None and ref.kind == "LMService" and ref.name == name:
                try:
                    self.client.delete_pod(namespace, pod.metadata.name)
                except NotFound:
                    pass
