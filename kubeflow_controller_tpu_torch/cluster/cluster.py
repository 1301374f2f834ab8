"""FakeCluster: apiserver + gang-aware TPU scheduler + kubelet, in-process.

The hermetic test bed the reference never had (SURVEY.md §4: its multi-node
behavior was validated by hand against minikube). Deterministic: time advances
only via ``tick()``, so reconcile/preemption/recovery tests replay exactly.

Lifecycle model per pod (simulated kubelet):

    created --(gang admission grants a slice; Local pods skip the gang)-->
    scheduled --(start_delay)--> Running --(run_duration)--> Succeeded/Failed

A pod may instead run *real work* (e.g. the port's train step) via
``PodRunPolicy.run_fn`` — that is how "submit YAML → reconcile → pod runs real
training → Succeeded" is exercised end-to-end with no real cluster.

Counterpart of ``kubeflow_controller_tpu/cluster/cluster.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubeflow_controller_tpu_torch.api.core import Pod, PodPhase, Service, thaw
from kubeflow_controller_tpu_torch.cluster.event_recorder import EventAggregator
from kubeflow_controller_tpu_torch.cluster.events import EventType
from kubeflow_controller_tpu_torch.cluster.slices import (
    InsufficientCapacity,
    SlicePool,
    TPUSlice,
)
from kubeflow_controller_tpu_torch.cluster.store import NotFound, ObjectStore

# Well-known annotations the controller stamps on pods it creates; the fake
# scheduler reads them to drive gang admission. (The TPU analog of the
# reference's identity labels, distributed.go:221-228.)
ANNOTATION_GANG_SIZE = "tpu.kubeflow.dev/gang-size"
ANNOTATION_ACCELERATOR = "tpu.kubeflow.dev/accelerator-type"
ANNOTATION_NUM_SLICES = "tpu.kubeflow.dev/num-slices"
ANNOTATION_SLICE_INDEX = "tpu.kubeflow.dev/slice-index"
ANNOTATION_HOST_INDEX = "tpu.kubeflow.dev/host-index"
ANNOTATION_PRIORITY = "tpu.kubeflow.dev/priority"
# Job-level submission time: the FIFO tie-break must survive pod recreation
# (suspend/resume, gang restarts), so it rides an annotation rather than
# deriving from pod creation timestamps.
ANNOTATION_SUBMITTED = "tpu.kubeflow.dev/submitted-at"

REASON_PREEMPTED = "Preempted"


@dataclass
class PodRunPolicy:
    """How the fake kubelet runs a pod once its gang is admitted."""

    start_delay: float = 0.0     # scheduled -> Running (image pull etc.)
    run_duration: float = 0.0    # Running -> terminal
    exit_code: int = 0           # terminal exit code (0 => Succeeded)
    # Real work: called once when the pod transitions to Running, in its OWN
    # thread (one per pod — so a multi-pod gang can actually rendezvous
    # inside the cluster, e.g. each run_fn spawning a torch.distributed
    # subprocess). Its return value becomes the exit code (overrides
    # ``exit_code``); an exception means exit code 1. Deleting the pod does
    # not interrupt a running run_fn (a container SIGKILL analog is the
    # workload's job to arrange); a deleted pod's result is discarded.
    run_fn: Optional[Callable[[Pod], int]] = None
    # Wall-clock grace the kubelet waits on an unfinished run_fn thread per
    # tick: paces simulated ticks against the real work without letting one
    # pod block the cluster.
    run_fn_join: float = 0.25
    # If >= 0, the pod crashes with this code after run_duration instead of
    # exiting cleanly (fault injection).
    crash_code: int = -1


@dataclass
class FaultInjector:
    """Knobs tests turn to break the cluster on purpose (SURVEY.md §7.2)."""

    # Fail the next N pod-create calls at the client seam.
    fail_pod_creates: int = 0
    # Let this many creates succeed first (models a crash mid-batch: the
    # reference's service-created-but-pods-missing window,
    # distributed.go:131-159).
    fail_pod_creates_after: int = 0
    # Extra scheduling latency applied to every gang (slow provisioning).
    gang_admission_delay: float = 0.0
    # Pod-name -> policy override (e.g. crash worker 3).
    pod_policies: Dict[str, PodRunPolicy] = field(default_factory=dict)


@dataclass
class _PodRuntime:
    scheduled_at: Optional[float] = None
    started_at: Optional[float] = None
    gang_waiting_since: Optional[float] = None
    # run_fn execution state (worker thread writes run_result, tick thread
    # reads it after join — the join is the synchronization point).
    run_thread: Optional[threading.Thread] = None
    run_result: Optional[int] = None


class FakeCluster:
    """Facade over the stores + slice pool + simulated scheduler/kubelet."""

    def __init__(
        self,
        default_policy: Optional[PodRunPolicy] = None,
        use_native_index: Optional[bool] = None,
        watch_shards: int = 8,
    ):
        # All stores stamp creation timestamps on the cluster's simulated
        # clock so control-plane latency metrics are internally consistent.
        # Pods/services are indexed by owning-job label (and pods also by
        # owning-LMService label) so per-owner selector lists stay O(own
        # pods) at any cluster size.
        from kubeflow_controller_tpu_torch.tpu.naming import LABEL_JOB, LABEL_LMSERVICE

        # One shared native object index mirrors every store's sync-relevant
        # state into the C++ core (csrc/tpujob_native.cc). None when the
        # library is unavailable or use_native_index=False — everything then
        # runs the behavior-identical pure-Python paths.
        self.native_index = None
        if use_native_index is None or use_native_index:
            from kubeflow_controller_tpu_torch.native.objindex import (
                make_object_index,
            )

            self.native_index = make_object_index()
            if use_native_index and self.native_index is None:
                from kubeflow_controller_tpu_torch import native

                raise RuntimeError("native object index requested but "
                                   "libtpujob_native.so is unavailable "
                                   f"({native.load_error()})")

        # Frozen (copy-on-write) mode: reads, lists, and watch events are
        # shared immutable snapshots — the whole in-process control plane
        # runs zero-copy on the read path (docs/object_ownership.md).
        def _store(kind: str, index_labels: tuple = ()) -> ObjectStore:
            return ObjectStore(
                kind, now_fn=lambda: self.now, index_labels=index_labels,
                copy_on_read=False, watch_shards=watch_shards,
                mirror=self.native_index,
            )

        self.pods = _store("Pod", (LABEL_JOB, LABEL_LMSERVICE))
        self.services = _store("Service", (LABEL_JOB,))
        self.jobs = _store("TPUJob")
        self.lmservices = _store("LMService")
        # Scheduler/kubelet work queues: every tick touches only pods that
        # can actually change state — unbound Pending pods (scheduler) and
        # live pods (kubelet) — instead of scanning the whole store.
        # Maintained from the pod watch stream, so they can never drift
        # from the store (membership is re-derived on every event).
        self._pending_keys: set = set()
        self._active_keys: set = set()
        self.pods.subscribe(self._track_pod, replay=False)
        # The pool shares the native index: holder/health mutations write
        # through so the fingerprint's slice-health term is composed
        # natively (no holdings() traversal per steady probe).
        self.slice_pool = SlicePool(mirror=self.native_index)
        self.faults = FaultInjector()
        self.default_policy = default_policy or PodRunPolicy(
            start_delay=1.0, run_duration=5.0
        )
        self.now = 0.0
        self._runtimes: Dict[str, _PodRuntime] = {}
        self._lock = threading.RLock()
        # Cluster events (k8s Events analog): rows of (time, kind, name,
        # reason, message) — the observability surface record.EventRecorder
        # provides in the reference (controller.go:91-94). Aggregated like
        # client-go's tools/record: an identical repeat refreshes the
        # existing row (timestamp + recency position) instead of appending,
        # so a crash-looping job yields ONE row with count=N (events_agg)
        # rather than N rows, and `cluster_events` stays ordered by last
        # occurrence — a still-firing event is always in the recent window.
        self._event_rows: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.events_agg = EventAggregator()
        # Per-pod log lines (kubectl-logs analog): pod name -> [(time, line)].
        # The fake kubelet writes lifecycle lines; run_fn workloads may append
        # via append_pod_log.
        self.pod_logs: Dict[str, List[tuple]] = {}

    # -- pod work-queue tracking ---------------------------------------------

    def _track_pod(self, ev) -> None:
        pod = ev.obj
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._lock:
            if ev.type == EventType.DELETED:
                self._pending_keys.discard(key)
                self._active_keys.discard(key)
                return
            if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                self._active_keys.discard(key)
            else:
                self._active_keys.add(key)
            if (
                pod.status.phase == PodPhase.PENDING
                and not pod.spec.assigned_slice
                and pod.metadata.deletion_timestamp is None
            ):
                self._pending_keys.add(key)
            else:
                self._pending_keys.discard(key)

    def _pods_by_keys(self, keys) -> List[Pod]:
        out = []
        for key in keys:
            ns, _, name = key.partition("/")
            pod = self.pods.try_get(ns, name)
            if pod is not None:
                out.append(pod)
        return out

    # -- event recording -----------------------------------------------------

    @property
    def cluster_events(self) -> List[tuple]:
        """Event rows ordered by LAST occurrence (recency), one per
        distinct (namespace, kind, name, reason, message) key."""
        with self._lock:
            return list(self._event_rows.values())

    def record_event(
        self, kind: str, name: str, reason: str, message: str,
        namespace: str = "",
    ) -> None:
        with self._lock:
            obs = self.events_agg.observe(
                namespace, kind, name, reason, message, self.now
            )
            if obs is None:
                return          # spam-filtered (token bucket per object)
            # Aggregated similar events share obs.key, so a
            # varying-message flood stays ONE row (the combined form).
            self._event_rows[obs.key] = (
                self.now, kind, name, reason, obs.message)
            self._event_rows.move_to_end(obs.key)

    def event_count(
        self, kind: str, name: str, reason: str, message: str,
        namespace: str = "",
    ) -> int:
        """Aggregate occurrence count for an exact event key (0 = never)."""
        rec = self.events_agg.get(namespace, kind, name, reason, message)
        return rec.count if rec else 0

    def append_pod_log(self, pod_name: str, line: str) -> None:
        with self._lock:
            self.pod_logs.setdefault(pod_name, []).append((self.now, line))

    def get_pod_logs(self, pod_name: str) -> List[tuple]:
        with self._lock:
            return list(self.pod_logs.get(pod_name, []))

    # -- time ----------------------------------------------------------------

    def tick(self, dt: float = 1.0, steps: int = 1) -> None:
        """Advance simulated time and run scheduler + kubelet transitions."""
        for _ in range(steps):
            with self._lock:
                self.now += dt
            # Quiesce the async watch pipelines before acting on this
            # step's clock: _pending_keys/_active_keys are fed by the pod
            # watch stream, and scheduler/kubelet decisions must see every
            # write completed before the tick (determinism contract,
            # docs/watch_pipeline.md). Flushed outside self._lock — a
            # delta handler may take it.
            self.pods.flush()
            self.services.flush()
            self.jobs.flush()
            self.lmservices.flush()
            self._schedule_pending()
            self._advance_pods()

    def run_until(
        self,
        predicate: Callable[[], bool],
        dt: float = 1.0,
        max_steps: int = 1000,
    ) -> bool:
        """Tick until predicate() or step budget exhausted."""
        for _ in range(max_steps):
            if predicate():
                return True
            self.tick(dt)
        return predicate()

    # -- scheduler (gang admission) -----------------------------------------

    def _pod_policy(self, pod: Pod) -> PodRunPolicy:
        return self.faults.pod_policies.get(pod.metadata.name, self.default_policy)

    def _runtime(self, pod: Pod) -> _PodRuntime:
        return self._runtimes.setdefault(pod.metadata.uid, _PodRuntime())

    def _schedule_pending(self) -> None:
        with self._lock:
            # Sorted: set iteration order is hash-seed dependent, and gang
            # rank ties break by stable-sort input order — admission must
            # not vary run to run in a deterministic simulator.
            keys = sorted(self._pending_keys)
        if not keys:
            return
        # Membership is re-checked on the fresh copies: the index is an
        # over-approximation between event delivery and this read.
        pending = [
            p for p in self._pods_by_keys(keys)
            if p.status.phase == PodPhase.PENDING and not p.spec.assigned_slice
            and p.metadata.deletion_timestamp is None
        ]
        gangs: Dict[str, List[Pod]] = {}
        for pod in pending:
            group = pod.spec.scheduling_group
            if not group:
                self._bind_local(pod)
            else:
                gangs.setdefault(group, []).append(pod)

        def _rank(item):
            """Higher priority first; ties by JOB submission order (the
            submitted-at annotation survives pod recreation across
            suspend/resume and restarts). Ordering only — no preemption of
            running jobs."""
            ann = item[1][0].metadata.annotations

            def num(key, default):
                try:
                    return float(ann.get(key, default))
                except ValueError:
                    return float(default)

            members = item[1]
            fallback = min(
                p.metadata.creation_timestamp or 0.0 for p in members
            )
            return (-num(ANNOTATION_PRIORITY, 0),
                    num(ANNOTATION_SUBMITTED, fallback))

        # Head-of-line guard: once a HIGHER-priority gang fails allocation
        # for an accelerator type, lower-ranked gangs wanting the same type
        # must not leapfrog it this tick — otherwise a stream of small
        # low-priority gangs starves a large high-priority one forever.
        blocked_types: set = set()
        for group, members in sorted(gangs.items(), key=_rank):
            accel = members[0].metadata.annotations.get(
                ANNOTATION_ACCELERATOR, "")
            if accel in blocked_types:
                continue
            if self._try_admit_gang(group, members) is False:
                blocked_types.add(accel)

    def _bind_local(self, pod: Pod) -> None:
        rt = self._runtime(pod)
        if rt.scheduled_at is None:
            rt.scheduled_at = self.now
            self.record_event("Pod", pod.metadata.name, "Scheduled", "bound to local node")
            self.append_pod_log(pod.metadata.name, "scheduled: local node")

    def _try_admit_gang(self, group: str, members: List[Pod]) -> Optional[bool]:
        """None = not yet eligible (incomplete/delayed); True = admitted;
        False = eligible but out of capacity (head-of-line relevant)."""
        expected = int(members[0].metadata.annotations.get(ANNOTATION_GANG_SIZE, 0))
        if expected <= 0 or len(members) < expected:
            return None  # gang incomplete: nothing is admitted (all-or-nothing)
        rt0 = self._runtime(members[0])
        if rt0.gang_waiting_since is None:
            for m in members:
                self._runtime(m).gang_waiting_since = self.now
        if self.now - rt0.gang_waiting_since < self.faults.gang_admission_delay:
            return None
        accel = members[0].metadata.annotations.get(ANNOTATION_ACCELERATOR, "")
        num_slices = int(members[0].metadata.annotations.get(ANNOTATION_NUM_SLICES, 1))
        job_uid = group
        try:
            slices = self.slice_pool.allocate_gang(job_uid, accel, num_slices)
        except (InsufficientCapacity, KeyError) as e:
            self.record_event("Gang", group, "FailedScheduling", str(e))
            # Infeasible request (wants more slices than the pool OWNS, not
            # merely more than are free): it can never run, so it must not
            # head-of-line-block feasible gangs of the same type forever.
            if num_slices > len(self.slice_pool.list(accel)):
                return None
            return False
        # Bind: pod (slice_index, host_index) -> slice host. All-or-nothing:
        # if ANY member vanished (controller deleted it mid-admission), bind
        # nobody — a partially-bound gang is exactly what this module exists
        # to prevent. Slices stay held (allocate_gang is idempotent per
        # uid); the next tick re-gangs the new epoch's pods.
        by_index = sorted(
            members,
            key=lambda p: (
                int(p.metadata.annotations.get(ANNOTATION_SLICE_INDEX, 0)),
                int(p.metadata.annotations.get(ANNOTATION_HOST_INDEX, 0)),
            ),
        )
        if any(
            self.pods.try_get(p.metadata.namespace, p.metadata.name) is None
            for p in by_index
        ):
            return None
        bound: List[tuple] = []   # (pod, slice, host index)
        for pod in by_index:
            si = int(pod.metadata.annotations.get(ANNOTATION_SLICE_INDEX, 0))
            hi = int(pod.metadata.annotations.get(ANNOTATION_HOST_INDEX, 0))
            sl = slices[si]
            def bind(p: Pod, sl: TPUSlice = sl, hi: int = hi) -> None:
                p.spec.assigned_slice = sl.name
                p.status.host_ip = sl.hosts[hi % len(sl.hosts)]
            try:
                self.pods.mutate(
                    pod.metadata.namespace, pod.metadata.name, bind
                )
            except NotFound:
                # A member vanished after the existence check: unwind the
                # partial bind (no scheduled_at was set yet, so nothing has
                # started) and retry from scratch next tick.
                def unbind(p: Pod) -> None:
                    p.spec.assigned_slice = ""
                    p.status.host_ip = ""
                for p2, _, _ in bound:
                    try:
                        self.pods.mutate(
                            p2.metadata.namespace, p2.metadata.name, unbind
                        )
                    except NotFound:
                        pass
                return None
            bound.append((pod, sl, hi))
        for pod, sl, hi in bound:
            self._runtime(pod).scheduled_at = self.now
            self.append_pod_log(
                pod.metadata.name,
                f"scheduled: slice {sl.name} host {hi % len(sl.hosts)}",
            )
        self.record_event(
            "Gang", group, "GangScheduled",
            f"{len(members)} pods on {num_slices}x{accel}",
        )
        return True

    # -- kubelet -------------------------------------------------------------

    def _advance_pods(self) -> None:
        spawned: List[tuple] = []   # (pod, runtime, policy) started this tick
        with self._lock:
            keys = list(self._active_keys)
        if not keys:
            return
        for pod in self._pods_by_keys(sorted(keys)):
            if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                continue
            rt = self._runtime(pod)
            policy = self._pod_policy(pod)
            if pod.status.phase == PodPhase.PENDING:
                if rt.scheduled_at is None:
                    continue  # unscheduled (waiting on gang)
                if self.now - rt.scheduled_at >= policy.start_delay:
                    rt.started_at = self.now
                    self._transition(pod, PodPhase.RUNNING)
                    if policy.run_fn is not None:
                        # run_fns are user workloads that may mutate their
                        # pod (env twiddling etc.) — hand them an owned copy,
                        # not the frozen store snapshot.
                        cur = thaw(self.pods.try_get(
                            pod.metadata.namespace, pod.metadata.name))
                        if cur is None:
                            continue  # deleted mid-transition: nothing to run
                        self._spawn_run_fn(pod, rt, policy, cur)
                        # Reap AFTER the loop: every gang member must get its
                        # thread spawned this pass before anyone blocks
                        # waiting on the others (the rendezvous deadlock a
                        # synchronous kubelet would have) —
                        # while a fast single pod still finishes this tick.
                        spawned.append((pod, rt, policy))
            elif pod.status.phase == PodPhase.RUNNING:
                if policy.run_fn is not None:
                    self._reap_run_fn(pod, rt, policy)
                    continue
                if rt.started_at is not None and (
                    self.now - rt.started_at >= policy.run_duration
                ):
                    code = policy.crash_code if policy.crash_code >= 0 else policy.exit_code
                    self._finish(pod, code)
        for pod, rt, policy in spawned:
            self._reap_run_fn(pod, rt, policy)

    def _spawn_run_fn(
        self, pod: Pod, rt: _PodRuntime, policy: PodRunPolicy, cur: Pod
    ) -> None:
        if rt.run_thread is not None:
            return

        def target() -> None:
            try:
                code = int(policy.run_fn(cur))
            except SystemExit as e:   # container-entrypoint-style sys.exit(n)
                code = e.code if isinstance(e.code, int) else (
                    0 if e.code is None else 1)
            except BaseException as e:  # a crashing workload fails its pod —
                # BaseException so e.g. KeyboardInterrupt in the workload
                # cannot strand the pod in RUNNING forever
                self.append_pod_log(
                    pod.metadata.name,
                    f"run_fn raised: {type(e).__name__}: {e}")
                code = 1
            rt.run_result = code

        rt.run_thread = threading.Thread(
            target=target, daemon=True,
            name=f"pod-run-{pod.metadata.name}",
        )
        rt.run_thread.start()

    def _reap_run_fn(
        self, pod: Pod, rt: _PodRuntime, policy: PodRunPolicy
    ) -> None:
        if rt.run_thread is None:
            # Controller restart edge: a RUNNING run_fn pod whose runtime
            # was lost cannot re-run user code; treat as still running.
            return
        rt.run_thread.join(policy.run_fn_join)
        if not rt.run_thread.is_alive() and rt.run_result is not None:
            self._finish(pod, rt.run_result)

    def _transition(self, pod: Pod, phase: PodPhase) -> None:
        def mut(p: Pod) -> None:
            p.status.phase = phase
            if phase == PodPhase.RUNNING:
                p.status.start_time = self.now
        try:
            self.pods.mutate(pod.metadata.namespace, pod.metadata.name, mut)
        except NotFound:
            return  # deleted by the controller between list and mutate
        if phase == PodPhase.RUNNING:
            cmd = " ".join(pod.spec.main_container().command)
            self.append_pod_log(pod.metadata.name, f"started: {cmd}")

    def _finish(self, pod: Pod, exit_code: int) -> None:
        phase = PodPhase.SUCCEEDED if exit_code == 0 else PodPhase.FAILED
        def mut(p: Pod) -> None:
            p.status.phase = phase
            p.status.exit_code = exit_code
            p.status.finish_time = self.now
            if phase == PodPhase.FAILED and not p.status.reason:
                p.status.reason = f"ExitCode{exit_code}"
        try:
            self.pods.mutate(pod.metadata.namespace, pod.metadata.name, mut)
        except NotFound:
            return  # deleted by the controller between list and mutate
        self.append_pod_log(
            pod.metadata.name, f"exited: code {exit_code} ({phase.value})"
        )

    # -- fault injection ----------------------------------------------------

    def preempt_slice(self, slice_name: str) -> List[str]:
        """Preempt a slice: evict holder, fail every pod bound to it with
        reason Preempted. Returns names of failed pods."""
        self.slice_pool.preempt(slice_name)
        failed = []
        with self._lock:
            keys = list(self._active_keys)
        for pod in self._pods_by_keys(sorted(keys)):
            if pod.spec.assigned_slice == slice_name and pod.status.phase in (
                PodPhase.PENDING, PodPhase.RUNNING,
            ):
                def mut(p: Pod) -> None:
                    p.status.phase = PodPhase.FAILED
                    p.status.reason = REASON_PREEMPTED
                    p.status.message = f"slice {slice_name} was preempted"
                    p.status.finish_time = self.now
                try:
                    self.pods.mutate(
                        pod.metadata.namespace, pod.metadata.name, mut
                    )
                except NotFound:
                    continue  # deleted concurrently: nothing left to evict
                failed.append(pod.metadata.name)
        self.record_event("Slice", slice_name, REASON_PREEMPTED,
                          f"evicted {len(failed)} pods")
        return failed

    def degrade_slice(self, slice_name: str) -> str:
        """Mark a slice unhealthy WITHOUT failing its pods — the state the
        checker detects proactively (contrast ``preempt_slice``, where the
        kubelet already knows). Returns the holder uid."""
        holder = self.slice_pool.mark_unhealthy(slice_name)
        self.record_event(
            "Slice", slice_name, "Unhealthy",
            "slice degraded (pods still running)")
        return holder

    def crash_pod(self, namespace: str, name: str, exit_code: int = 137) -> None:
        pod = self.pods.get(namespace, name)
        self._finish(pod, exit_code)

    # -- DNS -----------------------------------------------------------------

    def resolve(self, dns_name: str) -> Optional[Service]:
        """Resolve '<svc>.<ns>.svc' the way cluster DNS would."""
        parts = dns_name.split(".")
        if len(parts) < 2:
            return None
        return self.services.try_get(parts[1], parts[0])
