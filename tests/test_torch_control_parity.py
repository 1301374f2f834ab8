"""One script, both controllers: the port's in-process control plane
(``kubeflow_controller_tpu_torch.runtime.LocalRuntime``) against the JAX
package's, decision for decision.

Each scenario is a list of actions (submit, step, crash, preempt,
degrade, create failures, suspend/resume, apply a resized spec, controller
restart, delete, LMService submit/scale/delete). Both runtimes take every
action in lockstep, and after EVERY action a normalised snapshot of the
two clusters must be equal: every job's and LMService's whole object
(status and conditions included), every pod and service, the slice pool's
holders and health, the recorded events with their counts, the
workqueue's length, and the controller's syncs: their count, the no-op
fingerprint's hits and misses, and each sync's key, outcome and note.

Determinism: both controllers draw runtime ids from ``random.Random`` with
the same seed; uids (which embed a process counter and the wall clock)
are mapped to their order of first appearance in each runtime; no field is
dropped (a serving replica's command names its own package's entry
point; that module path is the one string rewritten). The workqueue's
wall-clock fallbacks are taken out of the race:
the sim-clock backoff poll is parked far in the future (``drain()`` fires
sim deadlines itself), and a sync error's rate-limited retry is waited out
before the next drain, on both sides alike.

Both sides take the same ``use_native_index``: the scenarios run as each
package's own tests run them (the C++ core, workqueue, expectations and
object index, when its library loads: the JAX package's prebuilt one, the
port's built from its own ``csrc/tpujob_native.cc``), and the seeded soup
also at ``use_native_index=False`` (the pure-Python paths on both sides).
The control plane imports no torch, so neither does this file.
"""

import dataclasses
import enum
import importlib
import random
import re
import time
import types as pytypes

import pytest
from test_torch_native import load_jax_native

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")
SEED = 1234
# Rate-limited retries after a failed sync wait base * 2**(n-1) wall seconds
# (workqueue default base 0.005 s); scenarios fail at most a few creates.
RATE_LIMIT_BASE_S = 0.005

_UID = re.compile(r"\b[a-z]+-\d{8}-[0-9a-f]{4}\b")


def _mods(pkg: str) -> pytypes.SimpleNamespace:
    imp = importlib.import_module
    return pytypes.SimpleNamespace(
        core=imp(f"{pkg}.api.core"),
        types=imp(f"{pkg}.api.types"),
        apply=imp(f"{pkg}.api.apply"),
        cluster=imp(f"{pkg}.cluster.cluster"),
        runtime=imp(f"{pkg}.runtime"),
        naming=imp(f"{pkg}.tpu.naming"),
    )


# -- objects from plain specs ------------------------------------------------


def _template(m):
    return m.core.PodTemplateSpec(spec=m.core.PodSpec(
        containers=[m.core.Container(name="trainer", image="trainer:latest")]))


def _job(m, spec: dict):
    t = m.types
    kind = spec.get("kind", "worker")
    name = spec["name"]
    if kind == "local":
        rs = t.ReplicaSpec(replica_type=t.ReplicaType.LOCAL,
                           template=_template(m),
                           max_restarts=spec.get("max_restarts", 3))
    else:
        chief = spec.get("chief")
        tp = (t.TerminationPolicySpec(chief=t.ChiefSpec(
            replica_name="Worker", replica_index=chief))
            if chief is not None else None)
        rs = t.ReplicaSpec(
            replica_type=t.ReplicaType.WORKER,
            template=_template(m),
            tpu=t.TPUSliceSpec(accelerator_type=spec.get("accel", "v5p-8"),
                               num_slices=spec.get("num_slices", 1)),
            max_restarts=spec.get("max_restarts", 3),
            termination_policy=tp,
        )
    return t.TPUJob(
        metadata=m.core.ObjectMeta(name=name, namespace="default"),
        spec=t.TPUJobSpec(
            model_dir=f"/ckpt/{name}",
            replica_specs=[rs],
            ttl_seconds_after_finished=spec.get("ttl"),
            priority=spec.get("priority", 0),
        ),
    )


def _lmservice(m, name: str, replicas: int):
    return m.types.LMService(
        metadata=m.core.ObjectMeta(name=name, namespace="default"),
        spec=m.types.LMServiceSpec(model="tiny", replicas=replicas))


# -- a runtime and its snapshot ----------------------------------------------


class Side:
    """One package's LocalRuntime plus the harness state around it."""

    def __init__(self, pkg: str, policy: dict, native=None, seed=SEED):
        self.m = _mods(pkg)
        if pkg == PACKAGES[0] and native is not False:
            load_jax_native()
        kw = {} if native is None else {"use_native_index": native}
        self.rt = self.m.runtime.LocalRuntime(
            self.m.cluster.PodRunPolicy(**policy), **kw)
        opts = self.rt.controller.opts
        opts.rng = random.Random(seed)
        opts.backoff_poll = 1e6
        self.uids = {}
        self.slices = []          # slice names taken by preempt/degrade
        self.rate_limited = set()
        self._wrap_queue()

    def _wrap_queue(self):
        q = self.rt.controller.queue
        orig = q.add_rate_limited

        def add_rate_limited(key):
            self.rate_limited.add(key)
            orig(key)

        q.add_rate_limited = add_rate_limited

    def restart_controller(self):
        self.rt.restart_controller()
        self._wrap_queue()

    def settle(self):
        """drain(), then wait out every rate-limited retry the drain queued
        and drain again, until a drain queues none."""
        self.rt.controller.drain()
        while self.rate_limited:
            q = self.rt.controller.queue
            wait = max(RATE_LIMIT_BASE_S * 2 ** max(q.num_requeues(k) - 1, 0)
                       for k in self.rate_limited)
            self.rate_limited.clear()
            time.sleep(wait + 0.002)
            self.rt.controller.drain()

    def step(self, dt: float, n: int):
        for _ in range(n):
            self.settle()
            self.rt.cluster.tick(dt)
            self.settle()

    # -- lookups ---------------------------------------------------------

    def job(self, name):
        return self.rt.cluster.jobs.try_get("default", name)

    def pods_of(self, name):
        m = self.m
        return sorted(
            (p for p in self.rt.cluster.pods.list("default")
             if p.metadata.labels.get(m.naming.LABEL_JOB) == name),
            key=lambda p: p.metadata.name)

    def held(self, name):
        job = self.job(name)
        if job is None:
            return []
        return sorted(s.name for s in
                      self.rt.cluster.slice_pool.holdings(job.metadata.uid))

    # -- normalised snapshot ----------------------------------------------

    def _norm_str(self, s: str) -> str:
        def sub(mt):
            u = mt.group(0)
            if u not in self.uids:
                self.uids[u] = f"<uid{len(self.uids)}>"
            return self.uids[u]
        # The one deliberate difference: a serving replica's command runs
        # its own package's serve_lm entry point.
        s = s.replace("kubeflow_controller_tpu_torch.", "kubeflow_controller_tpu.")
        return _UID.sub(sub, s)

    def norm(self, v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: self.norm(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, dict):
            return {self.norm(k): self.norm(x)
                    for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))}
        if isinstance(v, (list, tuple)):
            return [self.norm(x) for x in v]
        if isinstance(v, str):
            return self._norm_str(v)
        return v

    def snapshot(self) -> dict:
        c = self.rt.cluster
        by_name = lambda objs: sorted(objs, key=lambda o: o.metadata.name)  # noqa: E731
        events = []
        for row in c.cluster_events:
            _, kind, name, reason, msg = row
            count = max(c.event_count(kind, name, reason, msg, namespace=ns)
                        for ns in ("default", ""))
            events.append([self.norm(list(row)), count])
        return {
            "now": c.now,
            "jobs": [self.norm(j) for j in by_name(c.jobs.list())],
            "lmservices": [self.norm(s) for s in by_name(c.lmservices.list())],
            "pods": [self.norm(p) for p in by_name(c.pods.list())],
            "services": [self.norm(s) for s in by_name(c.services.list())],
            "slices": [[s.name, s.shape.accelerator_type,
                        self.norm(s.holder), s.healthy, list(s.hosts)]
                       for s in sorted(c.slice_pool.list(),
                                       key=lambda s: s.name)],
            "events": events,
            "queue_len": len(self.rt.controller.queue),
            "syncs": self._syncs(),
        }

    def _syncs(self):
        """The controller's syncs: their count, the no-op fingerprint's
        hits and misses and each sync's key, outcome and note."""
        c = self.rt.controller
        return [c.sync_count, c.syncs_skipped_noop, c.fp_misses,
                list(c.fp_stats()),
                [[self.norm(t.key), t.outcome, t.note, t.error]
                 for t in c.traces]]


# -- actions -----------------------------------------------------------------


def _apply_spec(side: Side, name: str, edit):
    """Server-side apply of an edited copy of the job's spec (the
    ``api/apply.py`` merge: spec replaced, runtime id and status kept)."""
    m = side.m
    cur = side.job(name)
    if cur is None:
        return
    new = m.core.thaw(cur)
    edit(new.spec)
    store = side.rt.cluster.jobs
    m.apply.apply_job_spec(lambda: store.try_get("default", name),
                           store.create, store.update, new)


def act(side: Side, action: tuple):
    """Take one action on one side. Actions that name something absent
    (a job not submitted, a job holding no slice) do nothing, on both sides
    alike: the two states are equal when an action is taken."""
    rt, m = side.rt, side.m
    op, *a = action
    if op == "pools":
        for accel, count in a[0].items():
            rt.cluster.slice_pool.add_pool(accel, count)
    elif op == "submit":
        if side.job(a[0]["name"]) is None:
            rt.submit(_job(m, a[0]))
    elif op == "step":
        side.step(*a)
    elif op == "drain":
        side.settle()
    elif op == "pod_policy":             # (job, pod index, policy kwargs)
        pods = side.pods_of(a[0])
        if a[1] < len(pods):
            rt.cluster.faults.pod_policies[pods[a[1]].metadata.name] = \
                m.cluster.PodRunPolicy(**a[2])
    elif op == "crash_pod":              # (job or lmservice, index)
        pods = side.pods_of(a[0]) or sorted(
            rt.client.list_pods("default", {m.naming.LABEL_LMSERVICE: a[0]}),
            key=lambda p: p.metadata.name)
        live = [p for p in pods if p.status.phase.value in ("Pending",
                                                            "Running")]
        if a[1] < len(live):
            rt.cluster.crash_pod("default", live[a[1]].metadata.name)
    elif op in ("preempt", "degrade"):   # (job, held slice index)
        held = side.held(a[0])
        if a[1] < len(held):
            side.slices.append(held[a[1]])
            if op == "preempt":
                rt.cluster.preempt_slice(held[a[1]])
            else:
                rt.cluster.degrade_slice(held[a[1]])
    elif op == "restore":                # the last slice preempted/degraded
        if side.slices:
            rt.cluster.slice_pool.restore(side.slices.pop())
    elif op == "mark_unhealthy":
        held = side.held(a[0])
        if a[1] < len(held):
            rt.cluster.slice_pool.mark_unhealthy(held[a[1]])
    elif op == "fail_pod_creates":
        rt.cluster.faults.fail_pod_creates = a[0]
    elif op == "suspend":                # (job, bool)
        _apply_spec(side, a[0], lambda s: setattr(s, "suspend", a[1]))
    elif op == "resize":                 # (job, num_slices)
        _apply_spec(side, a[0], lambda s: setattr(
            s.replica_specs[0].tpu, "num_slices", a[1])
            if s.replica_specs[0].tpu is not None else None)
    elif op == "accel":                  # (job, accelerator type)
        _apply_spec(side, a[0], lambda s: setattr(
            s.replica_specs[0].tpu, "accelerator_type", a[1])
            if s.replica_specs[0].tpu is not None else None)
    elif op == "strip_owners":           # orphan the job's pods
        for pod in side.pods_of(a[0]):
            pod = m.core.thaw(pod)
            pod.metadata.owner_references = []
            rt.cluster.pods.update(pod)
    elif op == "opt":                    # controller option
        setattr(rt.controller.opts, a[0], a[1])
    elif op == "resync":                 # informer resync, "job"/"all"
        infs = ([rt.job_informer] if a[0] == "job" else
                [rt.job_informer, rt.pod_informer, rt.service_informer,
                 rt.lmservice_informer])
        for inf in infs:
            inf.resync()
    elif op == "poke":                   # what a resync does to one key
        rt.controller.queue.add(a[0])
        side.settle()
    elif op == "restart_controller":
        side.restart_controller()
    elif op == "delete_job":
        if side.job(a[0]) is not None:
            rt.delete_job("default", a[0])
    elif op == "submit_lms":
        if rt.cluster.lmservices.try_get("default", a[0]) is None:
            rt.submit_lmservice(_lmservice(m, a[0], a[1]))
    elif op == "scale_lms":
        cur = rt.cluster.lmservices.try_get("default", a[0])
        if cur is not None:
            svc = m.core.thaw(cur)
            svc.spec.replicas = a[1]
            rt.cluster.lmservices.update(svc)
    elif op == "delete_lms":
        if rt.cluster.lmservices.try_get("default", a[0]) is not None:
            rt.delete_lmservice("default", a[0])
    elif op == "expect":                 # (job, phase value): a check
        job = side.job(a[0])
        got = None if job is None else job.status.phase.value
        assert got == a[1], (side.m.core.__name__, action, got)
    elif op == "expect_gone":
        assert side.job(a[0]) is None, action
    else:
        raise ValueError(f"unknown action {action}")


def run_parity(actions, policy, native=None):
    """Drive both packages through ``actions``; compare after each one."""
    jax_side = Side(PACKAGES[0], policy, native=native)
    port_side = Side(PACKAGES[1], policy, native=native)
    try:
        # Both sides took the same path: the C++ index on both, or on
        # neither.
        assert ((getattr(jax_side.rt.controller, "_nix", None) is None)
                == (getattr(port_side.rt.controller, "_nix", None) is None))
        assert jax_side.snapshot() == port_side.snapshot()
        for i, action in enumerate(actions):
            act(jax_side, action)
            act(port_side, action)
            a, b = jax_side.snapshot(), port_side.snapshot()
            if a != b:
                diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
                pytest.fail(f"snapshots differ after action {i} {action}: "
                            f"{diff}")
    finally:
        jax_side.rt.stop()
        port_side.rt.stop()
    return jax_side, port_side


# -- the scenarios: one per behaviour of the JAX controller's own tests -------

W = {"name": "job"}
RUN = {"start_delay": 1, "run_duration": 100}
LONG = {"start_delay": 1, "run_duration": 200}

SCENARIOS = {
    "local_success": (
        {"start_delay": 1, "run_duration": 3},
        [("submit", {"kind": "local", "name": "mnist"}), ("drain",),
         ("step", 1.0, 8), ("expect", "mnist", "Succeeded")]),
    "local_restart": (
        {"start_delay": 0, "run_duration": 2},
        [("submit", {"kind": "local", "name": "mnist"}), ("step", 1.0, 1),
         ("pod_policy", "mnist", 0,
          {"start_delay": 0, "run_duration": 1, "crash_code": 1}),
         ("step", 1.0, 10), ("expect", "mnist", "Succeeded")]),
    "local_budget_exhaustion": (
        {"start_delay": 0, "run_duration": 1, "exit_code": 7},
        [("submit", {"kind": "local", "name": "mnist", "max_restarts": 1}),
         ("step", 1.0, 10), ("expect", "mnist", "Failed")]),
    "gang_all_at_once": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-8": 2}), ("submit", W), ("drain",),
         ("step", 1.0, 3), ("expect", "job", "Running"),
         ("step", 1.0, 6), ("expect", "job", "Succeeded")]),
    "env_contract": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-8": 2}), ("submit", dict(W, num_slices=2)),
         ("drain",), ("step", 1.0, 2)]),
    "no_capacity_pending": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-32": 4}), ("submit", W), ("step", 1.0, 10),
         ("expect", "job", "Pending")]),
    "preemption_recovery": (
        RUN,
        [("pools", {"v5p-8": 2}), ("submit", W), ("step", 1.0, 4),
         ("expect", "job", "Running"), ("preempt", "job", 0),
         ("step", 1.0, 1), ("restore",), ("step", 1.0, 10),
         ("expect", "job", "Running")]),
    "unhealthy_slice": (
        {"start_delay": 1, "run_duration": 1000},
        [("pools", {"v5p-8": 2}), ("submit", W), ("step", 1.0, 4),
         ("degrade", "job", 0), ("resync", "job"), ("drain",),
         ("step", 1.0, 10), ("expect", "job", "Running")]),
    "unhealthy_slice_budget": (
        {"start_delay": 1, "run_duration": 1000},
        [("pools", {"v5p-8": 2}), ("submit", dict(W, max_restarts=0)),
         ("step", 1.0, 4), ("degrade", "job", 0), ("resync", "job"),
         ("step", 1.0, 5), ("expect", "job", "Failed")]),
    "worker_budget_exhaustion": (
        {"start_delay": 0, "run_duration": 1, "exit_code": 9},
        [("pools", {"v5p-8": 2}), ("submit", dict(W, max_restarts=0)),
         ("step", 1.0, 8), ("expect", "job", "Failed")]),
    "chief_termination": (
        {"start_delay": 0, "run_duration": 100},
        [("pools", {"v5p-8": 2}), ("submit", dict(W, chief=0)),
         ("step", 1.0, 1),
         ("pod_policy", "job", 0, {"start_delay": 0, "run_duration": 2}),
         ("step", 1.0, 8), ("expect", "job", "Succeeded")]),
    "deletion_cleanup": (
        RUN,
        [("pools", {"v5p-8": 2}), ("submit", W), ("step", 1.0, 4),
         ("delete_job", "job"), ("step", 1.0, 3)]),
    "create_failure_backoff": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-8": 2}), ("fail_pod_creates", 1), ("submit", W),
         ("drain",), ("step", 0.5, 20), ("expect", "job", "Succeeded")]),
    "create_failures_repeated": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-8": 2}), ("fail_pod_creates", 3), ("submit", W),
         ("step", 0.5, 20), ("expect", "job", "Succeeded")]),
    "orphan_adoption": (
        {"start_delay": 1, "run_duration": 3},
        [("pools", {"v5p-8": 2}), ("submit", W), ("drain",),
         ("strip_owners", "job"), ("step", 1.0, 2)]),
    "two_slice_survives_one_preemption": (
        RUN,
        [("pools", {"v5p-8": 3}), ("submit", dict(W, num_slices=2)),
         ("step", 1.0, 4), ("preempt", "job", 0), ("drain",),
         ("expect", "job", "Recovering"), ("step", 1.0, 10),
         ("expect", "job", "Running")]),
    "scale_down": (
        LONG,
        [("pools", {"v5p-8": 2}), ("submit", dict(W, num_slices=2)),
         ("step", 1.0, 4), ("resize", "job", 1), ("step", 1.0, 10),
         ("expect", "job", "Running")]),
    "scale_up": (
        LONG,
        [("pools", {"v5p-8": 2}), ("submit", W), ("step", 1.0, 4),
         ("resize", "job", 2), ("step", 1.0, 10),
         ("expect", "job", "Running")]),
    "resize_keeps_failure_budget": (
        LONG,
        [("pools", {"v5p-8": 3}),
         ("submit", dict(W, num_slices=2, max_restarts=1)),
         ("step", 1.0, 4), ("resize", "job", 1), ("step", 1.0, 10),
         ("preempt", "job", 0), ("restore",), ("step", 1.0, 12),
         ("expect", "job", "Running")]),
    "accelerator_change": (
        LONG,
        [("pools", {"v5p-8": 1, "v5e-8": 1}), ("submit", W),
         ("step", 1.0, 4), ("accel", "job", "v5e-8"), ("step", 1.0, 12),
         ("expect", "job", "Running")]),
    "crash_loop_exponential": (
        {"start_delay": 0, "run_duration": 1, "exit_code": 1},
        [("opt", "restart_backoff_base", 4.0), ("pools", {"v5p-8": 1}),
         ("submit", dict(W, max_restarts=3))]
        + [("step", 0.5, 4)] * 16 + [("expect", "job", "Failed")]),
    "resize_not_delayed_by_backoff": (
        LONG,
        [("opt", "restart_backoff_base", 1000.0), ("pools", {"v5p-8": 2}),
         ("submit", dict(W, num_slices=2)), ("step", 1.0, 4),
         ("preempt", "job", 0), ("restore",), ("step", 1.0, 10),
         ("resize", "job", 1), ("step", 1.0, 10)]),
    "ttl_positive": (
        {"start_delay": 1, "run_duration": 2},
        [("pools", {"v5p-8": 1}), ("submit", dict(W, ttl=10)),
         ("step", 1.0, 6), ("expect", "job", "Succeeded")]
        + [("step", 1.0, 2)] * 8 + [("expect_gone", "job")]),
    "ttl_zero": (
        {"start_delay": 0, "run_duration": 1},
        [("submit", {"kind": "local", "name": "mnist", "ttl": 0}),
         ("step", 1.0, 6), ("expect_gone", "mnist")]),
    "ttl_none": (
        {"start_delay": 0, "run_duration": 1},
        [("submit", {"kind": "local", "name": "mnist"}), ("step", 1.0, 30),
         ("expect", "mnist", "Succeeded")]),
    "suspend_resume": (
        LONG,
        [("pools", {"v5p-8": 1}), ("submit", W), ("step", 1.0, 4),
         ("suspend", "job", True), ("step", 1.0, 4),
         ("expect", "job", "Suspended"),
         ("submit", {"name": "intruder"}), ("step", 1.0, 4),
         ("suspend", "job", False), ("step", 1.0, 3),
         ("expect", "job", "Pending"), ("delete_job", "intruder"),
         ("step", 1.0, 8), ("expect", "job", "Running")]),
    "suspended_ignores_ttl": (
        LONG,
        [("pools", {"v5p-8": 1}), ("submit", dict(W, ttl=2)),
         ("step", 1.0, 4), ("suspend", "job", True), ("step", 1.0, 15),
         ("expect", "job", "Suspended")]),
    "steady_resync_writes_nothing": (
        {"start_delay": 1, "run_duration": 10000},
        [("pools", {"v5p-8": 2}), ("submit", {"name": "steady"}),
         ("step", 1.0, 8), ("resync", "all"), ("drain",),
         ("poke", "default/steady"), ("mark_unhealthy", "steady", 0),
         ("resync", "job"), ("step", 1.0, 5)]),
    "status_only_write_keeps_generation": (
        {"start_delay": 1, "run_duration": 10000},
        [("pools", {"v5p-8": 2}), ("submit", {"name": "steady"}),
         ("step", 1.0, 8), ("suspend", "steady", True), ("step", 1.0, 4),
         ("expect", "steady", "Suspended")]),
    "priority_orders_admission": (
        {"start_delay": 1, "run_duration": 5},
        [("pools", {"v5p-8": 1}), ("submit", {"name": "holder"}),
         ("step", 1.0, 3), ("submit", {"name": "low"}), ("step", 1.0, 2),
         ("submit", {"name": "high", "priority": 5}), ("step", 1.0, 8),
         ("expect", "high", "Running"), ("expect", "low", "Pending")]),
    "controller_restart_mid_gang": (
        RUN,
        [("pools", {"v5p-8": 2}), ("submit", W), ("drain",),
         ("restart_controller",), ("step", 1.0, 4),
         ("preempt", "job", 0), ("restart_controller",), ("restore",),
         ("step", 1.0, 10), ("expect", "job", "Running")]),
    # tests/test_fleet.py: TestLMServiceReconcile
    "lmservice_scale_up_to_ready": (
        {"start_delay": 1.0, "run_duration": 1e9},
        [("submit_lms", "chat", 3), ("step", 1.0, 4)]),
    "lmservice_scale_down_and_up": (
        {"start_delay": 1.0, "run_duration": 1e9},
        [("submit_lms", "chat", 3), ("step", 1.0, 4), ("scale_lms", "chat", 1),
         ("step", 1.0, 3), ("scale_lms", "chat", 2), ("step", 1.0, 4)]),
    "lmservice_crashed_replica_recreated": (
        {"start_delay": 1.0, "run_duration": 1e9},
        [("submit_lms", "chat", 2), ("step", 1.0, 4), ("crash_pod", "chat", 0),
         ("step", 1.0, 4)]),
    "lmservice_delete_cleans_up": (
        {"start_delay": 1.0, "run_duration": 1e9},
        [("submit_lms", "chat", 2), ("step", 1.0, 3),
         ("delete_lms", "chat"), ("step", 1.0, 3)]),
    "lmservice_degraded_while_starting": (
        {"start_delay": 1.0, "run_duration": 1e9},
        [("submit_lms", "chat", 2), ("drain",), ("step", 0.5, 1),
         ("step", 1.0, 2)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_snapshots_equal(name):
    policy, actions = SCENARIOS[name]
    run_parity(actions, policy)


def _soup(seed: int, n: int = 200):
    """A seeded random script over three jobs and one LMService."""
    r = random.Random(seed)
    jobs = {
        "a": {"name": "a", "num_slices": 1, "max_restarts": 2},
        "b": {"name": "b", "num_slices": 2, "max_restarts": 3, "ttl": 6},
        "c": {"kind": "local", "name": "c", "max_restarts": 1},
    }
    actions = [("pools", {"v5p-8": 3, "v5e-8": 1})]
    for _ in range(n):
        j = r.choice(sorted(jobs))
        x = r.random()
        if x < 0.18:
            actions.append(("submit", jobs[j]))
        elif x < 0.45:
            actions.append(("step", r.choice([0.5, 1.0, 2.0]),
                            r.randint(1, 3)))
        elif x < 0.50:
            actions.append(("crash_pod", j, r.randint(0, 1)))
        elif x < 0.55:
            actions.append(("preempt", j, r.randint(0, 1)))
        elif x < 0.59:
            actions.append(("degrade", j, 0))
            actions.append(("resync", "job"))
        elif x < 0.64:
            actions.append(("restore",))
        elif x < 0.67:
            actions.append(("fail_pod_creates", r.randint(1, 2)))
        elif x < 0.71:
            actions.append(("suspend", j, r.random() < 0.5))
        elif x < 0.75:
            actions.append(("resize", j, r.randint(1, 2)))
        elif x < 0.77:
            actions.append(("accel", j, r.choice(["v5p-8", "v5e-8"])))
        elif x < 0.80:
            actions.append(("restart_controller",))
        elif x < 0.84:
            actions.append(("delete_job", j))
        elif x < 0.88:
            actions.append(("submit_lms", "chat", r.randint(1, 3)))
        elif x < 0.92:
            actions.append(("scale_lms", "chat", r.randint(1, 3)))
        elif x < 0.94:
            actions.append(("delete_lms", "chat"))
        elif x < 0.97:
            actions.append(("crash_pod", "chat", r.randint(0, 2)))
        else:
            actions.append(("resync", "all"))
    return actions


@pytest.mark.parametrize("native", [None, False],
                         ids=["jax_default_index", "jax_python_index"])
def test_seeded_soup_snapshots_equal(native):
    run_parity(_soup(SEED), {"start_delay": 1, "run_duration": 6},
               native=native)


def test_native_fingerprints_outlive_a_controller_restart():
    """C13: the C++ object index lives with the cluster, so a restarted
    controller inherits its predecessor's committed fingerprints: its first
    resync of a steady job is a no-op skip, and ``fp_stats()`` keeps the
    hits and misses. The port's native core does the same as the JAX
    package's; on the pure-Python paths both restarted controllers start
    again from nothing, and their first sync runs in full."""
    acts = [("pools", {"v5p-8": 1}), ("submit", {"name": "j"}),
            ("step", 1.0, 4), ("resync", "all"), ("drain",),
            ("restart_controller",), ("poke", "default/j")]
    policy = {"start_delay": 1, "run_duration": 1e9}
    sides = [Side(pkg, policy, native=native)
             for native in (True, False) for pkg in PACKAGES]
    try:
        for side in sides:
            for a in acts:
                act(side, a)
        nix = [getattr(s.rt.controller, "_nix", None) is not None for s in sides]
        assert nix == [True, True, False, False]
        stats = [s.rt.controller.fp_stats() for s in sides]
        first = [s.rt.controller.traces[0].outcome for s in sides]
        assert stats[0] == stats[1] and stats[0][0] > 0
        assert first[0] == first[1] == "noop-skip"
        assert stats[2] == stats[3] == (0, 1)
        assert first[2] == first[3] == "steady"
        assert sides[0].snapshot() == sides[1].snapshot()
        assert sides[2].snapshot() == sides[3].snapshot()
    finally:
        for side in sides:
            side.rt.stop()


def test_port_refuses_the_native_index():
    """``use_native_index=True`` runs the port's C++ core (the cluster's
    index, the controller's queue and expectations and its probe); under
    ``TPUJOB_NATIVE=0`` it raises, as the JAX package does without its
    library, and never runs the Python index under that flag."""
    import os
    import subprocess
    import sys

    m = _mods(PACKAGES[1])
    from kubeflow_controller_tpu_torch.native.objindex import NativeObjectIndex
    from kubeflow_controller_tpu_torch.native.queue import (
        NativeControllerExpectations, NativeRateLimitingQueue,
    )

    rt = m.runtime.LocalRuntime(use_native_index=True)
    try:
        assert isinstance(rt.cluster.native_index, NativeObjectIndex)
        assert rt.controller._nix is rt.cluster.native_index
        assert isinstance(rt.controller.queue, NativeRateLimitingQueue)
        assert isinstance(rt.controller.expectations,
                          NativeControllerExpectations)
    finally:
        rt.stop()
    code = (
        "from kubeflow_controller_tpu_torch.runtime import LocalRuntime\n"
        "from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster\n"
        "for make in (LocalRuntime, FakeCluster):\n"
        "    try:\n"
        "        make(use_native_index=True)\n"
        "    except RuntimeError as e:\n"
        "        assert 'native object index' in str(e), e\n"
        "        assert 'TPUJOB_NATIVE=0' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error')\n"
        "rt = LocalRuntime()\n"
        "assert rt.cluster.native_index is None and rt.controller._nix is None\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env={**os.environ, "TPUJOB_NATIVE": "0"},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
