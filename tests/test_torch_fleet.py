"""The port's fleet router (``dataplane/router.py``) held against the JAX
package's, step by step, on the CPU.

Each package's router drives twin scripted fake engines: the same fake,
written once against that package's ``Completion``, ``Rejected``,
``Request`` and ``ServingStats`` (the engine surface the router reads:
submit, cancel, step, drain, the queue and slot counts, the stats'
heartbeat and TTFT reservoir, the injector's engine sites). Both
routers run under one fake clock, and after every fleet step their
assignments, parked retries (with their due times), outcomes, replica
health, completions and ``fleet_summary`` must be equal. The scenarios:
prefix affinity, failover on rejection, parking and the shed after
``max_retries``, cancel, kill, rolling restart, queue-depth and TTFT
health, the progress watchdog under an injected hang, deadline sheds,
and a fault soup (crashes, hangs, slow quanta, refused admissions,
dispatch timeouts) at two seeds, whose books must close.
"""

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import faults as jfaults
from kubeflow_controller_tpu.dataplane import metrics as jmetrics
from kubeflow_controller_tpu.dataplane import router as jrouter
from kubeflow_controller_tpu.dataplane import serving_engine as jse
from kubeflow_controller_tpu.obs import trace as jtrace
from kubeflow_controller_tpu_torch.dataplane import faults as tfaults
from kubeflow_controller_tpu_torch.dataplane import metrics as tmetrics
from kubeflow_controller_tpu_torch.dataplane import router as trouter
from kubeflow_controller_tpu_torch.dataplane import serving_engine as tse
from kubeflow_controller_tpu_torch.obs import trace as ttrace

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

PORT = SimpleNamespace(se=tse, metrics=tmetrics, router=trouter,
                       faults=tfaults, trace=ttrace)
JAX = SimpleNamespace(se=jse, metrics=jmetrics, router=jrouter,
                      faults=jfaults, trace=jtrace)


class FakeEngine:
    """The engine surface the router consumes, with scripted service: a
    request completes ``service_steps`` quanta after admission with one
    token a budget unit; prefix hits are counted on the block grid, as
    the real engine counts them; an injected hang or slow quantum (or
    ``wedged``) makes no progress and leaves the heartbeat alone."""

    def __init__(self, pkg, clock, n_slots=2, max_queue=4, service_steps=2,
                 block_size=4, injector=None):
        self.pkg = pkg
        self._clock = clock
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.service_steps = service_steps
        self.block_size = block_size
        self.queue = deque()
        self.active = {}
        self.stats = pkg.metrics.ServingStats(n_slots=n_slots)
        self._draining = False
        self._cancelled = set()
        self._done = []
        self._blocks = set()
        self.wedged = False
        self.injector = injector
        self.fault_target = ""
        self._slow_phase = 0
        self.slow_ttft = 0.0

    def submit(self, req):
        se = self.pkg.se
        if self.injector is not None and self.injector.fires(
                "engine", "engine.submit", target=self.fault_target,
                rid=req.rid, kinds=("refuse_admit",)) is not None:
            self.stats.faults_injected += 1
            self.stats.rejected += 1
            raise se.Rejected(req.rid, "fault_injected")
        if self._draining:
            self.stats.rejected += 1
            raise se.Rejected(req.rid, "draining")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats.rejected += 1
            raise se.Rejected(req.rid, "queue_full")
        self.queue.append([req, self._clock()])
        self.stats.submitted += 1

    def cancel(self, rid):
        for item in self.queue:
            if item[0].rid == rid:
                self.queue.remove(item)
                self._done.append(self.pkg.se.Completion(
                    rid=rid, tokens=[], finish_reason="cancelled",
                    submit_t=item[1], first_token_t=None,
                    done_t=self._clock()))
                return True
        if rid in self.active:
            self._cancelled.add(rid)
            return True
        return False

    def _admit(self):
        while self.queue and len(self.active) < self.n_slots:
            req, submit_t = self.queue.popleft()
            prompt = np.asarray(req.prompt, np.int32)
            self.stats.prefix_lookup_tokens += prompt.size
            n = (prompt.size // self.block_size) * self.block_size
            for end in range(self.block_size, n + 1, self.block_size):
                key = prompt[:end].tobytes()
                if key in self._blocks:
                    self.stats.prefix_hit_tokens += self.block_size
                else:
                    self._blocks.add(key)
            self.active[req.rid] = [req, submit_t, self._clock(),
                                    self.service_steps]
            self.stats.admitted += 1

    def step(self):
        if self.wedged:
            return []
        if self.injector is not None:
            spec = self.injector.fires(
                "engine", "engine.step", target=self.fault_target,
                kinds=("hang", "slow"))
            if spec is not None:
                self.stats.faults_injected += 1
                if spec.kind == "hang":
                    return []
                self._slow_phase += 1
                if self._slow_phase % max(1, int(spec.factor)) != 0:
                    return []
        self.stats.heartbeat += 1
        out, self._done = self._done, []
        now = self._clock()
        for rid in list(self.active):
            req, submit_t, admit_t, left = self.active[rid]
            if rid in self._cancelled:
                self._cancelled.discard(rid)
                del self.active[rid]
                out.append(self.pkg.se.Completion(
                    rid=rid, tokens=[], finish_reason="cancelled",
                    submit_t=submit_t, first_token_t=None, done_t=now,
                    admit_t=admit_t))
                continue
            left -= 1
            self.active[rid][3] = left
            if left <= 0:
                del self.active[rid]
                comp = self.pkg.se.Completion(
                    rid=rid, tokens=[rid % 7] * req.max_new_tokens,
                    finish_reason="length", submit_t=submit_t,
                    first_token_t=submit_t + self.slow_ttft, done_t=now,
                    admit_t=admit_t)
                self.stats.record(comp)
                out.append(comp)
        self._admit()
        return out

    @property
    def n_active(self):
        return len(self.active)

    @property
    def idle(self):
        return not self.queue and not self.active and not self._done

    def drain(self, grace_s=5.0):
        self._draining = True
        out, self._done = self._done, []
        now = self._clock()
        while self.queue:
            req, submit_t = self.queue.popleft()
            comp = self.pkg.se.Completion(
                rid=req.rid, tokens=[], finish_reason="shed",
                submit_t=submit_t, first_token_t=None, done_t=now)
            self.stats.record(comp)
            out.append(comp)
        for _ in range(self.service_steps + 1):
            if self.idle:
                break
            out.extend(self.step())
        return out


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _outcome(o):
    kind, payload = o
    if isinstance(payload, str) or payload is None:
        return kind, payload
    return kind, payload.finish_reason, list(payload.tokens)


def _state(r):
    """Everything the router decided so far, in plain values."""
    return dict(
        assigned=dict(r._assigned),
        parked=sorted((p.due_t, p.rid, p.attempt) for p in r._parked),
        outcomes={rid: _outcome(o) for rid, o in r._outcomes.items()},
        replicas=[(h.name, h.role, h.healthy, h.cordoned, h.strikes, h.clears,
                   h.hb_seen, h.hb_t, h.watchdog_hit) for h in r.replicas],
        completions=[(c.rid, c.gen, c.finish_reason, list(c.tokens))
                     for c in r.completions],
        owners=list(r._owners.items()),
        summary=r.fleet_summary(),
    )


def _twin(scenario, **kw):
    """Run ``scenario(pkg, clock, **kw)`` for both packages; it yields
    after every fleet action, and each yield's router state must be
    equal. Returns the port's last state."""
    states = []
    for pkg in (PORT, JAX):
        clock = Clock()
        states.append([_state(r) for r in scenario(pkg, clock, **kw)])
    got, want = states
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {k}"
    return got[-1]


def _req(pkg, rid, prompt, max_new=3, deadline_s=None):
    return pkg.se.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new, deadline_s=deadline_s)


def _fleet(pkg, clock, n=3, engine_kw=None, injector=None, **router_kw):
    r = pkg.router.FleetRouter(clock=clock, block_size=4, injector=injector,
                               **router_kw)
    for i in range(n):
        r.add_replica(f"r{i}", FakeEngine(pkg, clock, injector=injector,
                                          **(engine_kw or {})))
    return r


def _pump(r, clock, steps=40, dt=0.1):
    for _ in range(steps):
        clock.t += dt
        r.step()
        yield r
        if r.idle:
            return


def _books_close(s):
    sm = s["summary"]
    assert sm["submitted"] == sm["completed"] + sm["rejected"] + sm["cancelled"]
    assert sm["pending"] == 0
    done = [(c[0], c[1]) for c in s["completions"]]
    assert len(done) == len(set(done)), "a rid delivered twice"


# -- scenarios ------------------------------------------------------------------------

def affinity(pkg, clock, affinity=True):
    r = _fleet(pkg, clock, affinity=affinity)
    shared = list(range(100, 112))
    for i in range(9):
        tail = [i] * (1 + i % 3) if i % 3 else [200 + i] * 12
        r.submit(_req(pkg, i, (shared if i % 3 else []) + tail))
        yield r
    yield from _pump(r, clock)


def failover_and_shed(pkg, clock):
    r = _fleet(pkg, clock, n=2, engine_kw=dict(n_slots=1, max_queue=1),
               max_retries=2, retry_base_s=0.05, retry_max_s=0.2)
    for i in range(10):
        r.submit(_req(pkg, i, [i] * 5))
        yield r
    yield from _pump(r, clock, steps=60, dt=0.03)


def cancel(pkg, clock):
    r = _fleet(pkg, clock, n=1, engine_kw=dict(n_slots=1, max_queue=1,
                                               service_steps=4),
               retry_base_s=1.0)
    for i in range(4):
        r.submit(_req(pkg, i, [i] * 5))
    yield r
    clock.t += 0.1
    r.step()
    yield r
    assert r.cancel(3)                 # parked
    assert r.cancel(1)                 # queued in the replica
    assert r.cancel(0)                 # in flight
    assert not r.cancel(3)
    yield r
    yield from _pump(r, clock, steps=80)


def kill(pkg, clock):
    r = _fleet(pkg, clock, engine_kw=dict(service_steps=3))
    for i in range(8):
        r.submit(_req(pkg, i, [i % 3] * 8 + [i]))
    yield r
    clock.t += 0.1
    r.step()
    yield r
    moved = r.kill("r1")
    assert moved
    yield r
    assert r.kill("nope") == []
    yield from _pump(r, clock)


def rolling_restart(pkg, clock):
    r = _fleet(pkg, clock, engine_kw=dict(service_steps=3, max_queue=8))
    for i in range(12):
        r.submit(_req(pkg, i, [i] * 6))
    clock.t += 0.1
    r.step()
    yield r
    r.rolling_restart(lambda name: FakeEngine(pkg, clock, max_queue=8),
                      grace_s=0.0)
    yield r
    yield from _pump(r, clock)


def health(pkg, clock):
    r = _fleet(pkg, clock, n=2, engine_kw=dict(n_slots=1, max_queue=8,
                                               service_steps=3),
               eject_queue_depth=3, ttft_slo_ms=150.0, eject_after=2,
               readmit_after=2, ttft_window=4)
    r.replicas[1].engine.slow_ttft = 0.5      # its TTFTs break the SLO
    for i in range(12):
        r.submit(_req(pkg, i, [i] * 6))
        if i % 3 == 0:
            clock.t += 0.1
            r.step()
        yield r
    yield from _pump(r, clock, steps=80)


def watchdog(pkg, clock):
    plan = pkg.faults.FaultPlan.from_dict({"specs": [
        {"kind": "hang", "site": "engine.step", "target": "r0",
         "after": 0.15, "until": 1.2}]})
    inj = pkg.faults.FaultInjector(plan, clock=clock)
    tr = pkg.trace.Tracer(clock=clock)
    r = _fleet(pkg, clock, n=2, injector=inj, watchdog_stale_s=0.3,
               eject_after=2, readmit_after=2, tracer=tr,
               engine_kw=dict(service_steps=3, max_queue=8))
    for i in range(8):
        r.submit(_req(pkg, i, [i] * 6))
        yield r
    yield from _pump(r, clock, steps=80)
    assert r.watchdog_strikes > 0 and r.redispatched > 0
    assert inj.total_fires > 0


def deadlines(pkg, clock):
    r = _fleet(pkg, clock, n=1, engine_kw=dict(n_slots=1, max_queue=1,
                                               service_steps=3),
               max_retries=6, retry_base_s=0.2, retry_max_s=1.0)
    for i in range(6):
        r.submit(_req(pkg, i, [i] * 5, deadline_s=0.25 + 0.2 * i))
        yield r
    yield from _pump(r, clock, steps=80)
    assert r.deadline_sheds > 0


def soup(pkg, clock, seed):
    plan = pkg.faults.FaultPlan.from_dict({"specs": [
        {"kind": "crash", "site": "router.replica_step", "target": "r2",
         "after": 0.5, "max_fires": 1},
        {"kind": "hang", "site": "engine.step", "target": "r0",
         "after": 0.3, "until": 0.9},
        {"kind": "slow", "site": "engine.step", "target": "r1",
         "factor": 2.0, "after": 1.0, "until": 2.0},
        {"kind": "refuse_admit", "site": "engine.submit", "prob": 0.3},
        {"kind": "hang", "site": "router.dispatch", "prob": 0.2,
         "max_fires": 4},
    ]})
    inj = pkg.faults.FaultInjector(plan, clock=clock, seed=seed)
    r = _fleet(pkg, clock, n=3, injector=inj, watchdog_stale_s=0.25,
               engine_kw=dict(service_steps=2, max_queue=3),
               max_retries=5, retry_base_s=0.05, retry_max_s=0.4)
    rng = np.random.default_rng(seed)
    rid = 0
    for _ in range(12):
        for _ in range(int(rng.integers(1, 4))):
            prompt = [int(rng.integers(0, 3))] * 8 + [rid]
            r.submit(_req(pkg, rid, prompt,
                          deadline_s=None if rid % 4 else 2.0))
            rid += 1
        if rid % 5 == 0:
            r.cancel(rid - 2)
        clock.t += 0.1
        r.step()
        yield r
    yield from _pump(r, clock, steps=200)
    assert inj.total_fires > 0


SCENARIOS = {
    "affinity": (affinity, {}),
    "random_dispatch": (affinity, dict(affinity=False)),
    "failover_and_shed": (failover_and_shed, {}),
    "cancel": (cancel, {}),
    "kill": (kill, {}),
    "rolling_restart": (rolling_restart, {}),
    "health": (health, {}),
    "watchdog": (watchdog, {}),
    "deadlines": (deadlines, {}),
    "soup_seed0": (soup, dict(seed=0)),
    "soup_seed5": (soup, dict(seed=5)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_decisions_equal_jax(name):
    """Under one fake clock the two routers take the same decisions at
    every step, and the fleet's books close: every submitted rid ends in
    exactly one outcome, and none is delivered twice."""
    fn, kw = SCENARIOS[name]
    last = _twin(fn, **kw)
    _books_close(last)
    sm = last["summary"]
    if name == "affinity":
        assert sm["affinity_hits"] > 0
    if name == "failover_and_shed":
        assert sm["retries"] > 0 and sm["rejected"] > 0
    if name == "cancel":
        assert sm["cancelled"] == 3
    if name in ("kill", "rolling_restart"):
        assert sm["redispatched"] > 0 and sm["rejected"] == 0
        assert sm["completed"] == sm["submitted"]
    if name == "health":
        assert sm["ejections"] > 0 and sm["readmissions"] > 0
    if name.startswith("soup"):
        assert sm["faults_injected"] > 0
        assert sm["watchdog_strikes"] + sm["dispatch_timeouts"] > 0


def test_backoff_delay_equals_workqueue_curve():
    """The router's copy of the workqueue's backoff gives the same
    doubles."""
    from kubeflow_controller_tpu.controller.workqueue import backoff_delay

    for item in (0, 7, "rid-3", 123456):
        for failures in (0, 1, 5, 31, 32, 40):
            assert trouter.backoff_delay(0.05, 2.0, item, failures) == \
                backoff_delay(0.05, 2.0, item, failures)


def test_membership_checks_and_names_equal_jax():
    assert trouter.OUTCOMES == jrouter.OUTCOMES
    assert trouter.ROLES == jrouter.ROLES
    clock = Clock()
    for pkg in (PORT, JAX):
        r = pkg.router.FleetRouter(clock=clock)
        r.add_replica("a", FakeEngine(pkg, clock))
        with pytest.raises(ValueError, match="already registered"):
            r.add_replica("a", FakeEngine(pkg, clock))
        with pytest.raises(ValueError, match="role must be one of"):
            r.add_replica("b", FakeEngine(pkg, clock), role="leader")
        r.submit(_req(pkg, 1, [1, 2, 3, 4]))
        with pytest.raises(ValueError, match="duplicate rid"):
            r.submit(_req(pkg, 1, [1, 2, 3, 4]))
        assert not r.two_stage and r.pending == 1
        with pytest.raises(RuntimeError, match="did not go idle"):
            r.get_replica("a").engine.wedged = True
            r.run_until_idle(max_steps=3)


# -- sync_fleet_from_pods: the control plane's pods become replicas ----------


def _lms_sync_run(pkg_name, replicas, prefill):
    """One package's LocalRuntime serving an LMService, and its router
    synced from the service's pods: after the pods first run, again with
    nothing changed, after a crash of the first decode pod (the controller
    deletes and recreates it), and after the recreated pod runs. The
    cases of tests/test_fleet.py:500-525 and tests/test_disagg.py:449-503.
    Returns every sync's (added, removed) with the router's membership
    and roles after it."""
    import importlib
    import random

    imp = importlib.import_module
    pkg = PORT if pkg_name.endswith("_torch") else JAX
    core, types = imp(f"{pkg_name}.api.core"), imp(f"{pkg_name}.api.types")
    naming = imp(f"{pkg_name}.tpu.naming")
    rt = imp(f"{pkg_name}.runtime").LocalRuntime(
        default_policy=imp(f"{pkg_name}.cluster.cluster").PodRunPolicy(
            start_delay=0.1, run_duration=1e9))
    rt.controller.opts.rng = random.Random(3)    # the same runtime ids
    clock = Clock()
    router = pkg.router.FleetRouter(clock=clock, block_size=4)

    def engine(name):
        eng = FakeEngine(pkg, clock)
        eng.prefill_mode = "bucketed"
        return eng

    def pods():
        return sorted(rt.client.list_pods(
            "default", {naming.LABEL_LMSERVICE: "chat"}),
            key=lambda p: p.metadata.name)

    def sync():
        added, removed = pkg.router.sync_fleet_from_pods(router, pods(), engine)
        return (added, removed, sorted((h.name, h.role) for h in router.replicas),
                router.two_stage)

    try:
        rt.submit_lmservice(types.LMService(
            metadata=core.ObjectMeta(name="chat", namespace="default"),
            spec=types.LMServiceSpec(model="tiny", replicas=replicas,
                                     prefill_replicas=prefill)))
        assert rt.run_until(lambda: (
            (s := rt.get_lmservice("default", "chat")) is not None
            and s.status.ready_replicas == replicas))
        out = [sync(), sync()]
        victim = next(p.metadata.name for p in pods()
                      if p.metadata.labels[naming.LABEL_ROLE] != "prefill")
        rt.cluster.crash_pod("default", victim)
        rt.controller.drain()
        out.append(sync())
        assert rt.run_until(lambda: len(pods()) == replicas and all(
            p.status.phase.value == "Running" for p in pods()))
        out.append(sync())
    finally:
        rt.stop()
    return victim, out


@pytest.mark.parametrize("replicas,prefill", [(2, 0), (3, 1)],
                         ids=["mixed_pair", "one_prefill_two_decode"])
def test_sync_fleet_from_pods_equals_jax(replicas, prefill):
    victim, port = _lms_sync_run("kubeflow_controller_tpu_torch", replicas, prefill)
    jvictim, jax = _lms_sync_run("kubeflow_controller_tpu", replicas, prefill)
    assert (victim, port) == (jvictim, jax)
    first, again, crashed, back = port
    assert len(first[0]) == replicas and not first[1]
    assert again[:2] == ([], [])
    assert crashed[:2] == ([], [victim])
    assert back[:2] == ([victim], [])
    assert back[2] == first[2] and len(back[2]) == replicas
    roles = sorted(role for _, role in first[2])
    assert roles == (["decode", "decode", "prefill"] if prefill
                     else ["mixed", "mixed"])
    assert first[3] == bool(prefill)
