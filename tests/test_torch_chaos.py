"""The mirror of ``tests/test_chaos.py`` on the port: the gang and
expectations interplay and controller-restart recovery of
``kubeflow_controller_tpu_torch``'s control plane under injected faults,
and a preempted serving job draining its partials on the port's engine.

Every case and seed of the reference file is kept, with its assertions
on the port. The single-threaded crash-recovery cases
(``TestControllerRestartRecovery``) also run on the JAX package, and
their outcomes are compared: each job's phase and restarts, its pods'
gang index, epoch and phase, its services, and the create events. The
threaded and wall-clock cases (threaded restart and soak, the swap over
REST, the seeded soak) are held to the reference's invariants.

``TestServingChaosDrain`` keeps every assertion of the reference and
makes its premise hold by construction. The reference's epoch 0 steps
until the first token is out and is preempted whenever the test's main
thread gets there, so whether a request has used its whole 150-token
budget by then is a race: the port's engine runs eagerly and decodes
faster on the CPU than the JAX engine, whose first steps compile. Here epoch 0 serves the
four requests in four slots, steps until every request holds at least
one decoded token, signals, and then steps no more until the stop
signal: no request can reach its budget before the preemption. Epoch
1's streams equal the JAX engine's run of the same requests, and each
epoch-0 partial is a prefix of that run's stream.
"""

import importlib
import os
import random

import pytest
import torch

from kubeflow_controller_tpu_torch.api.core import ObjectMeta, PodPhase
from kubeflow_controller_tpu_torch.api.types import (
    JobPhase, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec,
)
from kubeflow_controller_tpu_torch.api.validation import expected_worker_pods
from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
from kubeflow_controller_tpu_torch.runtime import LocalRuntime
from kubeflow_controller_tpu_torch.tpu import naming

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")


def _api(pkg="kubeflow_controller_tpu_torch"):
    imp = importlib.import_module
    core, types = imp(f"{pkg}.api.core"), imp(f"{pkg}.api.types")
    return core, types


def template(pkg="kubeflow_controller_tpu_torch"):
    core, _ = _api(pkg)
    return core.PodTemplateSpec(
        spec=core.PodSpec(containers=[core.Container(name="trainer", image="jax:latest")]))


def worker_job(name, accel="v5p-8", num_slices=1, max_restarts=10,
               pkg="kubeflow_controller_tpu_torch"):
    core, t = _api(pkg)
    return t.TPUJob(
        metadata=core.ObjectMeta(name=name, namespace="default"),
        spec=t.TPUJobSpec(replica_specs=[t.ReplicaSpec(
            replica_type=t.ReplicaType.WORKER,
            template=template(pkg),
            tpu=t.TPUSliceSpec(accelerator_type=accel, num_slices=num_slices),
            max_restarts=max_restarts,
        )]),
    )


def local_job(name, max_restarts=10):
    return TPUJob(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=TPUJobSpec(replica_specs=[ReplicaSpec(
            replica_type=ReplicaType.LOCAL,
            template=template(),
            max_restarts=max_restarts,
        )]),
    )


def job_pods(rt, job):
    """Pods actually owned by this job (by controller ref uid)."""
    out = []
    for p in rt.cluster.pods.list("default"):
        ref = p.metadata.controller_ref()
        if ref is not None and ref.uid == job.metadata.uid:
            out.append(p)
    return out


class TestControllerRestartRecovery:
    """Kill the controller inside the create window, bring up a fresh one
    over the same store, and require it to complete the gang with no
    duplicates; the JAX package's controller, driven alike, ends in the
    same state."""

    def make_runtime(self, pkg):
        imp = importlib.import_module
        cluster, runtime = imp(f"{pkg}.cluster.cluster"), imp(f"{pkg}.runtime")
        rt = runtime.LocalRuntime(cluster.PodRunPolicy(start_delay=1, run_duration=3))
        rt.cluster.slice_pool.add_pool("v5p-8", 2)
        return rt

    @staticmethod
    def outcome(rt, name="job"):
        """What the recovery left: the job's phase and restarts, its pods'
        (gang index, epoch, phase), its services and the create events
        (kind, reason)."""
        job = rt.get_job("default", name)
        pods = sorted((p.metadata.labels[naming.LABEL_INDEX],
                       p.metadata.labels[naming.LABEL_EPOCH], p.status.phase.value)
                      for p in job_pods(rt, job))
        creates = sorted((e[1], e[3]) for e in rt.cluster.cluster_events
                         if e[3] == "SuccessfulCreate")
        return (job.status.phase.value, job.status.restarts, pods,
                len(rt.cluster.services.list("default")), creates)

    def both(self, scenario):
        """``scenario(pkg, rt)`` on a fresh runtime of each package; the
        port's outcome, after checking that it equals the JAX package's."""
        from test_torch_native import load_jax_native

        load_jax_native()           # both controllers on their C++ cores
        outs = []
        for pkg in PACKAGES:
            rt = self.make_runtime(pkg)
            scenario(pkg, rt)
            outs.append(self.outcome(rt))
        assert outs[1] == outs[0]
        return outs[1]

    def test_crash_between_service_and_pod_creates(self):
        def scenario(pkg, rt):
            # Both pod creates fail: the first sync creates ONLY the
            # coordinator service, then dies.
            rt.cluster.faults.fail_pod_creates = 2
            rt.submit(worker_job("job", pkg=pkg))
            rt.controller.drain()
            assert len(rt.cluster.services.list("default")) == 1
            assert len(rt.cluster.pods.list("default")) == 0
            rt.restart_controller()  # fresh informers/queue/expectations
            assert rt.wait_for_phase("default", "job", _phase(pkg, "SUCCEEDED"))

        phase, _, pods, _, creates = self.both(scenario)
        assert phase == "Succeeded"
        # the gang completed exactly once: 2 pods (v5p-8 = 2 hosts), 1 service
        assert len(pods) == 2
        assert sorted(p[0] for p in pods) == ["0", "1"]
        # and no second coordinator service was ever created
        assert creates.count(("Service", "SuccessfulCreate")) == 1

    def test_crash_mid_pod_batch(self):
        def scenario(pkg, rt):
            client = importlib.import_module(f"{pkg}.cluster.client")
            # One pod lands, the second create fails mid-batch; the
            # controller "dies" on the spot (a single sync, no retry loop).
            rt.cluster.faults.fail_pod_creates_after = 1
            rt.cluster.faults.fail_pod_creates = 1
            rt.submit(worker_job("job", pkg=pkg))
            with pytest.raises(client.PodCreateRefused):
                rt.controller.sync("default/job")
            assert len(rt.cluster.pods.list("default")) == 1
            rt.restart_controller()
            assert rt.wait_for_phase("default", "job", _phase(pkg, "SUCCEEDED"))

        _, _, pods, _, creates = self.both(scenario)
        # completion, not duplication: the fresh controller created only
        # the missing index
        assert len(pods) == 2
        assert creates.count(("Pod", "SuccessfulCreate")) == 2

    def test_restart_during_gang_restart_window(self):
        """Crash after the epoch bump but before the new gang exists: the
        persisted epoch makes recovery unambiguous for the successor."""
        def scenario(pkg, rt):
            cluster = importlib.import_module(f"{pkg}.cluster.cluster")
            rt.cluster.default_policy = cluster.PodRunPolicy(start_delay=1, run_duration=100)
            rt.submit(worker_job("job", pkg=pkg))
            assert rt.wait_for_phase("default", "job", _phase(pkg, "RUNNING"), max_steps=10)
            job = rt.get_job("default", "job")
            held = rt.cluster.slice_pool.holdings(job.metadata.uid)[0].name
            rt.cluster.preempt_slice(held)
            # The next sync bumps the epoch and deletes the dead gang, but
            # every create of the new gang fails; then the controller dies.
            rt.cluster.faults.fail_pod_creates = 10
            rt.controller.drain()
            rt.cluster.tick()
            rt.cluster.faults.fail_pod_creates = 0
            rt.cluster.slice_pool.restore(held)
            rt.restart_controller()
            rt.cluster.default_policy = cluster.PodRunPolicy(start_delay=1, run_duration=3)
            assert rt.wait_for_phase("default", "job", _phase(pkg, "SUCCEEDED"),
                                     max_steps=60)

        _, restarts, pods, _, _ = self.both(scenario)
        assert restarts >= 1
        # every surviving pod belongs to the final epoch: no zombie epochs
        for _, epoch, _ in pods:
            assert epoch == str(restarts)


def _phase(pkg, name):
    return getattr(_api(pkg)[1].JobPhase, name)


class TestThreadedRestart:
    def test_restart_in_threaded_mode_keeps_reconciling(self):
        """restart_controller hands the successor worker threads too: a
        restarted controller whose queue has no consumers reconciles
        nothing (threaded mode is the production topology)."""
        import time as _time

        rt = LocalRuntime(PodRunPolicy(start_delay=0.05, run_duration=0.1))
        rt.start_threads(workers=2, tick_interval=0.02)
        try:
            rt.restart_controller()
            rt.submit(local_job("after-restart"))
            deadline = _time.time() + 10
            while _time.time() < deadline:
                j = rt.get_job("default", "after-restart")
                if j and j.status.phase == JobPhase.SUCCEEDED:
                    break
                _time.sleep(0.05)
            j = rt.get_job("default", "after-restart")
            assert j.status.phase == JobPhase.SUCCEEDED
        finally:
            rt.stop()


class TestThreadedSoak:
    def test_threaded_workers_under_random_faults_converge(self):
        """Wall-clock soak of the goroutine topology: 2 worker threads and
        a ticker racing a seeded random fault schedule (preemptions,
        crashes, controller swaps, job churn)."""
        import time as _time

        rng = random.Random(0xBEEF)
        rt = LocalRuntime(PodRunPolicy(start_delay=0.05, run_duration=0.4))
        rt.controller.opts.restart_backoff_base = 0.2
        rt.controller.opts.backoff_poll = 0.005
        rt.cluster.slice_pool.add_pool("v5p-8", 3)
        rt.start_threads(workers=2, tick_interval=0.02)
        jobs = {}
        counter = 0

        def submit():
            nonlocal counter
            counter += 1
            name = f"soak-{counter}"
            kind = rng.choice(["gang", "loc"])
            j = worker_job(name) if kind == "gang" else local_job(name)
            jobs[name] = rt.submit(j)

        try:
            for _ in range(3):
                submit()
            end = _time.time() + 6.0
            while _time.time() < end:
                r = rng.random()
                if r < 0.15:
                    held = [s for s in rt.cluster.slice_pool.list() if s.holder]
                    if held:
                        s = rng.choice(held)
                        rt.cluster.preempt_slice(s.name)
                        rt.cluster.slice_pool.restore(s.name)
                elif r < 0.30:
                    running = [p for p in rt.cluster.pods.list("default")
                               if p.status.phase == PodPhase.RUNNING]
                    if running:
                        p = rng.choice(running)
                        try:
                            rt.cluster.crash_pod("default", p.metadata.name)
                        except Exception:
                            pass  # finished/deleted under our feet: fine
                elif r < 0.38:
                    rt.restart_controller()
                elif r < 0.5 and len(jobs) < 6:
                    submit()
                _time.sleep(rng.uniform(0.05, 0.2))

            # storm over: everything must converge while threads keep running
            deadline = _time.time() + 30
            while _time.time() < deadline:
                phases = [(j := rt.get_job("default", n)) and j.status.phase for n in jobs]
                if all(p in (JobPhase.SUCCEEDED, JobPhase.FAILED) for p in phases):
                    break
                _time.sleep(0.1)
            for n in jobs:
                j = rt.get_job("default", n)
                assert j is not None and j.status.phase in (
                    JobPhase.SUCCEEDED, JobPhase.FAILED
                ), (n, j and j.status.phase, j and j.status.reason)
            for n, j0 in jobs.items():
                assert not rt.cluster.slice_pool.holdings(j0.metadata.uid)
            assert not rt.cluster.services.list("default")
        finally:
            rt.stop()


class TestWireChaos:
    def test_gang_survives_preemption_and_controller_swap_over_rest(self):
        """A gang job driven only over the REST seam survives a slice
        preemption and a full controller-process replacement (the old
        process dies mid-recovery, a new one connects to the same
        apiserver and finishes the job)."""
        import time as _time

        from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster
        from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
        from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

        cluster = FakeCluster(PodRunPolicy(start_delay=0.1, run_duration=60))
        cluster.slice_pool.add_pool("v5p-8", 2)
        server = RestServer(cluster).start()

        def tick_until(predicate, deadline_s=30):
            deadline = _time.time() + deadline_s
            while _time.time() < deadline:
                cluster.tick(0.05)
                if predicate():
                    return True
                _time.sleep(0.02)
            return predicate()

        rt = RemoteRuntime(server.url, resync_period=0.5)
        try:
            rt.start(workers=2)
            rt.client.create_job(worker_job("wire"))
            assert tick_until(lambda: (
                (j := rt.client.get_job("default", "wire")) is not None
                and j.status.phase == JobPhase.RUNNING
            ))
            job = rt.client.get_job("default", "wire")
            held = cluster.slice_pool.holdings(job.metadata.uid)
            cluster.preempt_slice(held[0].name)
            # give the doomed controller a moment to observe the failure,
            # then kill it mid-recovery
            tick_until(lambda: False, deadline_s=0.5)
        finally:
            rt.stop()

        cluster.slice_pool.restore(held[0].name)
        # jobs finish fast under the successor
        cluster.default_policy = PodRunPolicy(start_delay=0.1, run_duration=0.3)
        rt2 = RemoteRuntime(server.url, resync_period=0.5)
        try:
            rt2.start(workers=2)
            assert tick_until(lambda: (
                (j := rt2.client.get_job("default", "wire")) is not None
                and j.status.phase == JobPhase.SUCCEEDED
            ), deadline_s=30), rt2.client.get_job("default", "wire").status
            job = rt2.client.get_job("default", "wire")
            assert job.status.restarts >= 1
            # every pod belongs to the final epoch; gang size exact
            final = [p for p in cluster.pods.list("default")
                     if p.metadata.labels.get(naming.LABEL_EPOCH) == str(job.status.restarts)]
            assert len(final) == 2
        finally:
            rt2.stop()
            server.stop()


#: The serving job's engine: the reference's (max_seq 160, decode chunks
#: of 2) with a slot for each of its four requests, so that every request
#: is mid-decode when the preemption lands.
DRAIN_ENGINE_KW = dict(n_slots=4, max_seq=160, decode_chunk=2)
DRAIN_BUDGET = 150        # epoch 0's budget, far beyond what it decodes
DRAIN_EPOCH1_TOKENS = 8


def _jax_drain_twin(prompts):
    """The JAX engine's run of epoch 1's requests (``tiny_config``, the
    same weights): ``{rid: tokens}``."""
    import jax

    from kubeflow_controller_tpu.dataplane.serving_engine import (
        Request as JRequest, ServingEngine as JEngine,
    )
    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm

    cfg = jtfm.tiny_config()
    params = jgen.inference_params(cfg, jtfm.init_params(cfg, jax.random.key(0)))
    eng = JEngine(cfg, params, **DRAIN_ENGINE_KW)
    comps = eng.run([JRequest(rid=i, prompt=prompts[i], max_new_tokens=DRAIN_EPOCH1_TOKENS)
                     for i in range(len(prompts))])
    jax.clear_caches()
    return {c.rid: [int(t) for t in c.tokens] for c in comps}, jax.device_get(params)


class TestServingChaosDrain:
    """A serving-shaped job under preemption: the controller's job is
    gang-restarting under backoff, the engine's job is to drain with
    partial completions instead of hanging or discarding work. Epoch 0
    serves until the preemption's stop signal, drains, and exits like a
    killed container; epoch 1 re-serves to completion."""

    def test_preempted_serving_job_drains_partials_and_restarts(self):
        import threading

        import numpy as np

        from kubeflow_controller_tpu_torch.convert import params_from_numpy
        from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
            Request, ServingEngine,
        )
        from kubeflow_controller_tpu_torch.models import transformer as tfm

        prompts = np.random.default_rng(7).integers(
            0, tfm.tiny_config().vocab_size, (4, 6)).astype(np.int32)
        twin, jparams = _jax_drain_twin(prompts)
        cfg = tfm.tiny_config()
        params = params_from_numpy(jparams, device="cpu")
        # One engine reused across epochs; only gang index 0 drives it,
        # so epochs never overlap on it.
        engine = ServingEngine(cfg, params, device="cpu", attn_impl="gather",
                               **DRAIN_ENGINE_KW)

        stop = threading.Event()      # the preemption's SIGTERM analog
        decoded = threading.Event()   # epoch 0 really is mid-decode
        drained = threading.Event()   # epoch 0 released the engine
        partial: list = []
        full: list = []

        def mid_decode():
            """Every request admitted and holding a decoded token."""
            live = [s for s in engine.slots if s is not None]
            return (not engine.queue and len(live) == len(prompts)
                    and all(s.tokens for s in live))

        def run_serving(pod):
            epoch = pod.metadata.labels[naming.LABEL_EPOCH]
            if pod.metadata.labels[naming.LABEL_INDEX] != "0":
                if epoch == "0":
                    stop.wait(60)
                    return 137
                return 0
            if epoch == "0":
                engine.reset()
                for i in range(len(prompts)):
                    engine.submit(Request(rid=i, prompt=prompts[i],
                                          max_new_tokens=DRAIN_BUDGET))
                while not mid_decode() and not engine.idle:
                    partial.extend(engine.step())
                decoded.set()
                # No step until the preemption: what epoch 0 holds when it
                # lands is what it held here.
                stop.wait(60)
                # zero grace: in-flight slots retire as "deadline" partials
                partial.extend(engine.drain(grace_s=0.0))
                drained.set()
                return 137            # preempted container exit
            # The restarted pod waits for the old container's drain to
            # release the engine.
            assert drained.wait(60)
            engine.reset()
            full.extend(engine.run([
                Request(rid=i, prompt=prompts[i], max_new_tokens=DRAIN_EPOCH1_TOKENS)
                for i in range(len(prompts))
            ]))
            return 0

        rt = LocalRuntime(PodRunPolicy(start_delay=1, run_fn=run_serving))
        rt.cluster.slice_pool.add_pool("v5p-8", 2)
        rt.controller.opts.restart_backoff_base = 0.2
        rt.controller.opts.backoff_poll = 0.005
        rt.submit(worker_job("serve-job"))
        assert rt.wait_for_phase("default", "serve-job", JobPhase.RUNNING, max_steps=20)
        assert decoded.wait(60), "engine never started decoding"

        job = rt.get_job("default", "serve-job")
        held = rt.cluster.slice_pool.holdings(job.metadata.uid)[0].name
        rt.cluster.preempt_slice(held)
        stop.set()                    # the kubelet's SIGTERM to the pod
        rt.cluster.slice_pool.restore(held)

        assert rt.wait_for_phase("default", "serve-job", JobPhase.SUCCEEDED, max_steps=200)
        job = rt.get_job("default", "serve-job")
        assert job.status.restarts >= 1   # gang-restarted under backoff

        # Epoch 0 drained PARTIAL completions: every request came back
        # with a typed finish reason, none ran to its 150-token budget,
        # and at least one carried real tokens (it was mid-decode).
        assert {c.rid for c in partial} == {0, 1, 2, 3}
        assert all(c.finish_reason in ("deadline", "shed", "length") for c in partial)
        assert all(len(c.tokens) < DRAIN_BUDGET for c in partial)
        assert any(c.tokens for c in partial)
        # Epoch 1 served the workload to completion after the restart.
        assert {c.rid for c in full} == {0, 1, 2, 3}
        assert all(c.finish_reason == "length" and len(c.tokens) == DRAIN_EPOCH1_TOKENS
                   for c in full)
        # Greedy streams are deterministic: epoch 1's are the JAX
        # engine's, and each partial is a prefix of its request's stream
        # as far as both go.
        assert {c.rid: [int(t) for t in c.tokens] for c in full} == twin
        for c in partial:
            n = min(len(c.tokens), DRAIN_EPOCH1_TOKENS)
            assert [int(t) for t in c.tokens[:n]] == twin[c.rid][:n], c.rid


class TestChaosSoak:
    """A seeded random fault schedule (preemptions, pod crashes, create
    failures, admission delays, controller crashes, job churn) over
    thousands of simulated seconds, with invariants checked every tick
    and full convergence required once the storm stops."""

    # Scale the storm with TPUJOB_SOAK_ITERS and TPUJOB_SOAK_SEED, as the
    # reference's (plain decimal ints).
    SEED = int(os.environ.get("TPUJOB_SOAK_SEED", str(0xC0FFEE)))
    ITERATIONS = int(os.environ.get("TPUJOB_SOAK_ITERS", "500"))

    def check_invariants(self, rt, live_jobs):
        pods = rt.cluster.pods.list("default")
        # 1. at most one pod per (owner uid, epoch, index)
        seen = set()
        for p in pods:
            ref = p.metadata.controller_ref()
            if ref is None:
                continue
            key = (ref.uid, p.metadata.labels.get(naming.LABEL_EPOCH),
                   p.metadata.labels.get(naming.LABEL_INDEX))
            assert key not in seen, f"duplicate pod identity {key}"
            seen.add(key)
        for name, job in live_jobs.items():
            cur = rt.get_job("default", name)
            if cur is None:
                continue
            expected = (1 if cur.local_spec() is not None
                        else expected_worker_pods(cur.worker_spec()))
            epoch = cur.status.restarts
            current_epoch_pods = [
                p for p in job_pods(rt, cur)
                if p.metadata.labels.get(naming.LABEL_EPOCH) == str(epoch)
            ]
            # 2. the current epoch never overshoots the gang size
            assert len(current_epoch_pods) <= expected
            # 3. slice holdings never exceed the request
            ws = cur.worker_spec()
            if ws is not None:
                held = rt.cluster.slice_pool.holdings(cur.metadata.uid)
                assert len(held) <= ws.tpu.num_slices
        # 4. a preempted (unhealthy) slice is never still held
        for s in rt.cluster.slice_pool.list():
            if not s.healthy:
                assert not s.holder, f"unhealthy slice {s.name} still held"

    def test_randomized_fault_soak_converges(self):
        rng = random.Random(self.SEED)
        rt = LocalRuntime(PodRunPolicy(start_delay=1, run_duration=6))
        # repeated-failure jobs must still converge inside the test budget
        rt.controller.opts.restart_backoff_base = 0.5
        rt.controller.opts.backoff_poll = 0.005
        rt.cluster.slice_pool.add_pool("v5p-8", 4)

        live_jobs = {}
        deleted = []
        counter = 0

        def submit(kind):
            nonlocal counter
            counter += 1
            name = f"{kind}-{counter}"
            if kind == "gang":
                j = worker_job(name, num_slices=rng.choice([1, 1, 2]))
                j.spec.priority = rng.choice([0, 0, 0, 5, 10])
            else:
                j = local_job(name)
            live_jobs[name] = rt.submit(j)
            return name

        for _ in range(3):
            submit("gang")
        submit("loc")
        submit("loc")

        restore_at = {}  # slice name -> tick index to restore
        restarts = preemptions = crashes = 0

        for i in range(self.ITERATIONS):
            r = rng.random()
            if r < 0.06:
                held = [s for s in rt.cluster.slice_pool.list() if s.holder]
                if held:
                    s = rng.choice(held)
                    rt.cluster.preempt_slice(s.name)
                    restore_at[s.name] = i + rng.randint(3, 12)
                    preemptions += 1
            elif r < 0.11:
                running = [p for p in rt.cluster.pods.list("default")
                           if p.status.phase == PodPhase.RUNNING]
                if running:
                    p = rng.choice(running)
                    rt.cluster.crash_pod("default", p.metadata.name)
                    crashes += 1
            elif r < 0.15:
                rt.cluster.faults.fail_pod_creates = rng.randint(1, 3)
            elif r < 0.18:
                rt.cluster.faults.gang_admission_delay = rng.choice([0, 0, 2, 5])
            elif r < 0.21:
                rt.restart_controller()
                restarts += 1
            elif r < 0.26 and len(live_jobs) < 8:
                submit(rng.choice(["gang", "loc"]))
            elif r < 0.28 and len(live_jobs) > 2:
                name = rng.choice(sorted(live_jobs))
                del live_jobs[name]
                deleted.append(name)
                rt.delete_job("default", name)
            elif r < 0.31 and live_jobs:
                # toggle suspend on a random live job
                name = rng.choice(sorted(live_jobs))
                j = rt.get_job("default", name)
                if j is not None and not j.is_done():
                    j.spec.suspend = not j.spec.suspend
                    try:
                        rt.cluster.jobs.update(j)
                    except Exception:
                        pass  # conflict with the controller: fine

            for sname, due in list(restore_at.items()):
                if i >= due:
                    rt.cluster.slice_pool.restore(sname)
                    del restore_at[sname]

            rt.step()
            self.check_invariants(rt, live_jobs)

        # the schedule exercised every fault class (only a run long enough
        # to make that statistically certain asserts it)
        if self.ITERATIONS >= 300:
            assert restarts and preemptions and crashes

        # storm over: clear faults, heal the pool, unsuspend everything,
        # require convergence
        rt.cluster.faults.fail_pod_creates = 0
        rt.cluster.faults.gang_admission_delay = 0.0
        for s in rt.cluster.slice_pool.list():
            if not s.healthy:
                rt.cluster.slice_pool.restore(s.name)
        for name in live_jobs:
            j = rt.get_job("default", name)
            if j is not None and j.spec.suspend:
                j.spec.suspend = False
                rt.cluster.jobs.update(j)

        def all_settled():
            for name in live_jobs:
                j = rt.get_job("default", name)
                if j is None or j.status.phase not in (JobPhase.SUCCEEDED, JobPhase.FAILED):
                    return False
            return True

        assert rt.run_until(all_settled, max_steps=400), (
            "jobs failed to reach a terminal phase after the storm: "
            + str({n: getattr(rt.get_job('default', n), 'status', None)
                   and rt.get_job('default', n).status.phase
                   for n in live_jobs})
        )

        # deleted jobs left nothing behind
        for name in deleted:
            for p in rt.cluster.pods.list("default"):
                assert p.metadata.labels.get(naming.LABEL_JOB) != name
            for s in rt.cluster.services.list("default"):
                assert s.metadata.labels.get(naming.LABEL_JOB) != name
        # terminal jobs released every slice and tore down services
        for name, job in live_jobs.items():
            assert not rt.cluster.slice_pool.holdings(job.metadata.uid)
        assert not rt.cluster.services.list("default")
        # no pod is bound to a slice nobody holds while still running
        for p in rt.cluster.pods.list("default"):
            assert p.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)
