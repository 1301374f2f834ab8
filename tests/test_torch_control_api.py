"""The port's job API against the JAX package's: every shipped manifest
loads, validates and dumps to the same dict through both; malformed
manifests and specs give the same ``ValidationError`` lists; the TPU
slice catalog and its derived geometry are equal entry by entry.

The API imports no torch, so neither does this file.
"""

import glob
import importlib
import os
import types as pytypes

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "tpujob", "*.yml")))
PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")


def _mods(pkg: str) -> pytypes.SimpleNamespace:
    imp = importlib.import_module
    return pytypes.SimpleNamespace(
        api=imp(f"{pkg}.api"),
        core=imp(f"{pkg}.api.core"),
        types=imp(f"{pkg}.api.types"),
        ser=imp(f"{pkg}.api.serialization"),
        val=imp(f"{pkg}.api.validation"),
        topo=imp(f"{pkg}.api.topology"),
    )


JAX, PORT = _mods(PACKAGES[0]), _mods(PACKAGES[1])


def _both(fn):
    """fn(m) through both packages: (result or ("raises", type, errors))."""
    out = []
    for m in (JAX, PORT):
        try:
            out.append(fn(m))
        except Exception as e:  # compared, not swallowed
            out.append(("raises", type(e).__name__,
                        getattr(e, "errors", str(e))))
    return out


def test_examples_are_present():
    assert len(EXAMPLES) >= 6, EXAMPLES


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_loads_validates_and_dumps_the_same(path):
    with open(path) as f:
        text = f.read()

    def load(m):
        job = m.ser.load_job_yaml(text)
        m.val.validate_job(job)
        as_dict = m.ser.job_to_dict(job)
        dumped = m.ser.dump_job_yaml(job)
        back = m.ser.job_to_dict(m.ser.load_job_yaml(dumped))
        again = m.ser.job_to_dict(m.ser.job_from_dict(as_dict))
        assert back == as_dict and again == as_dict
        return as_dict, dumped, [m.val.expected_worker_pods(rs)
                                 for rs in job.spec.replica_specs]

    a, b = _both(load)
    assert a[0] != "raises", a
    assert a == b


# -- malformed manifests: the same error lists ------------------------------

BAD_MANIFESTS = {
    "wrong_kind": "kind: TFJob\nmetadata: {name: x}\n",
    "unknown_accelerator": """
kind: TPUJob
metadata: {name: x, namespace: default}
spec:
  replicaSpecs:
  - replicaType: Worker
    tpu: {acceleratorType: gpu-8}
    template: {spec: {containers: [{name: t, image: i}]}}
""",
    "bad_enum": """
kind: TPUJob
metadata: {name: x, namespace: default}
spec:
  replicaSpecs:
  - replicaType: Boss
    template: {spec: {containers: [{name: t, image: i}]}}
""",
    "negative_ttl": """
kind: TPUJob
metadata: {name: x, namespace: default}
spec:
  ttlSecondsAfterFinished: -5
  replicaSpecs:
  - replicaType: Local
    template: {spec: {containers: [{name: t, image: i}]}}
""",
    "bad_types": """
kind: TPUJob
metadata: {name: [1, 2]}
spec:
  suspend: maybe
  replicaSpecs:
  - replicaType: Worker
    replicas: many
    tpu: {acceleratorType: v5e-16, numSlices: two}
""",
    "yaml_syntax": "kind: TPUJob\nmetadata: {name: x\n",
    "not_a_mapping": "- 1\n- 2\n",
    "missing_everything": "kind: TPUJob\n",
    "unknown_fields_tolerated": (
        "kind: TPUJob\nmetadata: {name: x, bogus: 1}\n"
        "spec: {futureField: 2}\n"),
    "mixed_roles": """
kind: TPUJob
metadata: {name: x, namespace: default}
spec:
  replicaSpecs:
  - replicaType: Worker
    tpu: {acceleratorType: v5e-16}
    template: {spec: {containers: [{name: t, image: i}]}}
  - replicaType: Local
    template: {spec: {containers: [{name: t, image: i}]}}
""",
    "bad_topology_override": """
kind: TPUJob
metadata: {name: x, namespace: default}
spec:
  replicaSpecs:
  - replicaType: Worker
    tpu: {acceleratorType: v5e-16, topology: 2x8}
    template: {spec: {containers: [{name: t, image: i}]}}
""",
}


@pytest.mark.parametrize("name", sorted(BAD_MANIFESTS))
def test_malformed_manifest_gives_the_same_errors(name):
    text = BAD_MANIFESTS[name]

    def load(m):
        job = m.ser.load_job_yaml(text)
        m.val.validate_job(job)
        return m.ser.job_to_dict(job)

    a, b = _both(load)
    assert a == b


# tests/test_api.py's validation cases, built from the dataclasses.

def _worker(m, accel="v5e-16", num_slices=1):
    t, c = m.types, m.core
    return t.TPUJob(
        metadata=c.ObjectMeta(name="bert", namespace="default"),
        spec=t.TPUJobSpec(replica_specs=[t.ReplicaSpec(
            replica_type=t.ReplicaType.WORKER,
            template=c.PodTemplateSpec(spec=c.PodSpec(
                containers=[c.Container(name="trainer", image="i")])),
            tpu=t.TPUSliceSpec(accelerator_type=accel,
                               num_slices=num_slices),
        )]))


def _edit(fn):
    def make(m):
        job = _worker(m)
        fn(m, job)
        return job
    return make


SPEC_CASES = {
    "valid_worker": lambda m: _worker(m),
    "valid_local": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0], "replica_type", m.types.ReplicaType.LOCAL)
        or setattr(j.spec.replica_specs[0], "tpu", None)),
    "collects_all_errors": lambda m: m.types.TPUJob(
        metadata=m.core.ObjectMeta(name="", namespace="")),
    "mixed_roles": _edit(lambda m, j: j.spec.replica_specs.append(
        m.types.ReplicaSpec(replica_type=m.types.ReplicaType.LOCAL,
                            template=j.spec.replica_specs[0].template))),
    "unknown_accelerator": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0].tpu, "accelerator_type", "gpu-8")),
    "missing_template": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0], "template", None)),
    "bad_topology_override": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0].tpu, "topology", "2x8")),
    "negative_ttl": _edit(lambda m, j: setattr(
        j.spec, "ttl_seconds_after_finished", -1)),
    "zero_slices": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0].tpu, "num_slices", 0)),
    "negative_restarts": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0], "max_restarts", -1)),
    "bad_chief": _edit(lambda m, j: setattr(
        j.spec.replica_specs[0], "termination_policy",
        m.types.TerminationPolicySpec(chief=m.types.ChiefSpec(
            replica_name="Worker", replica_index=99)))),
    "float_priority": _edit(lambda m, j: setattr(j.spec, "priority", 1.5)),
}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_validate_job_gives_the_same_errors(name):
    make = SPEC_CASES[name]

    def check(m):
        job = make(m)
        m.val.validate_job(job)
        return [m.val.expected_worker_pods(rs)
                for rs in job.spec.replica_specs if rs.tpu is not None]

    a, b = _both(check)
    assert a == b


def _svc(m, **kw):
    t = m.types
    slo = kw.pop("slo", None)
    spec = t.LMServiceSpec(**dict({"model": "tiny", "replicas": 2}, **kw))
    if slo is not None:
        spec.slo = t.SLOSpec(**slo)
    return t.LMService(
        metadata=m.core.ObjectMeta(name="chat", namespace="default"),
        spec=spec)


LMS_CASES = {
    "valid": {},
    "zero_replicas": {"replicas": 0},
    "zero_queue": {"max_queue": 0},
    "empty_model": {"model": ""},
    "negative_deadline": {"slo": {"deadline_s": -1}},
    "prefill_over_replicas": {"prefill_replicas": 5},
}


@pytest.mark.parametrize("name", sorted(LMS_CASES))
def test_validate_lmservice_gives_the_same_errors(name):
    kw = LMS_CASES[name]
    a, b = _both(lambda m: m.val.validate_lmservice(_svc(m, **dict(kw))))
    assert a == b


# -- topology ----------------------------------------------------------------


def test_slice_catalog_equal_entry_by_entry():
    jc, pc = JAX.topo.TPU_SLICE_CATALOG, PORT.topo.TPU_SLICE_CATALOG
    assert list(jc) == list(pc)
    for name in jc:
        js, ps = jc[name], pc[name]
        assert (js.accelerator_type, js.num_chips, js.topology,
                js.chips_per_host, js.num_hosts, js.topology_str) == \
            (ps.accelerator_type, ps.num_chips, ps.topology,
             ps.chips_per_host, ps.num_hosts, ps.topology_str), name
        assert JAX.topo.gke_accelerator(js) == PORT.topo.gke_accelerator(ps)
        back_j = JAX.topo.shape_from_gke(JAX.topo.gke_accelerator(js),
                                         js.topology_str)
        back_p = PORT.topo.shape_from_gke(PORT.topo.gke_accelerator(ps),
                                          ps.topology_str)
        assert back_j.accelerator_type == back_p.accelerator_type
    a, b = _both(lambda m: m.topo.slice_shape("v9x-3"))
    assert a == b and a[0] == "raises"


def test_status_conditions_behave_the_same():
    def run(m):
        t = m.types
        st = _worker(m).status
        out = [st.set_condition(t.ConditionType.SCHEDULED,
                                t.ConditionStatus.TRUE, "ok", now=1.0),
               st.set_condition(t.ConditionType.SCHEDULED,
                                t.ConditionStatus.TRUE, "ok", now=2.0),
               st.set_condition(t.ConditionType.SCHEDULED,
                                t.ConditionStatus.FALSE, "lost", now=3.0)]
        for i in range(30):
            ct = list(t.ConditionType)[i % len(t.ConditionType)]
            st.conditions.append(t.Condition(ct, t.ConditionStatus.TRUE,
                                             str(i)))
        st.set_condition(t.ConditionType.READY, t.ConditionStatus.TRUE, "r",
                         now=4.0)
        return out, [(c.type.value, c.status.value, c.reason,
                      c.last_transition_time) for c in st.conditions]

    a, b = _both(run)
    assert a == b


def test_pod_and_service_wire_round_trips():
    def run(m):
        c = m.core
        pod = c.Pod(
            metadata=c.ObjectMeta(name="p", namespace="default",
                                  labels={"a": "b"}),
            spec=c.PodSpec(containers=[c.Container(
                name="t", image="i", env={"K": "V"},
                resources={"google.com/tpu": 4})],
                node_selector={"n": "s"}),
            status=c.PodStatus(phase=c.PodPhase.FAILED, exit_code=137))
        svc = c.Service(
            metadata=c.ObjectMeta(name="s", namespace="default"),
            spec=c.ServiceSpec(selector={"a": "b"},
                               ports=[c.ServicePort(port=8476, name="x")]))
        pd, sd = m.ser.pod_to_dict(pod), m.ser.service_to_dict(svc)
        assert m.ser.pod_to_dict(m.ser.pod_from_dict(pd)) == pd
        assert m.ser.service_to_dict(m.ser.service_from_dict(sd)) == sd
        return pd, sd

    a, b = _both(run)
    assert a == b
