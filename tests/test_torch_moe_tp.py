"""Expert-parallel MoE serving of the port against the JAX package's.

The serving mesh's tp axis is also the expert-parallel axis: each rank
stores ``E / tp`` experts of every bank (int8 ``(q, scale)`` banks
too), and every paged call routes its tokens to them
(``models/generate.py:_moe_ep_ffn``: whole fp32 routing, this rank's
stripe of the tokens, ``all_to_all`` over tp to the experts and back,
the gate-weighted combine, the stripes gathered).

A gang of four gloo processes (``tests/test_torch_tp_serving.py``'s
worker, started once for the module) serves ``tiny_moe_config
(n_kv_heads=4)`` in fp32 from the JAX package's init; this process runs
the port's one-process engine and the JAX engine on the same requests.
The tests hold, as ``tests/test_moe_tp.py`` holds the JAX engine:

* greedy streams at tp=2 and tp=4 in both compute modes (kernel and
  gather attention) equal tp=1's and the JAX engine's;
* seeded sampled streams, speculative decoding and int8 expert banks at
  tp=2 equal tp=1's (and the JAX engine's);
* a prefill + decode tail at tp=4 in both modes within
  ``generate.moe_ep_tolerance`` of one device's logits, argmax equal;
* a drain with a cancel leaks no page; every rank's completions are
  equal;
* each rank stores ``E / tp`` experts; the MoE gauges and the traffic
  model's per-rank bank; the ``moe_experts % tp`` refusal in the engine,
  ``serve()`` and the command line.
"""

import numpy as np
import pytest
import torch

import test_torch_tp_serving as tps
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane.serving_engine import ServingEngine
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh
from kubeflow_controller_tpu_torch.parallel.sharding import shard_serving_params

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

#: name -> (mesh, what the case runs, its arguments); ``quant`` names
#: the int8 weights.
CASES = {
    "g2": ("A", "churn", dict(tp_compute="gathered")),
    "p2_gather": ("B", "churn", dict(tp_compute="parallel", attn_impl="gather")),
    "g4": ("all", "churn", dict(tp_compute="gathered")),
    "p2": ("A", "churn", dict(tp_compute="parallel")),
    "spec2": ("B", "churn", dict(tp_compute="parallel", spec_decode=True,
                                 draft_k=4, decode_chunk=1)),
    "p4": ("all", "churn", dict(tp_compute="parallel")),
    "sampled_g2": ("A", "sampled", dict(tp_compute="gathered")),
    "sampled_p2": ("B", "sampled", dict(tp_compute="parallel")),
    "int8_g2": ("A", "churn", dict(tp_compute="gathered", quant="int8")),
    "int8_p2": ("B", "churn", dict(tp_compute="parallel", quant="int8")),
    "drain2": ("A", "drain", dict(tp_compute="gathered")),
    "logits4": ("all", "logits", {}),
}
PHASES = [["g2", "p2_gather"], ["g4"], ["p2", "spec2"], ["p4"],
          ["sampled_g2", "sampled_p2"], ["int8_g2", "int8_p2"], ["drain2"],
          ["logits4"]]


def gang_inputs(raw):
    cfg = ttfm.tiny_moe_config(n_kv_heads=4)
    master = params_from_numpy(raw["master"], device="cpu")
    return {"cfg": cfg, "params": tgen.inference_params(cfg, master),
            "params8": tgen.inference_params(cfg, master, quant="int8")}


def _run_case(name, inp, mesh, rank):
    where, what, kw = CASES[name]
    kw = dict(kw)
    params = inp["params8" if kw.pop("quant", "") else "params"]
    if what == "logits":
        return {mode: tps.logits_tail(inp["cfg"], params, mesh, mode)
                for mode in ("gathered", "parallel")}
    return tps.run_engine(inp["cfg"], params, what, mesh, rank, **kw)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Start the gang, compute the port's one-process runs and the JAX
    references while it runs, then collect both."""
    import os

    root = str(tmp_path_factory.mktemp("torch_moe_tp"))
    cfg_j, master, params_j = tps._jax_setup(moe=True)
    _, _, params_j8 = tps._jax_setup(moe=True, int8=True)
    torch.save({"master": master}, os.path.join(root, "inputs.pt"))
    procs = tps.start_gang(__name__, root)
    try:
        inp = gang_inputs({"master": master})
        cfg = inp["cfg"]
        ref = {
            "base": tps.run_engine(cfg, inp["params"], "churn"),
            "int8": tps.run_engine(cfg, inp["params8"], "churn"),
            "sampled": tps.run_engine(cfg, inp["params"], "sampled"),
            "drain": tps.run_engine(cfg, inp["params"], "drain"),
            "jax1": tps.jax_run(cfg_j, params_j, "churn"),
            "jax2": tps.jax_run(cfg_j, params_j, "churn", tp=2),
            "jax_int8": tps.jax_run(cfg_j, params_j8, "churn"),
            "jax_sampled": tps.jax_run(cfg_j, params_j, "sampled"),
        }
        got = tps.collect_gang(procs, CASES, root)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    import jax

    jax.clear_caches()
    return got, ref


@pytest.mark.parametrize("name", ["g2", "g4", "p2", "p2_gather", "p4"])
def test_moe_streams_equal_tp1_and_jax(gang, name):
    got, ref = gang
    rec = tps._one(got, name)
    assert rec["streams"] == ref["base"]["streams"] == ref["jax1"] == ref["jax2"]


@pytest.mark.parametrize("name", ["sampled_g2", "sampled_p2"])
def test_moe_sampled_streams_equal_tp1_and_jax(gang, name):
    got, ref = gang
    rec = tps._one(got, name)
    assert rec["streams"] == ref["sampled"]["streams"] == ref["jax_sampled"]


def test_moe_speculative_streams_equal_plain_tp1(gang):
    got, ref = gang
    rec = tps._one(got, "spec2")
    assert rec["streams"] == ref["base"]["streams"]
    assert rec["summary"]["spec_steps"] > 0


@pytest.mark.parametrize("name", ["int8_g2", "int8_p2"])
def test_moe_int8_expert_banks_equal_tp1_int8(gang, name):
    got, ref = gang
    rec = tps._one(got, name)
    assert rec["streams"] == ref["int8"]["streams"] == ref["jax_int8"]


def test_moe_drain_and_cancel_leak_no_page(gang):
    got, ref = gang
    rec = tps._one(got, "drain2")
    assert rec["cancelled"] and rec["used"] == rec["trie_nodes"]
    assert not any(rec["slot_blocks"])
    assert rec["streams"] == ref["drain"]["streams"]


@pytest.mark.parametrize("mode", ["gathered", "parallel"])
def test_moe_ep_logits_within_the_ep_tolerance(gang, mode):
    """At tp=4 in both modes, every step's logits within
    ``moe_ep_tolerance(cfg, 4)`` of one device's, the argmax equal, and
    the same bits on every rank."""
    got, _ = gang
    recs = got["logits4"]
    tol = tgen.moe_ep_tolerance(ttfm.tiny_moe_config(n_kv_heads=4), 4)
    for r in recs[1:]:
        for a, b in zip(r[mode]["mesh"], recs[0][mode]["mesh"]):
            assert np.array_equal(a, b), "ranks disagree"
    base, mesh = recs[0][mode]["base"], recs[0][mode]["mesh"]
    scale = float(np.abs(base[0]).max()) + 1e-30
    for b, m in zip(base, mesh):
        assert np.array_equal(b.argmax(-1), m.argmax(-1))
        err = float(np.abs(b - m).max())
        assert err <= tol["atol"] + tol["rtol"] * scale, (err, tol)


def test_moe_gauges_and_traffic_model(gang):
    """``moe_experts_per_shard`` is ``E / tp``, routings are counted
    ``top_k`` a token, and the traffic model charges a rank its
    resident ``E / tp`` bank (less than the one-device engine's)."""
    got, ref = gang
    cfg = ttfm.tiny_moe_config(n_kv_heads=4)
    s = tps._one(got, "g2")["summary"]
    assert s["moe_experts_per_shard"] == cfg.moe_experts // 2
    assert s["moe_tokens_dispatched"] == ref["base"]["summary"]["moe_tokens_dispatched"] > 0
    assert s["moe_tokens_dispatched"] % cfg.moe_top_k == 0
    assert s["hbm_bytes_per_step_decode"] < ref["base"]["summary"]["hbm_bytes_per_step_decode"]


@pytest.mark.parametrize("quant", ["", "int8"])
def test_moe_expert_banks_split_e_over_tp(quant):
    """Each rank stores ``E / tp`` experts of every bank (the int8 scales
    on the same axis) and the whole fp32 router."""
    cfg = ttfm.tiny_moe_config(n_kv_heads=4)
    params = tgen.inference_params(cfg, ttfm.init_params(cfg, device="cpu"), quant)
    for tp in (2, 4):
        mesh = tmesh.Mesh(np.arange(tp).reshape(1, 1, 1, 1, 1, tp))
        chunks = shard_serving_params(cfg, params, mesh, quant)
        for name in ttfm.MOE_BANKS:
            whole, local = params["layers"][name], chunks["layers"][name]
            for w, c in zip(whole if quant else (whole,), local if quant else (local,)):
                assert c.shape[1] == cfg.moe_experts // tp
                assert torch.equal(c, w[:, :cfg.moe_experts // tp])
        assert torch.equal(chunks["layers"]["w_router"], params["layers"]["w_router"])


def test_moe_refusal_in_the_engine_serve_and_the_cli():
    """``moe_experts % tp`` refuses at engine construction, in ``serve()``
    (before any weight loads) and on the command line (exit code 2)."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm

    cfg = ttfm.tiny_moe_config(n_kv_heads=4, moe_experts=6)
    params = tgen.inference_params(cfg, ttfm.init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="moe_experts"):
        ServingEngine(cfg, params, n_slots=2, max_seq=tps.MAX_SEQ, tp=4, device="cpu")
    with pytest.raises(ValueError, match="moe_experts"):
        serve_lm.serve(config="tiny_moe", tp=3, prefix_cache=True, device="cpu")
    with pytest.raises(SystemExit) as e:
        serve_lm.main(["--config", "tiny_moe", "--tp", "3", "--device", "cpu"])
    assert e.value.code == 2
