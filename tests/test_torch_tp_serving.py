"""Tensor-parallel serving of the port against the JAX package's tp engine.

One gang of four gloo processes (:func:`_worker_main`, started once for
the module) serves every case in turn, each on a ``serving_mesh`` of its
ranks: two tp=2 cases side by side (ranks 0-1 and 2-3), the tp=4 cases on
all four. Each rank builds the engine from the same numpy weights (the
JAX package's init of ``tiny_config(n_kv_heads=4)``, fp32) and writes its
completions; meanwhile this process runs the port's one-process engine
and the JAX engine (its own tp meshes on the 8 virtual CPU devices of
``tests/conftest.py``) on the same requests. The tests then hold:

* ``tp_compute="gathered"`` at tp=2 and tp=4 on the JAX package's churn
  workload (bucketed prefill, prefix cache): greedy streams bit for bit
  the port's tp=1 streams and the JAX engine's at the same tp;
* ``"parallel"`` at tp=2 (kernel and gather attention): the same
  streams, and a prefill + decode tail at tp=4 whose logits stay within
  ``generate.tp_parallel_tolerance`` of one device's (``"gathered"``:
  equal), as ``tests/test_tp_serving.py`` holds the JAX engine;
* int8 KV, speculative decoding, sampled ``n = 2`` forks and the host
  tier at tp=2: the streams (and the tier's spill and rehydrate counts)
  of tp=1;
* a drain with a cancel leaks no page; a deadline run whose ranks read
  clocks that disagree takes rank 0's decisions on every rank;
* ``ServingStats``' tp gauges; ``check_tp_heads``' message, the
  tolerances and the serving placement equal the JAX package's;
* ``serve()`` on two ranks started from the controller's env: rank 0
  alone writes the metrics, and the completions are tp=1's.

Every rank's completions must be equal in every case (the ranks take
the same host decisions). ``tests/test_torch_moe_tp.py`` runs its own
gang on this module's worker.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import kv_blocks
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh
from kubeflow_controller_tpu_torch.parallel.sharding import shard_serving_params

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
MAX_SEQ = 64
BS = 8
GANG_TIMEOUT_S = 240

#: The meshes of the gang: two tp=2 meshes side by side, and tp=4.
MESHES = {"A": (2, [0, 1]), "B": (2, [2, 3]), "all": (4, [0, 1, 2, 3])}


# -- workloads (numpy, shared by both packages) --------------------------------

def churn(vocab, n=10, seed=3):
    """The JAX package's churn workload (``tests/test_tp_serving.py``):
    more requests than slots at mixed prompt and budget sizes, so that
    slots retire and readmit mid-run."""
    rng = np.random.default_rng(seed)
    shapes = [(5, 12), (9, 7), (14, 20), (3, 9), (21, 15),
              (7, 5), (11, 11), (6, 18), (17, 6), (4, 13)][:n]
    return [(rng.integers(0, vocab, s).astype(np.int32), m) for s, m in shapes]


def families(vocab, seed=11):
    """Three waves (families A, B, A) of three requests that share a
    two-block prefix: through a small pool, wave B evicts (and spills)
    A's chains, and the second A wave rehydrates them."""
    rng = np.random.default_rng(seed)
    heads = {f: rng.integers(0, vocab, 2 * BS).astype(np.int32) for f in "AB"}
    waves = []
    for f in "ABA":
        waves.append([(np.concatenate([heads[f], rng.integers(0, vocab, 5 + i)
                                       .astype(np.int32)]), 6) for i in range(3)])
    return waves


ENGINE_KW = dict(n_slots=4, max_seq=MAX_SEQ, prefill_mode="bucketed",
                 block_size=BS, prefix_cache=True)
TIER_KW = dict(n_slots=2, max_seq=MAX_SEQ, prefill_mode="bucketed",
               block_size=BS, prefix_cache=True, kv_pool_blocks=8,
               host_kv_mb=1.0)
FORK_SAMPLING = dict(n=2, temperature=0.8, top_k=20, seed=5)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)

#: name -> (mesh, what the case runs, its arguments).
CASES = {
    "g2": ("A", "churn", dict(tp_compute="gathered")),
    "p2_gather": ("B", "churn", dict(tp_compute="parallel", attn_impl="gather")),
    "g4": ("all", "churn", dict(tp_compute="gathered")),
    "p2": ("A", "churn", dict(tp_compute="parallel")),
    "spec2": ("B", "churn", dict(tp_compute="gathered", spec_decode=True,
                                 draft_k=4, decode_chunk=1)),
    "int8kv2": ("A", "churn", dict(tp_compute="gathered", kv_quant="int8")),
    "forks2": ("B", "forks", dict(tp_compute="parallel")),
    "tier2": ("A", "tier", dict(tp_compute="gathered")),
    "drain2": ("B", "drain", dict(tp_compute="gathered")),
    "deadline2": ("A", "deadline", dict(tp_compute="gathered")),
    "logits4": ("all", "logits", {}),
}
PHASES = [["g2", "p2_gather"], ["g4"], ["p2", "spec2"], ["int8kv2", "forks2"],
          ["tier2", "drain2"], ["deadline2"], ["logits4"]]


# -- the port's runs (one process, and each rank of the gang) ------------------

def make_requests(work, sampling=None):
    from kubeflow_controller_tpu_torch.dataplane.sampling import SamplingParams

    return [Request(rid=i, prompt=p.copy(), max_new_tokens=m,
                    params=None if sampling is None else SamplingParams(**sampling))
            for i, (p, m) in enumerate(work)]


def streams(completions):
    return {(c.rid, c.gen): (list(map(int, c.tokens)), c.finish_reason)
            for c in completions}


class StepClock:
    """A clock that advances ``dt`` at every read."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def run_engine(cfg, params, what, mesh=None, rank=0, **kw):
    """One engine run of the workload ``what``; returns its records."""
    vocab = cfg.vocab_size
    if what == "churn":
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW, **kw)
        return {"streams": streams(eng.run(make_requests(churn(vocab)))),
                "summary": eng.stats.summary()}
    if what == "sampled":
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW, **kw)
        out = eng.run(make_requests(churn(vocab), SAMPLED))
        return {"streams": streams(out), "summary": eng.stats.summary()}
    if what == "forks":
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW, **kw)
        reqs = make_requests([(p, 8) for p, _ in churn(vocab, n=4)], FORK_SAMPLING)
        out = eng.run(reqs)
        return {"streams": streams(out), "cow": eng.stats.cow_page_copies}
    if what == "tier":
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **TIER_KW, **kw)
        got = {}
        for w, wave in enumerate(families(vocab)):
            for c in eng.run([Request(rid=100 * w + i, prompt=p.copy(), max_new_tokens=m)
                              for i, (p, m) in enumerate(wave)]):
                got[(c.rid, c.gen)] = (list(map(int, c.tokens)), c.finish_reason)
        s = eng.stats
        return {"streams": got, "tier": [s.spilled_pages, s.spill_bytes,
                                         s.rehydrate_hits, s.rehydrate_tokens]}
    if what == "drain":
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW, **kw)
        for r in make_requests(churn(vocab, n=6)):
            eng.submit(r)
        for _ in range(4):
            eng.step()
        cancelled = eng.cancel(2)
        eng.step()
        out = eng.drain()
        return {"streams": streams(out), "cancelled": cancelled,
                "used": eng.pool.used_blocks,
                "trie_nodes": eng._prefix_store.trie.n_nodes(),
                "slot_blocks": [int(b) for b in eng._slot_blocks]}
    if what == "deadline":
        # Rank r's clock runs r + 1 times as fast as rank 0's: without
        # rank 0's decisions on every rank, rank 1 would retire requests
        # its peer still decodes, and the gang would diverge or hang.
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu",
                            clock=StepClock(0.05 * (rank + 1)), **ENGINE_KW, **kw)
        reqs = make_requests(churn(vocab))
        for r in reqs:
            r.deadline_s = 1.5 * (r.rid + 1)
        return {"streams": streams(eng.run(reqs))}
    raise ValueError(what)


def logits_tail(cfg, params, mesh, tp_compute, attn_impl="kernel", steps=6):
    """Two prompts admitted by ``prefill_into_paged`` then ``steps``
    decode steps fed the one-device engine's argmax (computed beside,
    without the mesh), as ``test_tp_parallel_tolerance_contract`` does:
    the fp32 logits of every step, one device's and the mesh's."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, 11).astype(np.int32) for _ in range(2)]
    mb = MAX_SEQ // BS
    out = {"base": [], "mesh": []}
    caches, logits = {}, {}
    # The mesh's calls take this rank's chunks of the weights.
    chunks = {"base": params, "mesh": shard_serving_params(
        cfg, params, mesh, tgen.weight_quant(params))}
    for mode, m in (("base", None), ("mesh", mesh)):
        tp = tgen.tp_size(m)
        cache = tgen.init_paged_cache(cfg, 2, mb, 2 * mb, BS, "", device="cpu", tp=tp)
        cache.tables = torch.arange(2 * mb, dtype=torch.int32).reshape(2, mb)
        rows = []
        for i, pr in enumerate(prompts):
            lg, cache = tgen.prefill_into_paged(
                cfg, chunks[mode], torch.from_numpy(pr[None]), cache, i, mesh=m,
                tp_compute=tp_compute)
            rows.append(lg)
        caches[mode], logits[mode] = cache, torch.cat(rows)
    for _ in range(steps):
        for mode in ("base", "mesh"):
            out[mode].append(logits[mode].numpy().copy())
        toks = logits["base"].argmax(-1).to(torch.int32)[:, None]
        for mode, m in (("base", None), ("mesh", mesh)):
            logits[mode], caches[mode] = tgen.decode_step_paged(
                cfg, chunks[mode], toks, caches[mode], attn_impl=attn_impl, mesh=m,
                tp_compute=tp_compute)
    return out


def _run_case(name, inp, mesh, rank):
    where, what, kw = CASES[name]
    cfg, params = inp["cfg"], inp["params"]
    if what == "logits":
        return {mode: logits_tail(cfg, params, mesh, mode)
                for mode in ("gathered", "parallel")}
    return run_engine(cfg, params, what, mesh, rank, **kw)


def _worker_main(module, root, rank, port):
    """One rank of the gang: every mesh made by every rank (in the same
    order), then each phase's cases on their ranks; each rank writes its
    records of a case."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    mod = importlib.import_module(module)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    inp = mod.gang_inputs(torch.load(os.path.join(root, "inputs.pt"),
                                     weights_only=False))
    meshes = {k: tmesh.serving_mesh(tp, ranks) for k, (tp, ranks) in MESHES.items()}
    for phase in mod.PHASES:
        for name in phase:
            where = mod.CASES[name][0]
            if rank not in MESHES[where][1]:
                continue
            out = mod._run_case(name, inp, meshes[where], rank)
            torch.save(out, os.path.join(root, f"{name}-{rank}.pt"))
        dist.barrier()
    dist.destroy_process_group()


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_gang(module, root):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + TESTS + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = ("import sys, test_torch_tp_serving as t; "
            "t._worker_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))")
    return [subprocess.Popen([sys.executable, "-c", code, module, root, str(r), str(port)],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(4)]


def collect_gang(procs, cases, root):
    """Wait for the gang; every rank's records of every case."""
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=GANG_TIMEOUT_S)
            assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {name: [torch.load(os.path.join(root, f"{name}-{r}.pt"), weights_only=False)
                   for r in MESHES[cases[name][0]][1]] for name in cases}


# -- the references -------------------------------------------------------------

def _jax_setup(moe=False, int8=False):
    import jax

    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm

    cfg = (jtfm.tiny_moe_config if moe else jtfm.tiny_config)(n_kv_heads=4)
    master = jax.device_get(jtfm.init_params(cfg, jax.random.key(0)))
    return cfg, master, jgen.inference_params(cfg, master, quant="int8" if int8 else "")


def jax_run(cfg, params, what, tp=1, **kw):
    """The JAX engine's records of the workload ``what``."""
    from kubeflow_controller_tpu.dataplane import serving_engine as je

    vocab = cfg.vocab_size
    if what == "churn":
        eng = je.ServingEngine(cfg, params, tp=tp, **ENGINE_KW, **kw)
        out = eng.run([je.Request(rid=i, prompt=p.copy(), max_new_tokens=m)
                       for i, (p, m) in enumerate(churn(vocab))])
    elif what == "forks":
        eng = je.ServingEngine(cfg, params, tp=tp, **ENGINE_KW, **kw)
        out = eng.run([je.Request(rid=i, prompt=p.copy(), max_new_tokens=8,
                                  params=je.SamplingParams(**FORK_SAMPLING))
                       for i, (p, _) in enumerate(churn(vocab, n=4))])
    elif what == "sampled":
        eng = je.ServingEngine(cfg, params, tp=tp, **ENGINE_KW, **kw)
        out = eng.run([je.Request(rid=i, prompt=p.copy(), max_new_tokens=m,
                                  params=je.SamplingParams(**SAMPLED))
                       for i, (p, m) in enumerate(churn(vocab))])
    else:
        raise ValueError(what)
    return streams(out)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Start the gang and the two-rank ``serve()``, compute the port's
    one-process runs and the JAX references while they run, then collect
    everything."""
    root = str(tmp_path_factory.mktemp("torch_tp_serving"))
    cfg_j, master, params_j = _jax_setup()
    torch.save({"master": master}, os.path.join(root, "inputs.pt"))
    procs = start_gang(__name__, root)
    serve_procs = start_serve_pair(root)
    try:
        inp = gang_inputs({"master": master})
        cfg, params = inp["cfg"], inp["params"]
        ref = {
            "base": run_engine(cfg, params, "churn"),
            "int8kv": run_engine(cfg, params, "churn", kv_quant="int8"),
            "forks": run_engine(cfg, params, "forks"),
            "tier": run_engine(cfg, params, "tier"),
            "drain": run_engine(cfg, params, "drain"),
            "deadline": run_engine(cfg, params, "deadline"),
            "jax1": jax_run(cfg_j, params_j, "churn"),
            "jax2": jax_run(cfg_j, params_j, "churn", tp=2),
            "jax4": jax_run(cfg_j, params_j, "churn", tp=4),
            "jax_forks": jax_run(cfg_j, params_j, "forks"),
            "serve1": serve_one_process(root),
        }
        got = collect_gang(procs, CASES, root)
        ref["serve2"] = collect_serve_pair(serve_procs, root)
    finally:
        for p in procs + serve_procs:
            if p.poll() is None:
                p.kill()
    import jax

    jax.clear_caches()
    return got, ref


def gang_inputs(raw):
    cfg = ttfm.tiny_config(n_kv_heads=4)
    return {"cfg": cfg, "params": tgen.inference_params(
        cfg, params_from_numpy(raw["master"], device="cpu"))}


SERVE_ARGS = ["--config", "tiny", "--batch", "4", "--prompt-len", "12",
              "--max-new-tokens", "6", "--block-size", "8", "--prefill-mode",
              "bucketed", "--device", "cpu"]


def start_serve_pair(root):
    """``serve_lm`` on two ranks, each with the env the controller gives
    a pod, at ``--tp 2``."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   TPUJOB_LOG_DIR=os.path.join(root, "serve_logs"),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm",
             *SERVE_ARGS, "--tp", "2", "--tp-compute", "gathered",
             "--output", os.path.join(root, "serve_tp2.jsonl")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def collect_serve_pair(procs, root):
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=GANG_TIMEOUT_S)
        assert p.returncode == 0, f"serve rank {r} rc={p.returncode}\n{err[-4000:]}"
    logs = os.path.join(root, "serve_logs")
    with open(os.path.join(root, "serve_tp2.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {"rows": rows, "logs": sorted(os.listdir(logs))}


def serve_one_process(root):
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm

    path = os.path.join(root, "serve_tp1.jsonl")
    assert serve_lm.main(SERVE_ARGS + ["--output", path]) == 0
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- the tests ------------------------------------------------------------------

def _one(got, name):
    """The case's records, after checking every rank wrote the same
    completions."""
    recs = got[name]
    for r in recs[1:]:
        assert r["streams"] == recs[0]["streams"], f"{name}: ranks disagree"
    return recs[0]


@pytest.mark.parametrize("name,tp", [("g2", 2), ("g4", 4)])
def test_gathered_streams_are_tp1_and_jax_at_the_same_tp(gang, name, tp):
    got, ref = gang
    rec = _one(got, name)
    assert rec["streams"] == ref["base"]["streams"]
    assert rec["streams"] == ref[f"jax{tp}"] == ref["jax1"]
    assert rec["summary"]["tp"] == tp


@pytest.mark.parametrize("name", ["p2", "p2_gather"])
def test_parallel_streams_equal_tp1(gang, name):
    got, ref = gang
    assert _one(got, name)["streams"] == ref["base"]["streams"]


@pytest.mark.parametrize("mode", ["gathered", "parallel"])
def test_tp4_logits_within_the_parallel_tolerance(gang, mode):
    """At tp=4: "gathered" gives one device's logits bit for bit;
    "parallel" stays within ``tp_parallel_tolerance(cfg, 4)`` at every
    step with the same argmax."""
    got, _ = gang
    recs = got["logits4"]
    cfg = ttfm.tiny_config(n_kv_heads=4)
    tol = tgen.tp_parallel_tolerance(cfg, 4)
    for r in recs[1:]:
        for a, b in zip(r[mode]["mesh"], recs[0][mode]["mesh"]):
            assert np.array_equal(a, b), "ranks disagree"
    base, mesh = recs[0][mode]["base"], recs[0][mode]["mesh"]
    scale = float(np.abs(base[0]).max()) + 1e-30
    for b, m in zip(base, mesh):
        assert np.array_equal(b.argmax(-1), m.argmax(-1))
        if mode == "gathered":
            assert np.array_equal(b, m)
        err = float(np.abs(b - m).max())
        assert err <= tol["atol"] + tol["rtol"] * scale, (err, tol)


def test_speculative_streams_equal_plain_tp1(gang):
    got, ref = gang
    assert _one(got, "spec2")["streams"] == ref["base"]["streams"]
    assert _one(got, "spec2")["summary"]["spec_steps"] > 0


def test_int8_kv_streams_equal_tp1_int8(gang):
    got, ref = gang
    assert _one(got, "int8kv2")["streams"] == ref["int8kv"]["streams"]


def test_sampled_forks_equal_tp1_and_jax(gang):
    """``n = 2`` sampled forks under ``"parallel"``: the streams of the
    one-process engine and of the JAX engine, one copy-on-write copy a
    fork."""
    got, ref = gang
    rec = _one(got, "forks2")
    assert rec["streams"] == ref["forks"]["streams"] == ref["jax_forks"]
    assert rec["cow"] == ref["forks"]["cow"] > 0


def test_host_tier_spills_and_rehydrates_as_tp1(gang):
    """The tier counts whole pages' bytes at any tp, so the tp=2 engine
    spills, evicts and rehydrates the pages tp=1's does."""
    got, ref = gang
    rec = _one(got, "tier2")
    assert rec["streams"] == ref["tier"]["streams"]
    assert rec["tier"] == ref["tier"]["tier"]
    assert ref["tier"]["tier"][0] > 0 and ref["tier"]["tier"][2] > 0


def test_drain_and_cancel_leak_no_page(gang):
    got, ref = gang
    rec = _one(got, "drain2")
    assert rec["cancelled"]
    assert {r for _, r in rec["streams"].values()} <= {
        "eos", "length", "cancelled", "deadline", "shed"}
    assert rec["used"] == rec["trie_nodes"]
    assert not any(rec["slot_blocks"])
    assert rec["streams"] == ref["drain"]["streams"]


def test_deadlines_take_rank0_decisions_on_every_rank(gang):
    """Rank 1's clock runs twice as fast as rank 0's; every rank retires
    what rank 0's clock says (the one-process run on rank 0's clock)."""
    got, ref = gang
    rec = _one(got, "deadline2")
    assert rec["streams"] == ref["deadline"]["streams"]
    assert "deadline" in {r for _, r in rec["streams"].values()}


def test_stats_record_tp_and_the_per_device_pool(gang):
    got, _ = gang
    cfg = ttfm.tiny_config(n_kv_heads=4)
    s = _one(got, "g2")["summary"]
    n_blocks = 2 * ENGINE_KW["n_slots"] * MAX_SEQ // BS
    assert s["tp"] == 2.0
    assert s["pool_blocks_per_shard"] == float(n_blocks)
    assert s["kv_hbm_per_device_mb"] == pytest.approx(
        n_blocks * BS * kv_blocks.kv_bytes_per_token(cfg, "", tp=2) / (1 << 20))
    # The traffic model reads a rank's chunks under "parallel".
    assert _one(got, "p2")["summary"]["hbm_bytes_per_step"] < s["hbm_bytes_per_step"]


def test_serve_on_two_ranks_from_the_controller_env(gang):
    """Two ``serve_lm`` processes with a pod's env: the completions are
    the one-process run's, and only rank 0 wrote its metrics."""
    _, ref = gang
    assert ref["serve2"]["rows"] == ref["serve1"]
    assert ref["serve2"]["logs"] == ["metrics-p0.jsonl"]


# -- in one process -------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw,tp,mode", [
    (dict(n_kv_heads=4, d_ff=90), 4, "parallel"),
    (dict(n_kv_heads=4, d_ff=90), 4, "gathered"),
    (dict(n_kv_heads=4), 3, "gathered"),
    (dict(n_kv_heads=2, moe_experts=6, moe_top_k=2, d_ff=64), 4, "parallel"),
    (dict(n_kv_heads=4, moe_experts=6, moe_top_k=2, d_ff=64), 4, "gathered"),
    (dict(n_kv_heads=4, moe_experts=4, moe_top_k=2, d_ff=64), 2, "parallel"),
])
def test_check_tp_heads_message_equals_jax(cfg_kw, tp, mode):
    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm

    outcomes = []
    for check, tfm in ((jgen.check_tp_heads, jtfm), (tgen.check_tp_heads, ttfm)):
        try:
            check(tfm.tiny_config(**cfg_kw), tp, mode)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tolerances_equal_jax(tp):
    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm

    for kw in (dict(), dict(moe_experts=4, moe_top_k=2)):
        assert (tgen.tp_parallel_tolerance(ttfm.tiny_config(**kw), tp)
                == jgen.tp_parallel_tolerance(jtfm.tiny_config(**kw), tp))
        assert (tgen.moe_ep_tolerance(ttfm.tiny_config(**kw), tp)
                == jgen.moe_ep_tolerance(jtfm.tiny_config(**kw), tp))


def test_llama3_70b_serves_over_tp_and_refuses_tp3():
    """``serve(config="llama3_70b", tp=...)``: its heads split at tp 2, 4
    and 8 (one process then has no gang of that many ranks, and the mesh
    says so), tp=3 is refused with the JAX package's message."""
    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm

    cfg = ttfm.llama3_70b_config()
    for tp in (2, 4, 8):
        tgen.check_tp_heads(cfg, tp, "parallel")
        with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
            serve_lm.serve(config="llama3_70b", tp=tp, device="cpu")
    with pytest.raises(ValueError) as e:
        serve_lm.serve(config="llama3_70b", tp=3, device="cpu")
    with pytest.raises(ValueError) as want:
        jgen.check_tp_heads(jtfm.llama3_70b_config(), 3, "gathered")
    assert str(e.value) == str(want.value)


def _spec_entries(spec):
    """A spec's entries as plain tuples (None, a name, or a tuple of
    names), the trailing Nones dropped."""
    out = [None if e is None else e for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("config,quant", [("tiny", ""), ("tiny", "int8"),
                                          ("tiny_moe", ""), ("tiny_moe", "int8")])
def test_serving_placement_equals_jax(config, quant):
    """``serving_param_shardings`` on a tp=2 mesh: the specs of the JAX
    package's ``NamedSharding``s, leaf for leaf (int8 pairs too), and
    ``shard_serving_params``' chunks of those shapes."""
    import jax

    from kubeflow_controller_tpu.models import generate as jgen
    from kubeflow_controller_tpu.models import transformer as jtfm
    from kubeflow_controller_tpu.parallel import sharding as jsharding
    from kubeflow_controller_tpu.parallel.mesh import serving_mesh
    from kubeflow_controller_tpu_torch.parallel import sharding as tsharding

    cfg_j = jtfm.tiny_moe_config() if config == "tiny_moe" else jtfm.tiny_config()
    master = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(0)))
    params_j = jgen.inference_params(cfg_j, master, quant=quant)
    want = jsharding.serving_param_shardings(cfg_j, serving_mesh(2), quant)(params_j)
    cfg_t = ttfm.tiny_moe_config() if config == "tiny_moe" else ttfm.tiny_config()
    mesh = tmesh.Mesh(np.arange(2).reshape(1, 1, 1, 1, 1, 2))
    got = tsharding.serving_param_shardings(cfg_t, mesh, quant)
    params_t = tgen.inference_params(cfg_t, params_from_numpy(master, device="cpu"), quant)
    chunks = tsharding.shard_serving_params(cfg_t, params_t, mesh, quant)

    def walk(g, w, c, t):
        if isinstance(g, dict):
            assert set(g) == set(w)
            for k in g:
                walk(g[k], w[k], c[k], t[k])
        elif isinstance(g, tuple) and not isinstance(g, tsharding.P):
            for gs, ws, cs, ts in zip(g, w, c, t):
                walk(gs, ws, cs, ts)
        else:
            assert _spec_entries(g) == _spec_entries(w.spec)
            shape = list(t.shape)
            for d, e in enumerate(tuple(g)):
                if e is not None and "tp" in ((e,) if isinstance(e, str) else e):
                    shape[d] //= 2
            assert list(c.shape) == shape

    walk(got, want, chunks, params_t)


def test_pool_capacity_scales_with_tp():
    """At a fixed per-device budget the pool admits tp times the pages
    (the JAX package's ``test_tp_pool_capacity_scales_linearly``), and
    a rank's pool holds its ``KVH / tp`` heads."""
    cfg = ttfm.tiny_config(n_kv_heads=4)
    budget = 4 << 20
    b1 = kv_blocks.blocks_for_budget(cfg, BS, budget, "", tp=1)
    b4 = kv_blocks.blocks_for_budget(cfg, BS, budget, "", tp=4)
    assert b1 > 0 and b4 / b1 >= 3.5
    cache = tgen.init_paged_cache(cfg, 2, 4, 8, BS, "int8", device="cpu", tp=4)
    assert cache.k.shape[3] == 1 and cache.k_scale.shape[3] == 1
    assert tgen.pool_page_host_bytes(cache, tp=4) == 4 * tgen.pool_page_host_bytes(cache)


def test_one_process_refuses_tp_above_its_world():
    """Without a gang, tp > 1 raises the mesh's ValueError, after the
    head check (whose message comes first, as in the JAX engine)."""
    cfg = ttfm.tiny_config(n_kv_heads=4)
    params = tgen.inference_params(cfg, ttfm.init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="exceeds"):
        ServingEngine(cfg, params, n_slots=2, max_seq=MAX_SEQ, tp=2, device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads"):
        ServingEngine(cfg, params, n_slots=2, max_seq=MAX_SEQ, tp=3, device="cpu")
    with pytest.raises(ValueError, match="tp_compute"):
        ServingEngine(cfg, params, n_slots=2, max_seq=MAX_SEQ, tp_compute="x",
                      device="cpu")
    assert tmesh.serving_mesh(1) is None
