"""The port's serving engine and ``serve()`` held against the JAX engine:
greedy streams token-identical on pinned tiny-config workloads.

The JAX side runs ``ServingEngine(attn_impl="pallas")`` (Pallas kernels
in interpret mode on the CPU); the port runs ``attn_impl="kernel"``,
whose wrappers take their plain versions on CPU tensors. Both run the
same ``prefill_mode``: bucketed where a test says so, else exact (the
default of both). Workloads carry more requests than slots (slot reuse,
requeued admission), prompts that need a padded tail chunk, EOS and
budget retirement, and fp and int8 KV. The speculative engine's tests
are in ``test_torch_spec_decode.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane.serving_engine import (
    Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    pap.pltpu is None, reason="pallas TPU backend not built into this jax")

BS = 8
MAX_SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _weights():
    cfg_j = jtfm.tiny_config(n_kv_heads=4)
    cfg_t = ttfm.tiny_config(n_kv_heads=4)
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(1)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


# Prompt lengths: a padded single chunk (5), a full chunk (8), a full
# chunk plus a padded tail (13, 20); budgets keep every request within
# the 32-column table span.
PROMPT_LENS = (5, 13, 8, 20, 11, 6)
BUDGETS = (9, 7, 12, 6, 10, 8)


def _workload(eos_id):
    rng = np.random.default_rng(2)
    return [(rng.integers(0, 256, n).astype(np.int32), m, eos_id)
            for n, m in zip(PROMPT_LENS, BUDGETS)]


def _run_port(cfg, params, work, kv_quant, attn_impl="kernel",
              prefill_mode="bucketed"):
    eng = ServingEngine(cfg, params, n_slots=3, max_seq=MAX_SEQ,
                        block_size=BS, kv_quant=kv_quant,
                        prefill_mode=prefill_mode, attn_impl=attn_impl,
                        device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m, eos_id=e)
                   for i, (p, m, e) in enumerate(work)])
    assert eng.stats.submitted == eng.stats.finished == len(work)
    assert eng.pool.used_blocks == 0          # every page came back
    return {c.rid: (c.tokens, c.finish_reason) for c in out}


def _run_jax(cfg, params, work, kv_quant, prefill_mode="bucketed"):
    eng = JEngine(cfg, params, n_slots=3, max_seq=MAX_SEQ,
                  prefill_mode=prefill_mode, block_size=BS,
                  kv_quant=kv_quant, attn_impl="pallas")
    out = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=m, eos_id=e)
                   for i, (p, m, e) in enumerate(work)])
    return {c.rid: (c.tokens, c.finish_reason) for c in out}


def _pick_eos(streams):
    """A token that the greedy streams emit mid-way, so pinning it as EOS
    retires some requests early while others run to their budget."""
    counts = {}
    for toks, _ in streams.values():
        for t in toks[2:-1]:
            counts[t] = counts.get(t, 0) + 1
    return max(sorted(counts), key=lambda t: counts[t])


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["fp", "int8"])
def test_engine_streams_equal_jax_engine(kv_quant):
    cfg_j, cfg_t, params_j, params_t = _weights()
    eos = _pick_eos(_run_port(cfg_t, params_t, _workload(None), kv_quant))
    work = _workload(eos)
    got = _run_port(cfg_t, params_t, work, kv_quant)
    want = _run_jax(cfg_j, params_j, work, kv_quant)
    assert got == want
    reasons = {r for _, r in got.values()}
    assert reasons == {"eos", "length"}, reasons


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["fp", "int8"])
def test_exact_engine_streams_equal_jax_exact_engine(kv_quant):
    """Exact prefill (the default of both engines): each admission runs
    the whole prompt in one forward into the slot's pages. Token for
    token the JAX engine's streams in exact mode, for fp and int8 KV,
    with EOS and budget retirement and slot reuse; with fp KV, the same
    streams as bucketed prefill."""
    cfg_j, cfg_t, params_j, params_t = _weights()
    eos = _pick_eos(_run_port(cfg_t, params_t, _workload(None), kv_quant,
                              prefill_mode="exact"))
    work = _workload(eos)
    got = _run_port(cfg_t, params_t, work, kv_quant, prefill_mode="exact")
    assert got == _run_jax(cfg_j, params_j, work, kv_quant, "exact")
    assert {r for _, r in got.values()} == {"eos", "length"}
    if not kv_quant:
        # With int8 pages the two modes are different functions, in the
        # JAX package too: a bucketed chunk attends the earlier chunks'
        # quantized K/V, the exact forward the whole prompt's unquantized.
        assert got == _run_port(cfg_t, params_t, work, kv_quant)


def test_exact_admission_makes_the_slot_live_at_once():
    """An exact admission prefills in the step that admits and runs no
    prefill chunk; the slot's first token comes from the next dispatch.
    A max_seq off the block grid shrinks the page size to its largest
    power-of-two divisor, as in the JAX engine."""
    _, cfg_t, _, params_t = _weights()
    p, m, _ = _workload(None)[1]
    eng = ServingEngine(cfg_t, params_t, n_slots=2, max_seq=MAX_SEQ,
                        block_size=BS, device="cpu")
    assert eng.prefill_mode == "exact"
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=m))
    eng.step()
    assert eng.slots[0] is not None and eng.slots[0].prefill is None
    assert bool(eng.cache.active[0]) and int(eng.cache.length[0]) == p.size
    assert eng.stats.prefill_chunks == 0
    out = eng.run([])
    assert len(out[0].tokens) == m and eng.stats.prefill_chunks == 0
    odd = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=24,
                        block_size=16, device="cpu")
    assert (odd.block_size, odd.max_seq) == (8, 24)


def test_gather_and_kernel_paths_stream_equal():
    """The port's two attention paths commit the same greedy streams."""
    _, cfg_t, _, params_t = _weights()
    work = _workload(None)
    assert (_run_port(cfg_t, params_t, work, "", "kernel")
            == _run_port(cfg_t, params_t, work, "", "gather"))


def test_serve_streams_equal_jax_engine(tmp_path):
    """serve() (fresh init from its seed, synthetic prompts) against the
    JAX engine serving the same weights and prompts, more requests than
    slots, with an EOS id."""
    batch, prompt_len, max_new, slots = 5, 11, 9, 2
    cfg_t = ttfm.tiny_config()
    cfg_j = jtfm.tiny_config()
    params_t = tgen.inference_params(
        cfg_t, ttfm.init_params(cfg_t, seed=4, device="cpu"))
    params_j = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params_t)
    prompts = serve_lm._read_prompts("", cfg_t.vocab_size, batch, prompt_len)
    probe = JEngine(cfg_j, params_j, n_slots=slots,
                    max_seq=prompt_len + max_new, prefill_mode="bucketed",
                    block_size=BS, attn_impl="pallas")
    first = probe.run([JRequest(rid=i, prompt=prompts[i],
                                max_new_tokens=max_new)
                       for i in range(batch)])
    eos = _pick_eos({c.rid: (c.tokens, c.finish_reason) for c in first})
    eng = JEngine(cfg_j, params_j, n_slots=slots,
                  max_seq=prompt_len + max_new, prefill_mode="bucketed",
                  block_size=BS, attn_impl="pallas")
    want = {c.rid: c.tokens for c in eng.run([
        JRequest(rid=i, prompt=prompts[i], max_new_tokens=max_new,
                 eos_id=eos) for i in range(batch)])}
    out_file = tmp_path / "completions.jsonl"
    res = serve_lm.serve(config="tiny", batch=batch, prompt_len=prompt_len,
                         max_new_tokens=max_new, slots=slots, seed=4,
                         eos_id=eos, block_size=BS, device="cpu",
                         prefill_mode="bucketed", output_file=str(out_file))
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    got = {r["rid"]: r["completion"] for r in rows}
    assert got == want
    assert res["requests"] == batch
    assert res["tokens_out"] == sum(len(t) for t in want.values())
    assert all(r["prompt"] == prompts[r["rid"]].tolist() for r in rows)


def test_engine_refuses_what_is_not_ported():
    """Exact prefill, greedy speculative decoding, sampling, the prefix
    cache, the host tier, the radix proposer, the tracer, the fault
    injector and ``prefill_only`` requests (refused before they were
    ported) now build engines and serve, and the prefix cache with exact
    prefill, the tier without the cache, the radix proposer without the
    trie and ``prefill_only`` with exact prefill raise the JAX engine's
    ValueErrors. Tensor parallelism is ported: ``tp=2`` in one process
    has no gang of two ranks, and the serving mesh raises its
    ValueError."""
    from kubeflow_controller_tpu_torch.dataplane.faults import FaultInjector
    from kubeflow_controller_tpu_torch.obs.trace import Tracer

    _, cfg_t, _, params_t = _weights()
    for kw in (dict(tracer=Tracer()), dict(injector=FaultInjector())):
        eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                            device="cpu", **kw)
        (out,) = eng.run([Request(rid=0, prompt=np.arange(5),
                                  max_new_tokens=3)])
        assert len(out.tokens) == 3
    assert eng.fault_target == ""
    eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="prefill_only requires"):
        eng.submit(Request(rid=1, prompt=np.arange(5), max_new_tokens=3,
                           prefill_only=True))
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16, device="cpu",
                      tp=2)
    for kw, msg in ((dict(prefix_cache=True), "prefix_cache requires"),
                    (dict(host_kv_mb=1.0, prefill_mode="bucketed"),
                     "requires prefix_cache"),
                    (dict(spec_decode=True, proposer="radix"),
                     "requires prefix_cache")):
        with pytest.raises(ValueError, match=msg):
            ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                          device="cpu", **kw)
    for kw in (dict(prefill_mode="exact"), dict(spec_decode=True),
               dict(spec_decode=True, prefill_mode="bucketed", draft_k=2),
               dict(prefill_mode="bucketed", prefix_cache=True,
                    host_kv_mb=1.0, spec_decode=True, proposer="radix")):
        eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                            device="cpu", **kw)
        assert eng.prefill_mode == kw.get("prefill_mode", "exact")
        assert eng.spec_decode == kw.get("spec_decode", False)
        assert (eng._host_tier is not None) == ("host_kv_mb" in kw)
    eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                        temperature=0.5, top_k=5, top_p=0.9, seed=3,
                        device="cpu")
    assert not eng._default_params.is_greedy
    with pytest.raises(ValueError, match="temperature"):
        ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                      temperature=-1.0, device="cpu")
    with pytest.raises(ValueError, match="draft_k"):
        ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                      spec_decode=True, draft_k=0, device="cpu")


def test_drain_and_deadline_retire_with_partial_output():
    """drain() sheds the queue and deadline-retires what is decoding;
    every request comes back, and every page returns to the pool."""
    _, cfg_t, _, params_t = _weights()
    now = [0.0]
    eng = ServingEngine(cfg_t, params_t, n_slots=2, max_seq=MAX_SEQ,
                        block_size=BS, clock=lambda: now[0],
                        prefill_mode="bucketed", device="cpu")
    for i, (p, m, _) in enumerate(_workload(None)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    eng.step()
    eng.step()
    assert any(s is not None for s in eng.slots)
    out = eng.drain(grace_s=0.0)
    assert sorted(c.rid for c in out) == list(range(len(PROMPT_LENS)))
    reasons = {c.finish_reason for c in out}
    assert reasons <= {"shed", "deadline", "eos", "length"}
    assert "shed" in reasons and "deadline" in reasons
    assert eng.pool.used_blocks == 0
    assert not bool(eng.cache.active.any())


def test_deadline_retires_in_flight_and_sheds_queued():
    _, cfg_t, _, params_t = _weights()
    now = [0.0]
    eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=MAX_SEQ,
                        block_size=BS, clock=lambda: now[0],
                        prefill_mode="bucketed", device="cpu")
    p, m, _ = _workload(None)[1]
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=m, deadline_s=5.0))
    eng.submit(Request(rid=1, prompt=p, max_new_tokens=m, deadline_s=1.0))
    for _ in range(4):
        eng.step()
    now[0] = 10.0
    # The shed lands in the buffer the NEXT step returns, as in the JAX
    # engine.
    out = {c.rid: c for c in eng.step() + eng.step()}
    assert out[0].finish_reason == "deadline" and out[0].tokens
    assert out[1].finish_reason == "shed" and out[1].tokens == []
    assert eng.idle and eng.pool.used_blocks == 0


def test_cli_serves_on_cpu_and_refuses_unported_flags(tmp_path):
    out = tmp_path / "out.jsonl"
    argv = ["--config", "tiny", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "9", "--max-new-tokens", "4",
            "--block-size", "8", "--output", str(out)]
    assert serve_lm.main(argv) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["rid"] for r in rows] == [0, 1, 2]
    assert all(len(r["completion"]) == 4 for r in rows)
    # Tensor parallelism is ported: one process is no gang of two ranks.
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        serve_lm.main(argv + ["--tp", "2"])
    # Weight-only int8 serves now (its streams are held to the JAX
    # engine's in test_int8_engine_streams_equal_jax_engine).
    assert serve_lm.main(argv + ["--quant", "int8"]) == 0
    assert all(len(json.loads(line)["completion"]) == 4
               for line in out.read_text().splitlines())
    # The radix proposer serves now, and needs the trie, as in JAX.
    with pytest.raises(ValueError, match="requires prefix_cache"):
        serve_lm.main(argv + ["--speculative", "--proposer", "radix"])
    # Sampling serves now: a seeded run writes the same file twice, and
    # its streams are not the greedy ones.
    sampled = []
    for _ in range(2):
        assert serve_lm.main(argv + ["--temperature", "0.5"]) == 0
        sampled.append([json.loads(line)
                        for line in out.read_text().splitlines()])
    assert sampled[0] == sampled[1] and sampled[0] != rows
    assert all(len(r["completion"]) == 4 for r in sampled[0])
    # Refused until ported; the same completions now, by every route.
    for flag in (["--speculative"], ["--speculative", "--draft-k", "2"],
                 ["--prefill-mode", "bucketed"],
                 ["--model-dir", str(tmp_path / "empty")],
                 ["--prefix-cache"], ["--prefix-cache", "--host-kv-mb", "1"],
                 ["--prefix-cache", "--speculative", "--proposer", "radix"]):
        assert serve_lm.main(argv + flag) == 0
        again = [json.loads(line) for line in out.read_text().splitlines()]
        assert again == rows, flag
    # The fleet serves now: disaggregated, traced, under a fault plan
    # (one payload lost in flight) and the watchdog, the same rows.
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"specs": [
        {"kind": "drop_migration", "site": "router.migrate", "max_fires": 1}]}))
    for flag in (["--disagg"], ["--disagg", "--trace", str(tmp_path / "t.json")],
                 ["--disagg", "--fault-plan", str(plan), "--fault-seed", "4",
                  "--watchdog-stale-s", "30"],
                 ["--fault-plan", str(plan)]):
        assert serve_lm.main(argv + flag) == 0
        again = [json.loads(line) for line in out.read_text().splitlines()]
        assert again == rows, flag
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_admission_control_rejects_with_typed_reasons():
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Rejected,
    )
    _, cfg_t, _, params_t = _weights()
    eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=MAX_SEQ,
                        block_size=BS, max_queue=1, device="cpu")
    p, m, _ = _workload(None)[0]
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=m))
    with pytest.raises(Rejected) as e:
        eng.submit(Request(rid=1, prompt=p, max_new_tokens=m))
    assert e.value.reason == "queue_full"
    with pytest.raises(ValueError, match="duplicate rid"):
        eng.submit(Request(rid=0, prompt=p, max_new_tokens=m))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(rid=2, prompt=p, max_new_tokens=MAX_SEQ))
    eng.drain(grace_s=0.0)
    with pytest.raises(Rejected) as e:
        eng.submit(Request(rid=3, prompt=p, max_new_tokens=m))
    assert e.value.reason == "draining"
    assert eng.stats.rejected == 2


def test_small_pool_requeues_until_pages_free():
    """A pool too small for every slot's reservation admits what fits,
    requeues the rest at the head, and admits it once retirements free
    pages — streams equal to an engine with a full-size pool."""
    _, cfg_t, _, params_t = _weights()
    work = _workload(None)
    want = _run_port(cfg_t, params_t, work, "")
    eng = ServingEngine(cfg_t, params_t, n_slots=3, max_seq=MAX_SEQ,
                        block_size=BS, kv_pool_blocks=4,
                        prefill_mode="bucketed", device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m, _) in enumerate(work)])
    assert {c.rid: (c.tokens, c.finish_reason) for c in out} == want
    assert eng.pool.used_blocks == 0


@pytest.mark.parametrize("env", [
    dict(model_dir="/nonexistent"), dict(num_processes=2, process_id=1),
], ids=["ctx_model_dir", "num_processes=2"])
def test_serve_refuses_the_job_env_it_cannot_honour(env, caplog):
    """A multi-process job serves at tp equal to its process count (one
    process a tp rank; ``tests/test_torch_tp_serving.py`` serves one), and
    any other tp is refused before the job joins a group. A job's model
    dir (refused until checkpoints were ported) is read: with no
    checkpoint in it, serve() warns and serves the fresh init, reporting
    restored_step -1, as the JAX entry point does."""
    from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext

    kw = dict(config="tiny", batch=2, prompt_len=9, max_new_tokens=2,
              device="cpu")
    if "model_dir" not in env:
        with pytest.raises(ValueError, match="serves at tp=2"):
            serve_lm.serve(ProcessContext(**env), **kw)
        return
    with caplog.at_level("WARNING", logger="tpujob.serve_lm_torch"):
        res = serve_lm.serve(ProcessContext(**env), **kw)
    assert res["restored_step"] == -1 and res["requests"] == 2
    assert "no checkpoint found" in caplog.text


def test_attn_impl_takes_the_reference_names(tmp_path):
    """``xla`` and ``pallas`` (the JAX engine's names) serve exactly what
    ``gather`` and ``kernel`` serve: the same greedy streams."""
    streams = {}
    for impl in ("gather", "xla", "kernel", "pallas"):
        out = tmp_path / f"{impl}.jsonl"
        serve_lm.serve(config="tiny", batch=3, prompt_len=9, max_new_tokens=5,
                       slots=2, block_size=BS, seed=2, attn_impl=impl,
                       device="cpu", output_file=str(out))
        streams[impl] = [json.loads(line)["completion"]
                         for line in out.read_text().splitlines()]
    assert streams["xla"] == streams["gather"]
    assert streams["pallas"] == streams["kernel"]
    assert all(len(s) == 5 for s in streams["xla"])
    assert tgen.check_attn_impl("xla") == "gather"
    assert tgen.check_attn_impl("pallas") == "kernel"
    with pytest.raises(ValueError, match="attn_impl"):
        tgen.check_attn_impl("dense")


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser ``main`` builds, caught at its parse_args."""
    import argparse

    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
    return {o: a for a in seen[0]._actions for o in a.option_strings
            if o not in ("-h", "--help")}


def _off_default(action):
    """A command-line value of ``action`` other than its default."""
    import argparse

    if isinstance(action, argparse.BooleanOptionalAction):
        return ["--no-" + action.dest.replace("_", "-")] if action.default else [
            action.option_strings[0]]
    if action.nargs == 0:                                 # store_true
        return [action.option_strings[0]]
    if action.choices:
        return [action.option_strings[0],
                next(c for c in action.choices if c != action.default)]
    value = {int: action.default + 1 if isinstance(action.default, int) else 2,
             float: (action.default or 0.0) + 0.5}.get(action.type, "x")
    return [action.option_strings[0], str(value)]


#: (entry point, the reference's defaults the port keeps on purpose
#: different: its attention kernels)
PARSERS = {
    "serve_lm": {"--attn-impl": "kernel"},
    "lm": {},
}


@pytest.mark.parametrize("entry", sorted(PARSERS))
def test_cli_takes_every_reference_option_and_refuses_off_default_values(
        entry, monkeypatch, tmp_path):
    """Every option of the JAX entry point's parser is an option of the
    port's, with the same default (but for the deliberate differences in
    PARSERS), so a manifest written for the JAX entry point parses; each
    option the port does not serve yet is refused with "not yet ported"
    at any value off its default. The options refused until exact
    prefill, checkpoints, speculative decoding, sampling and the prefix
    cache were ported now serve off their defaults, and ``--host-kv-mb``
    without ``--prefix-cache`` takes the reference's ``p.error``. The
    LM trainer's ``--tp`` and ``--fsdp``, refused until multi-process
    training was ported, and ``--sp``, refused until the
    sequence-parallel slice, build the job's mesh; ``--attn ring``
    trains."""
    import importlib

    jmain = importlib.import_module(
        f"kubeflow_controller_tpu.dataplane.entrypoints.{entry}").main
    tmod = importlib.import_module(
        f"kubeflow_controller_tpu_torch.dataplane.entrypoints.{entry}")
    ref, port = _parser_of(jmain, monkeypatch), _parser_of(tmod.main, monkeypatch)
    for opt, action in ref.items():
        assert opt in port, f"{entry}: {opt} missing"
        want = PARSERS[entry].get(opt, action.default)
        assert port[opt].default == want, (entry, opt, port[opt].default)
    if entry == "serve_lm":
        # Every option of the JAX serve parser is ported (the fleet's
        # were the last refused).
        unported = []
        base = ["--config", "tiny", "--device", "cpu", "--batch", "1",
                "--prompt-len", "9", "--max-new-tokens", "1", "--block-size", "8"]
        ported = [["--model-dir", str(tmp_path)], ["--speculative"],
                  _off_default(port["--draft-k"]),
                  _off_default(port["--prefill-mode"]),
                  ["--temperature", "0.5"], ["--top-k", "3"],
                  ["--top-p", "0.5"], ["--n", "2"], ["--grammar", "re:[0-9]+"],
                  _off_default(port["--proposer"]),
                  _off_default(port["--turns"]),
                  _off_default(port["--prefix-cache"]),
                  ["--prefix-cache"] + _off_default(port["--host-kv-mb"]),
                  _off_default(port["--quant"]),
                  _off_default(port["--paged"]) + ["--turns", "2"]]
        assert ported[3] == ["--prefill-mode", "bucketed"]
        assert ported[9:12] == [["--proposer", "radix"], ["--turns", "2"],
                                ["--prefix-cache"]]
        assert ported[13:] == [["--quant", "int8"], ["--no-paged", "--turns", "2"]]
        # The fleet's options (refused until the fleet was ported) serve
        # off their defaults too.
        plan = tmp_path / "plan.json"
        plan.write_text('{"specs": [{"kind": "hang", "site": "engine.step", '
                        '"max_fires": 1}]}')
        ported += [_off_default(port["--disagg"]),
                   ["--trace", str(tmp_path / "t.json")],
                   ["--fault-plan", str(plan)],
                   _off_default(port["--fault-seed"]),
                   ["--disagg"] + _off_default(port["--watchdog-stale-s"])]
        assert ported[-5:-3] == [["--disagg"], ["--trace", str(tmp_path / "t.json")]]
        # The reference's p.error: the watchdog needs the fleet.
        with pytest.raises(SystemExit) as e:
            tmod.main(base + _off_default(port["--watchdog-stale-s"]))
        assert e.value.code == 2
        # The reference engine's ValueError: --no-paged on the engine path.
        with pytest.raises(ValueError, match="paged=False"):
            tmod.main(base + ["--no-paged"])
        # The reference's p.error: the tier needs the cache.
        with pytest.raises(SystemExit) as e:
            tmod.main(base + _off_default(port["--host-kv-mb"]))
        assert e.value.code == 2
    else:
        unported = []
        base = ["--config", "tiny", "--device", "cpu", "--total-steps", "1",
                "--batch", "1", "--seq-len", "32"]
        # --attn ring trains (one process: the dense attention; two
        # steps, as the LM schedule needs a step after its warmup).
        ported = [["--attn", "ring", "--total-steps", "2"]]
        # --tp, --fsdp and --sp name the job's mesh (ported): one process
        # is a world of one rank, which such a mesh cannot fill, and
        # MeshConfig.resolve says so as the reference's does.
        for opt in ("--tp", "--fsdp", "--sp"):
            with pytest.raises(ValueError, match="not divisible"):
                tmod.main(base + _off_default(port[opt]))
    off = [_off_default(a) for a in unported]
    for flag in off:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tmod.main(base + flag)
    for flag in ported:
        assert tmod.main(base + flag) == 0, flag


# -- weight-only int8 serving ----------------------------------------------------

def _int8_weights(dtype="float32", **cfg_kw):
    """The tiny config's fp32 master weights quantized by each package's
    ``inference_params(quant="int8")``."""
    import jax.numpy as jnp
    import torch

    cfg_j = jtfm.tiny_config(n_kv_heads=4, dtype=getattr(jnp, dtype), **cfg_kw)
    cfg_t = ttfm.tiny_config(n_kv_heads=4, dtype=getattr(torch, dtype), **cfg_kw)
    master = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(1)))
    params_j = jgen.inference_params(cfg_j, master, quant="int8")
    params_t = tgen.inference_params(
        cfg_t, params_from_numpy(master, device="cpu"), quant="int8")
    return cfg_j, cfg_t, params_j, params_t


def _bits(x):
    """An array's bytes as unsigned integers (bf16 has no numpy dtype)."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weights_bitwise_equal_jax_inference_params(dtype):
    """``inference_params(quant="int8")``: every projection of
    ``_QUANT_KEYS`` becomes ``(q, scale)``, codes and scales (stored in
    the compute dtype) bit for bit the JAX package's; the embedding and
    the norms are cast as before."""
    _, _, params_j, params_t = _int8_weights(dtype)
    keys = set(tgen._QUANT_KEYS)
    pairs = {"lm_head": (params_j["lm_head"], params_t["lm_head"])}
    pairs.update({k: (params_j["layers"][k], params_t["layers"][k])
                  for k in keys - {"lm_head"}})
    for k, (pj, pt) in pairs.items():
        assert isinstance(pj, tuple) and isinstance(pt, tuple), k
        assert pt[0].dtype == __import__("torch").int8, k
        np.testing.assert_array_equal(np.asarray(pj[0]), pt[0].numpy(), err_msg=k)
        assert np.asarray(pj[1]).shape == tuple(pt[1].shape), k
        np.testing.assert_array_equal(_bits(pj[1]), _bits(pt[1]), err_msg=k)
    for k in ("attn_norm", "mlp_norm"):
        np.testing.assert_array_equal(_bits(params_j["layers"][k]),
                                      _bits(params_t["layers"][k]))
    np.testing.assert_array_equal(_bits(params_j["embed"]), _bits(params_t["embed"]))
    assert tgen.weight_quant(params_t) == "int8"
    with pytest.raises(ValueError, match="quant must be"):
        tgen.inference_params(ttfm.tiny_config(), {}, quant="int4")


@pytest.mark.parametrize("prefill_mode,kv_quant", [
    ("exact", ""), ("exact", "int8"), ("bucketed", ""), ("bucketed", "int8"),
], ids=["exact-fp", "exact-int8kv", "bucketed-fp", "bucketed-int8kv"])
def test_int8_engine_streams_equal_jax_engine(prefill_mode, kv_quant):
    """Greedy streams with weight-only int8 projections, token for token
    the JAX engine's: exact and bucketed prefill, fp and int8 KV, EOS
    and budget retirement, slot reuse."""
    cfg_j, cfg_t, params_j, params_t = _int8_weights()
    eos = _pick_eos(_run_port(cfg_t, params_t, _workload(None), kv_quant,
                              prefill_mode=prefill_mode))
    work = _workload(eos)
    got = _run_port(cfg_t, params_t, work, kv_quant, prefill_mode=prefill_mode)
    want = _run_jax(cfg_j, params_j, work, kv_quant, prefill_mode=prefill_mode)
    assert got == want
    assert {r for _, r in got.values()} == {"eos", "length"}


@pytest.mark.parametrize("prefill_mode", ["exact", "bucketed"])
def test_int8_speculative_streams_equal_jax_engine(prefill_mode):
    """Prompt-lookup speculation over int8 weights on repeating prompts:
    the JAX engine's streams and spec counters, drafts accepted."""
    cfg_j, cfg_t, params_j, params_t = _int8_weights()
    rng = np.random.default_rng(5)
    work = [(np.tile(rng.integers(0, 256, 4), 4)[:n].astype(np.int32), m)
            for n, m in ((13, 9), (16, 8), (11, 10), (14, 7))]
    kw = dict(n_slots=2, max_seq=MAX_SEQ, block_size=BS,
              prefill_mode=prefill_mode, spec_decode=True, draft_k=4)
    eng = ServingEngine(cfg_t, params_t, attn_impl="kernel", device="cpu", **kw)
    got = {c.rid: c.tokens for c in eng.run(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(work)])}
    jeng = JEngine(cfg_j, params_j, attn_impl="pallas", **kw)
    want = {c.rid: c.tokens for c in jeng.run(
        [JRequest(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(work)])}
    assert got == want
    for k in ("draft_proposed", "draft_accepted", "spec_steps"):
        assert getattr(eng.stats, k) == getattr(jeng.stats, k), k
    assert eng.stats.spec_steps > 0


def test_serve_int8_equals_jax_serve(tmp_path, monkeypatch):
    """``serve(quant="int8")`` writes the completions file and the traffic
    gauges the JAX ``serve(quant="int8")`` writes on the same fp32
    weights, quantized after they load."""
    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve

    cfg_j = jtfm.tiny_config()
    master = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(0)))
    monkeypatch.setattr(serve_lm, "_load_params", lambda *a, **k: (
        params_from_numpy(master, device="cpu"), None))
    common = dict(config="tiny", batch=3, prompt_len=9, max_new_tokens=5,
                  slots=2, block_size=4, quant="int8", attn_impl="pallas")
    files, res = [], []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", serve_lm.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        res.append(serve(output_file=str(out), **common, **extra))
        files.append([json.loads(line) for line in out.read_text().splitlines()])
    assert files[0] == files[1] and len(files[1]) == 3
    for k in ("hbm_bytes_per_step", "hbm_bytes_per_step_prefill",
              "flops_per_token_per_shard", "kv_hbm_per_device_mb", "requests"):
        assert res[0][k] == res[1][k], k


# -- C8: the summary's keys ------------------------------------------------------

#: Summary keys the port does not publish: the jit-cache counts. (The MoE
#: keys left this set with the MoE decoder, the tp gauges with tensor
#: parallelism, the migration, fault and span counters with the fleet.)
REFUSED_SUMMARY_KEYS = {"prefill_compiles", "admit_cache_size"}


@pytest.mark.parametrize("impl,quant", [("pallas", ""), ("xla", "int8")],
                         ids=["kernel-fp", "gather-int8"])
def test_summary_keys_and_values_equal_jax_engine_on_a_cancelling_trace(
        impl, quant):
    """On one trace that cancels a queued and an in-flight request, the
    port's summary has the JAX engine's keys but those of refused
    features, and every shared value equal (a frozen clock makes the
    latencies 0 on both): ``cancelled``, the pool gauges and the traffic
    model, for the kernel and the gather path, fp and int8 weights."""
    if quant:
        cfg_j, cfg_t, params_j, params_t = _int8_weights()
    else:
        cfg_j, cfg_t, params_j, params_t = _weights()
    work = _workload(None)
    kw = dict(n_slots=3, max_seq=MAX_SEQ, block_size=BS,
              prefill_mode="bucketed", clock=lambda: 0.0)
    engines = (ServingEngine(cfg_t, params_t, attn_impl=impl, device="cpu", **kw),
               JEngine(cfg_j, params_j, attn_impl=impl, **kw))
    summaries = []
    for eng, req in zip(engines, (Request, JRequest)):
        for i, (p, m, e) in enumerate(work):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=m, eos_id=e))
        out = eng.step() + eng.step() + eng.step()
        assert eng.cancel(5) and eng.cancel(0)
        while not eng.idle:
            out += eng.step()
        assert sorted(c.rid for c in out) == list(range(len(work)))
        summaries.append(eng.stats.summary())
    got, want = summaries
    assert set(got) == set(want) - REFUSED_SUMMARY_KEYS
    assert want["cancelled"] == 2
    assert {k: got[k] for k in got} == {k: want[k] for k in got}


# -- C9: paged=False -------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(turns=1), dict(turns=3), dict(turns=1, n=2)],
                         ids=["turns1", "turns3", "n2"])
def test_no_paged_outcome_equals_jax_serve(kw, tmp_path, monkeypatch):
    """``paged=False`` gives the reference's outcome: the engine's
    ``ValueError`` for one turn and for ``n > 1``, the contiguous path's
    completions for three turns (the same file as the JAX serve())."""
    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve

    cfg_j = jtfm.tiny_config()
    master = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(0)))
    monkeypatch.setattr(serve_lm, "_load_params", lambda *a, **k: (
        params_from_numpy(master, device="cpu"), None))
    common = dict(config="tiny", batch=2, prompt_len=9, max_new_tokens=4,
                  block_size=4, paged=False, **kw)
    outcomes = []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", serve_lm.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        try:
            serve(output_file=str(out), **common, **extra)
        except Exception as e:                      # the outcome compared
            outcomes.append(type(e))
            continue
        outcomes.append([json.loads(line) for line in out.read_text().splitlines()])
    assert outcomes[0] == outcomes[1]
    if kw["turns"] == 3:
        assert len(outcomes[1]) == 2
        assert all(len(r["completion"]) == 12 for r in outcomes[1])
    else:
        assert outcomes[1] is ValueError


def test_serve_model_dir_int8_quantizes_the_restored_fp32_weights(tmp_path):
    """``serve(model_dir=..., quant="int8")`` restores the checkpoint's
    fp32 weights and then quantizes them: its streams are the JAX
    engine's on the JAX package's ``inference_params(quant="int8")`` of
    the same fp32 weights (exact prefill, the default of both); the
    command line's ``--model-dir --quant int8`` writes the same file."""
    from kubeflow_controller_tpu_torch.convert import params_to_numpy
    from kubeflow_controller_tpu_torch.dataplane import train as ttrain
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm as tlm

    tlm.train(config="tiny", total_steps=2, per_data_shard_batch=2, seq_len=32,
              model_dir=str(tmp_path), device="cpu")
    master = params_to_numpy(ttrain.load_params(str(tmp_path), 2, "cpu"))
    cfg_j = jtfm.tiny_config()
    params_j = jgen.inference_params(cfg_j, master, quant="int8")
    prompts = serve_lm._read_prompts("", cfg_j.vocab_size, 3, 9)
    eng = JEngine(cfg_j, params_j, n_slots=3, max_seq=9 + 6, attn_impl="pallas")
    want = {c.rid: c.tokens for c in eng.run([
        JRequest(rid=i, prompt=prompts[i], max_new_tokens=6) for i in range(3)])}
    out_file = tmp_path / "out.jsonl"
    res = serve_lm.serve(config="tiny", model_dir=str(tmp_path), batch=3,
                         prompt_len=9, max_new_tokens=6, quant="int8",
                         device="cpu", output_file=str(out_file))
    assert res["restored_step"] == 2
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert {r["rid"]: r["completion"] for r in rows} == want
    assert serve_lm.main(["--config", "tiny", "--device", "cpu", "--batch", "3",
                          "--prompt-len", "9", "--max-new-tokens", "6",
                          "--model-dir", str(tmp_path), "--quant", "int8",
                          "--output", str(out_file)]) == 0
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert {r["rid"]: r["completion"] for r in rows} == want
