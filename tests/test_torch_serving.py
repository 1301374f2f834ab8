"""The port's serving engine and ``serve()`` held against the JAX engine:
greedy streams token-identical on pinned tiny-config workloads.

The JAX side runs ``ServingEngine(prefill_mode="bucketed",
attn_impl="pallas")`` (Pallas kernels in interpret mode on the CPU); the
port runs its defaults (bucketed prefill, ``attn_impl="kernel"``, whose
wrappers take their plain versions on CPU tensors). Workloads carry more
requests than slots (slot reuse, requeued admission), prompts that need
a padded tail chunk, EOS and budget retirement, and fp and int8 KV.
"""

import json

import jax
import numpy as np
import pytest

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


def _run_port(cfg, params, work, kv_quant, attn_impl="kernel"):
    eng = ServingEngine(cfg, params, n_slots=3, max_seq=MAX_SEQ,
                        block_size=BS, kv_quant=kv_quant,
                        attn_impl=attn_impl, device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m, eos_id=e)
                   for i, (p, m, e) in enumerate(work)])
    assert eng.stats.submitted == eng.stats.finished == len(work)
    assert eng.pool.used_blocks == 0          # every page came back
    return {c.rid: (c.tokens, c.finish_reason) for c in out}


def _run_jax(cfg, params, work, kv_quant):
    eng = JEngine(cfg, params, n_slots=3, max_seq=MAX_SEQ,
                  prefill_mode="bucketed", block_size=BS,
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
                         output_file=str(out_file))
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    got = {r["rid"]: r["completion"] for r in rows}
    assert got == want
    assert res["requests"] == batch
    assert res["tokens_out"] == sum(len(t) for t in want.values())
    assert all(r["prompt"] == prompts[r["rid"]].tolist() for r in rows)


def test_engine_refuses_what_is_not_ported():
    _, cfg_t, _, params_t = _weights()
    for kw in (dict(prefill_mode="exact"), dict(prefix_cache=True),
               dict(spec_decode=True), dict(temperature=0.5), dict(tp=2),
               dict(host_kv_mb=1.0)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ServingEngine(cfg_t, params_t, n_slots=1, max_seq=16,
                          device="cpu", **kw)


def test_drain_and_deadline_retire_with_partial_output():
    """drain() sheds the queue and deadline-retires what is decoding;
    every request comes back, and every page returns to the pool."""
    _, cfg_t, _, params_t = _weights()
    now = [0.0]
    eng = ServingEngine(cfg_t, params_t, n_slots=2, max_seq=MAX_SEQ,
                        block_size=BS, clock=lambda: now[0], device="cpu")
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
                        block_size=BS, clock=lambda: now[0], device="cpu")
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
    for flag in (["--temperature", "0.5"], ["--speculative"], ["--tp", "2"],
                 ["--quant", "int8"], ["--prefill-mode", "exact"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            serve_lm.main(argv + flag)


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
                        block_size=BS, kv_pool_blocks=4, device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m, _) in enumerate(work)])
    assert {c.rid: (c.tokens, c.finish_reason) for c in out} == want
    assert eng.pool.used_blocks == 0
