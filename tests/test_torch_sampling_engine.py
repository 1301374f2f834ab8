"""The port's sampling engine held against the JAX engine, on the CPU.

Mirrors ``tests/test_sampling.py`` at ``tiny_config(n_kv_heads=4)``, fp32,
with weights from the JAX init crossing as numpy arrays:

* a seeded sampled stream is a function of the request alone: the same
  whether it runs alone or last into churning greedy traffic, in exact
  or bucketed prefill, at any ``decode_chunk`` — and token for token the
  JAX engine's, with and without speculative decoding;
* greedy rows in a mixed batch keep the all-greedy engine's streams, on
  the plain path and through the sampled verifier;
* ``n = 4`` prefills once, shares the prompt's full pages, copies the
  boundary page once a child, diverges by generation and equals the JAX
  engine's generations; forks are leak-free under ``cancel`` and
  ``drain`` with the owner-set debug mode on;
* the token-set, regex and JSON masks confine every emitted token. The
  JSON case holds the contract ``test_json_mask_every_prefix_valid_and_
  parses`` states (every token admissible; a stream that reaches EOS
  parses) on sampled requests of which several reach EOS.

The JAX engine runs its default ``attn_impl="xla"`` (the gathered-view
oracle); the port runs ``"kernel"`` (on CPU tensors its plain version).
The tensor-parallel case of the reference (tp = 2) is not ported.
"""

import functools
import json
import re

import jax
import numpy as np
import pytest

from kubeflow_controller_tpu.dataplane import sampling as jsamp
from kubeflow_controller_tpu.dataplane import spec_decode as jspec
from kubeflow_controller_tpu.dataplane.serving_engine import (
    Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import sampling as tsamp
from kubeflow_controller_tpu_torch.dataplane import spec_decode as tspec
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import transformer as ttfm

MAX_SEQ = 48


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


@functools.lru_cache(None)
def _models():
    cfg_j = jtfm.tiny_config(n_kv_heads=4)
    cfg_t = ttfm.tiny_config(n_kv_heads=4)
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(0)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _pkg(port):
    return (Request, tsamp) if port else (JRequest, jsamp)


def _probe(port, rid=100, max_new=8, n=1, seed=123, mask=None):
    """THE sampled request every engine configuration must agree on."""
    req, samp = _pkg(port)
    return req(rid=rid,
               prompt=np.random.default_rng(7).integers(0, 256, 9).astype(
                   np.int32),
               max_new_tokens=max_new,
               params=samp.SamplingParams(temperature=0.9, top_k=20,
                                          top_p=0.95, n=n, seed=seed,
                                          logit_mask=mask))


def _greedy_reqs(port, n=5, seed=1):
    req, _ = _pkg(port)
    rng = np.random.default_rng(seed)
    return [req(rid=i, prompt=rng.integers(0, 256, 4 + i % 5).astype(np.int32),
                max_new_tokens=5 + i % 4) for i in range(n)]


def _sampled_reqs(port, n=5):
    """Sampled requests with every knob mix (and a greedy one)."""
    req, samp = _pkg(port)
    rng = np.random.default_rng(11)
    knobs = [(0.9, 20, 0.95), (1.3, 0, 1.0), (0.7, 5, 1.0), (0.0, 0, 1.0),
             (1.0, 0, 0.8)]
    return [req(rid=10 + i,
                prompt=rng.integers(0, 256, 5 + 3 * i).astype(np.int32),
                max_new_tokens=6 + i,
                params=samp.SamplingParams(temperature=t, top_k=k, top_p=p,
                                           seed=1000 * i + 7))
            for i, (t, k, p) in enumerate(knobs[:n])]


def _run(port, reqs, **kw):
    cfg_j, cfg_t, params_j, params_t = _models()
    kw.setdefault("max_seq", MAX_SEQ)
    if port:
        eng = ServingEngine(cfg_t, params_t, device="cpu", **kw)
    else:
        eng = JEngine(cfg_j, params_j, **kw)
    comps = eng.run(list(reqs))
    return {(c.rid, c.gen): list(c.tokens) for c in comps}, eng


@functools.lru_cache(None)
def _repro():
    """The probe and greedy streams under several engine flavours, run
    once for the tests below."""
    base_g, _ = _run(True, _greedy_reqs(True), n_slots=3,
                     prefill_mode="bucketed", block_size=4)
    alone, _ = _run(True, [_probe(True)], n_slots=2)
    # Probe submitted LAST into churning greedy traffic: 2 slots over 6
    # requests, bucketed prefill, decode_chunk=1.
    mixed, eng_m = _run(True, _greedy_reqs(True) + [_probe(True)], n_slots=2,
                        prefill_mode="bucketed", block_size=4, decode_chunk=1)
    # Probe FIRST, decode_chunk=3.
    first, _ = _run(True, [_probe(True)] + _greedy_reqs(True), n_slots=3,
                    prefill_mode="bucketed", block_size=4, decode_chunk=3)
    return dict(base_g=base_g, alone=alone, mixed=mixed, first=first,
                eng_mixed=eng_m)


def test_fixed_seed_stream_bit_identical_across_batch_and_churn():
    r = _repro()
    k = (100, 0)
    assert r["alone"][k] == r["mixed"][k] == r["first"][k]
    assert len(r["alone"][k]) == 8
    assert r["eng_mixed"].stats.sampled_requests == 1
    assert r["eng_mixed"].stats.summary()["sampled_requests"] == 1.0


def test_greedy_rows_bit_identical_in_mixed_batch():
    r = _repro()
    for key, toks in r["base_g"].items():
        assert r["mixed"][key] == toks
        assert r["first"][key] == toks


@pytest.mark.parametrize("mode", ["exact", "bucketed"])
def test_sampled_streams_equal_jax_engine(mode):
    """Seeded sampled streams with mixed knobs, a greedy row among them,
    over fewer slots than requests: token for token the JAX engine's; the
    port's own run in reverse submission order commits the same."""
    kw = dict(n_slots=3, prefill_mode=mode, block_size=4, decode_chunk=2)
    got, eng = _run(True, _sampled_reqs(True), **kw)
    want, _ = _run(False, _sampled_reqs(False), **kw)
    assert got == want
    rev, _ = _run(True, _sampled_reqs(True)[::-1], **kw)
    assert rev == got
    assert eng.stats.sampled_requests == 4 and eng.pool.used_blocks == 0


class _Oracle:
    """Drafts a request's own stream from a plain run (known in
    advance), so the sampled verifier accepts multi-token runs."""

    def __init__(self, reqs, streams):
        self.book = [(np.asarray(r.prompt), streams[(r.rid, 0)])
                     for r in reqs]

    def propose(self, contexts, k):
        draft = np.zeros((len(contexts), k), np.int32)
        lens = np.zeros((len(contexts),), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            for prompt, stream in self.book:
                m = ctx.size - prompt.size
                if (m >= 0 and np.array_equal(ctx[:prompt.size], prompt)
                        and list(ctx[prompt.size:]) == stream[:m]):
                    got = stream[m:][:k]
                    draft[i, :len(got)] = got
                    lens[i] = len(got)
                    break
        return draft, lens


class _PortOracle(_Oracle, tspec.DraftProposer):
    pass


class _JaxOracle(_Oracle, jspec.DraftProposer):
    pass


@pytest.mark.parametrize("mode", ["exact", "bucketed"])
def test_sampled_speculative_streams_equal_jax_and_plain(mode):
    """Sampled speculation with an oracle proposer: the committed
    streams equal the plain sampled run's and the JAX speculative
    engine's, with multi-token accepts, and the spec counters match."""
    kw = dict(n_slots=3, prefill_mode=mode, block_size=4)
    plain, _ = _run(True, _sampled_reqs(True), **kw)
    spec = dict(spec_decode=True, draft_k=4, **kw)
    got, eng = _run(True, _sampled_reqs(True),
                    proposer=_PortOracle(_sampled_reqs(True), plain), **spec)
    want, jeng = _run(False, _sampled_reqs(False),
                      proposer=_JaxOracle(_sampled_reqs(False), plain), **spec)
    assert got == plain == want
    assert eng.stats.spec_steps > 0 and eng.stats.draft_accepted > 0
    assert any(n > 1 for n in eng.stats.spec_step_tokens_hist)
    assert ((eng.stats.draft_proposed, eng.stats.draft_accepted,
             eng.stats.spec_steps)
            == (jeng.stats.draft_proposed, jeng.stats.draft_accepted,
                jeng.stats.spec_steps))
    assert eng.pool.used_blocks == 0


class _LastTokenProposer:
    """Always drafts the context's last token k times, so the fused
    verifier runs on every eligible quantum."""

    def propose(self, contexts, k):
        draft = np.zeros((len(contexts), k), np.int32)
        lens = np.zeros((len(contexts),), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None or np.size(ctx) == 0:
                continue
            draft[i, :] = int(np.asarray(ctx).reshape(-1)[-1])
            lens[i] = k
        return draft, lens


class _PortLast(_LastTokenProposer, tspec.DraftProposer):
    pass


class _JaxLast(_LastTokenProposer, jspec.DraftProposer):
    pass


def test_spec_greedy_rows_bit_identical_through_sampled_verifier():
    """A mixed batch verifies through the SAMPLED verifier; its greedy
    rows keep the plain all-greedy streams, the sampled row its plain
    sampled stream, and both equal the JAX engine's."""
    kw = dict(n_slots=3, prefill_mode="bucketed", block_size=4,
              decode_chunk=1, spec_decode=True, draft_k=4)
    a, eng = _run(True, _greedy_reqs(True, n=4) + [_probe(True)],
                  proposer=_PortLast(), **kw)
    assert eng.stats.spec_steps > 0
    for key, toks in _repro()["base_g"].items():
        if key[0] < 4:
            assert a[key] == toks
    assert a[(100, 0)] == _repro()["alone"][(100, 0)]
    b, _ = _run(False, _greedy_reqs(False, n=4) + [_probe(False)],
                proposer=_JaxLast(), **kw)
    assert a == b


def test_fork_n4_shares_prompt_pages_and_diverges():
    """n=4 prefills ONCE: three children share the 9-token prompt's two
    full pages (fork_shared_tokens), copy the boundary page once each,
    diverge by generation; generation 0 is the n=1 stream, and every
    generation is the JAX engine's."""
    bs = 4
    kw = dict(n_slots=4, prefill_mode="bucketed", block_size=bs)
    solo, _ = _run(True, [_probe(True, n=1)], **kw)
    forked, eng = _run(True, [_probe(True, n=4)], **kw)
    assert sorted(forked) == [(100, g) for g in range(4)]
    assert eng.stats.fork_shared_tokens == 3 * 2 * bs
    assert eng.stats.cow_page_copies == 3
    assert eng.stats.sampled_requests == 4
    assert forked[(100, 0)] == solo[(100, 0)]
    assert len({tuple(t) for t in forked.values()}) == 4
    assert eng.pool.used_blocks == 0
    want, jeng = _run(False, [_probe(False, n=4)], **kw)
    assert forked == want
    assert (jeng.stats.fork_shared_tokens, jeng.stats.cow_page_copies) == (
        eng.stats.fork_shared_tokens, eng.stats.cow_page_copies)


def test_fork_exact_prefill_and_queued_children_equal_jax():
    """Exact prefill, two n=3 requests over 2 slots (children wait for
    slots with their holds taken): the JAX engine's generations."""
    req, samp = _pkg(True)
    jreq, jsp = _pkg(False)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, s).astype(np.int32) for s in (13, 6)]
    mk = lambda R, S: [R(rid=r, prompt=p, max_new_tokens=5,  # noqa: E731
                         params=S.SamplingParams(temperature=1.1, n=3, seed=r))
                       for r, p in enumerate(prompts)]
    kw = dict(n_slots=2, block_size=4)
    got, eng = _run(True, mk(req, samp), **kw)
    want, _ = _run(False, mk(jreq, jsp), **kw)
    assert got == want and len(got) == 6
    assert eng.stats.cow_page_copies == 4 and eng.pool.used_blocks == 0


def test_fork_leak_free_under_cancel_and_drain(monkeypatch):
    """Every shared ref a fork takes comes back on every exit path;
    owner-set debug mode makes a release by a non-holder an error."""
    monkeypatch.setenv("TPUJOB_KV_DEBUG_OWNERS", "1")
    _, cfg_t, _, params_t = _models()
    eng = ServingEngine(cfg_t, params_t, n_slots=3, max_seq=MAX_SEQ,
                        prefill_mode="bucketed", block_size=4, device="cpu")
    assert eng.pool.debug_owners
    rng = np.random.default_rng(3)
    mk = lambda rid, n: Request(  # noqa: E731
        rid=rid, prompt=rng.integers(0, 256, 5 + rid).astype(np.int32),
        max_new_tokens=6,
        params=tsamp.SamplingParams(temperature=0.8, n=n, seed=rid))
    for rid, n in ((1, 4), (2, 3), (3, 1)):
        eng.submit(mk(rid, n))
    out = []
    for _ in range(6):
        out.extend(eng.step())
    assert eng._fork_sources, "the test must cancel with forks pending"
    assert eng.cancel(2)
    assert not eng.cancel(99)
    out.extend(eng.drain(grace_s=30.0))
    by_rid = {}
    for c in out:
        by_rid.setdefault(c.rid, []).append(c.gen)
    assert sorted(by_rid[1]) == [0, 1, 2, 3]
    assert sorted(by_rid[2]) == [0, 1, 2]
    assert by_rid[3] == [0]
    assert eng.pool.used_blocks == 0, "fork refs leaked"
    # A queued request cancels outright; the rid frees at once.
    eng2 = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=MAX_SEQ,
                         block_size=4, device="cpu")
    eng2.submit(mk(4, 2))
    eng2.submit(mk(5, 1))
    assert eng2.cancel(5)
    done = []
    for _ in range(60):
        done.extend(eng2.step())
        if eng2.idle:
            break
    assert sorted((c.rid, c.gen, c.finish_reason) for c in done) == [
        (4, 0, "length"), (4, 1, "length"), (5, 0, "cancelled")]
    assert eng2.pool.used_blocks == 0


# -- constrained decoding ----------------------------------------------------------

def _text(toks, eos, strs):
    return "".join(strs[t] for t in toks if t != eos)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "greedy"])
def test_token_set_mask_confines_output(sampled):
    """A token-set mask beside an unmasked greedy request; without a
    sampled row the masked step takes the masked argmax."""
    cfg = _models()[1]
    eos = cfg.vocab_size - 1
    outs = []
    for port in (True, False):
        req, samp = _pkg(port)
        mask = samp.make_mask("set:3,5,7", cfg.vocab_size, eos_id=eos)
        probe = _probe(port, mask=mask)
        if not sampled:
            probe.params = samp.SamplingParams(logit_mask=mask)
        out, eng = _run(port, [probe,
                               req(rid=0, prompt=np.arange(4, dtype=np.int32),
                                   max_new_tokens=4)],
                        n_slots=2, prefill_mode="bucketed", block_size=4)
        outs.append(out)
        assert set(out[(100, 0)]) <= {3, 5, 7, eos}
        assert eng.stats.mask_tokens_filtered > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("eos_on", [True, False], ids=["eos", "no-eos"])
def test_regex_mask_completes_and_matches(eos_on):
    """A finite regex forces the end: with an EOS id the stream finishes
    "eos" after three digits; without one the grammar's empty support
    retires the slot as a natural finish. Both equal the JAX engine's."""
    cfg = _models()[1]
    eos = cfg.vocab_size - 1 if eos_on else None
    comps = []
    for port in (True, False):
        req, samp = _pkg(port)
        mask = samp.make_mask("re:[0-9][0-9][0-9]", cfg.vocab_size,
                              eos_id=eos)
        r = req(rid=5, prompt=np.random.default_rng(2).integers(
                    0, cfg.vocab_size, 6).astype(np.int32),
                max_new_tokens=10, eos_id=eos,
                params=samp.SamplingParams(temperature=1.0, seed=42,
                                           logit_mask=mask))
        _, cfg_t, params_j, params_t = _models()
        if port:
            eng = ServingEngine(cfg_t, params_t, n_slots=1, max_seq=MAX_SEQ,
                                prefill_mode="bucketed", block_size=4,
                                device="cpu")
        else:
            eng = JEngine(_models()[0], params_j, n_slots=1, max_seq=MAX_SEQ,
                          prefill_mode="bucketed", block_size=4)
        (comp,) = eng.run([r])
        comps.append(comp)
        assert comp.finish_reason == "eos"
        assert eng.pool.used_blocks == 0
    assert comps[0].tokens == comps[1].tokens
    strs = tsamp.default_token_strs(cfg.vocab_size)
    assert re.fullmatch("[0-9][0-9][0-9]", _text(comps[0].tokens, eos, strs))
    assert len(comps[0].tokens) == (4 if eos_on else 3)


def test_json_mask_every_token_admissible_and_eos_streams_parse():
    """The contract of the reference's JSON test on sampled requests
    where it bites: replaying each stream through a fresh automaton hits
    no inadmissible token, and every stream that reaches EOS parses (three
    of the four do; the fourth runs out of budget mid-object). The
    streams equal the JAX engine's."""
    cfg = _models()[1]
    eos = cfg.vocab_size - 1
    strs = tsamp.default_token_strs(cfg.vocab_size)
    outs = []
    for port in (True, False):
        req, samp = _pkg(port)
        mask = samp.make_mask("json", cfg.vocab_size, eos_id=eos)
        reqs = [req(rid=seed, prompt=np.random.default_rng(4).integers(
                        0, cfg.vocab_size, 7).astype(np.int32),
                    max_new_tokens=24, eos_id=eos,
                    params=samp.SamplingParams(temperature=1.0, seed=seed,
                                               logit_mask=mask))
                for seed in (1, 4, 23, 25)]
        out, eng = _run(port, reqs, n_slots=2, prefill_mode="bucketed",
                        block_size=4)
        if port:
            reqs_port = reqs
        outs.append(out)
        assert eng.stats.mask_tokens_filtered > 0
    assert outs[0] == outs[1]
    # Every completion is counted (the JAX engine's constrained step books
    # its completions without recording them: ROADMAP C7).
    assert eng.stats.finished == 0 and len(outs[1]) == 4
    port_stats = _run(True, reqs_port, n_slots=2, prefill_mode="bucketed",
                      block_size=4)[1].stats
    assert port_stats.finished == 4 and port_stats.tokens_out == sum(
        len(t) for t in outs[0].values())
    assert port_stats.summary()["tpot_p50_ms"] > 0
    parsed = 0
    for toks in outs[0].values():
        replay = tsamp.make_mask("json", cfg.vocab_size, eos_id=eos)
        st = replay.init_state()
        for t in toks:
            if t == eos:
                assert replay.is_complete(st)
                json.loads(_text(toks, eos, strs).strip())
                parsed += 1
                break
            assert replay.allowed(st)[t], f"token {t} escaped the mask"
            st = replay.advance(st, t)
    assert parsed == 3


def test_masked_and_sampled_traffic_mix_equals_jax():
    """A regex-masked request, a sampled one and greedy ones share the
    slots (masked quanta carry the unmasked rows one token at a time):
    the JAX engine's streams, and the unmasked rows' streams are their
    plain ones."""
    cfg = _models()[1]
    outs = []
    for port in (True, False):
        req, samp = _pkg(port)
        mask = samp.make_mask("re:[a-z]+", cfg.vocab_size)
        reqs = _greedy_reqs(port, n=3) + [
            _probe(port, rid=200, mask=mask), _probe(port)]
        out, _ = _run(port, reqs, n_slots=3, decode_chunk=2)
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0][(100, 0)] == _repro()["alone"][(100, 0)]
    strs = tsamp.default_token_strs(cfg.vocab_size)
    assert re.fullmatch("[a-z]+", _text(outs[0][(200, 0)], -1, strs))


# -- serve() and its command line ------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
    dict(temperature=0.7, n=3, seed=2, prefill_mode="bucketed"),
    dict(temperature=1.0, grammar="re:[0-9]+", seed=1),
    dict(grammar="set:3,5,7", n=2, temperature=0.5)],
    ids=["sampled", "n3", "regex", "set-n2"])
def test_serve_writes_the_jax_serve_completions(kw, tmp_path, monkeypatch):
    """serve() with the sampling flags on the CPU writes the completions
    file the JAX serve() writes with the same arguments, on the JAX
    entry point's weights (its fresh init, carried across)."""
    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import (
        serve_lm as tserve,
    )
    cfg_j = jtfm.tiny_config()
    params_t = params_from_numpy(jax.device_get(
        jtfm.init_params(cfg_j, jax.random.key(0))), device="cpu")
    monkeypatch.setattr(tserve, "_load_params",
                        lambda *a, **k: (params_t, None))
    common = dict(config="tiny", batch=3, prompt_len=7, max_new_tokens=6,
                  slots=2, block_size=4, eos_id=255, **kw)
    files = []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", tserve.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        res = serve(output_file=str(out), **common, **extra)
        files.append([json.loads(line) for line in out.read_text().splitlines()])
    assert files[0] == files[1]
    assert len(files[1]) == 3 * kw.get("n", 1)
    assert res["sampled_requests"] == (3 * kw.get("n", 1)
                                       if kw.get("temperature") else 0)


def test_serve_and_cli_validate_the_sampling_flags_as_jax(tmp_path):
    """The reference's checks, in serve() (ValueError) and on the command
    line (usage and exit 2): bad knobs, n > 1 without the paged pool,
    n or grammar with turns > 1, a malformed grammar; multi-turn itself
    stays refused ("not yet ported")."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import (
        serve_lm as tserve,
    )
    base = dict(config="tiny", batch=1, prompt_len=5, max_new_tokens=2,
                block_size=4, device="cpu")
    for kw, msg in ((dict(temperature=-1.0), "temperature"),
                    (dict(top_p=1.5), "top_p"), (dict(n=0), "n must"),
                    (dict(n=2, paged=False), "paged"),
                    (dict(n=2, turns=2), "single-turn"),
                    (dict(grammar="re:[0-9]", turns=2), "single-turn"),
                    (dict(grammar="bogus"), "unknown grammar")):
        with pytest.raises(ValueError, match=msg):
            tserve.serve(**base, **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.serve(**base, turns=2)
    argv = ["--config", "tiny", "--device", "cpu", "--batch", "1",
            "--prompt-len", "5", "--max-new-tokens", "2", "--block-size", "4",
            "--output", str(tmp_path / "o.jsonl")]
    for flag in (["--temperature", "-1"], ["--top-k", "-2"],
                 ["--n", "2", "--no-paged"], ["--n", "2", "--turns", "2"],
                 ["--grammar", "json", "--turns", "3"],
                 ["--grammar", "re:(ab"]):
        with pytest.raises(SystemExit) as e:
            tserve.main(argv + flag)
        assert e.value.code == 2, flag
    assert tserve.main(argv + ["--n", "2", "--grammar", "json",
                               "--temperature", "0.9"]) == 0
    rows = [json.loads(line)
            for line in (tmp_path / "o.jsonl").read_text().splitlines()]
    assert [(r["rid"], r["gen"]) for r in rows] == [(0, 0), (0, 1)]
