"""Open loop: requests arrive on the traffic's schedule whatever the
engine does (independent users), each timed from the instant it was
due. The window drives ``ServingEngine.submit`` and
``ServingEngine.step``; after it closes, the requests due in it are
drained (no new arrivals) and a sample of them checked against the
reference."""

from __future__ import annotations

import time
from typing import Dict, List

from gpubench.harness import serving as sv
from gpubench.harness import traffic as tr
from gpubench.harness.context import Ctx, Outcome
from gpubench.harness.profiling import Slice, span
from gpubench.harness.recorder import Recorder
from gpubench.harness.records import Records, p90

clock = sv.clock


def window(ctx: Ctx, eng, reqs: List[tr.Req], rec=None) -> Dict:
    """Offer ``reqs`` on their schedule for ``ctx.seconds``; a traced run
    profiles the window's last ``trace_slice_s`` seconds (the profiler
    stops, which takes seconds, once the window has closed). Returns the window's
    start, its length, the tokens booked in it, the completions so far,
    each request's due instant and how late the loop submitted it, and
    the engine's counters over the window."""
    traced = ctx.trace
    sl = Slice()
    ts = min(float(ctx.cell.workload.get("trace_slice_s", 5)), ctx.seconds)
    s_from = ctx.seconds - ts
    before = sv.serving_counters(eng)
    comps: Dict = {}
    late: List[float] = []
    t0 = clock()
    end = t0 + ctx.seconds
    due = {q.rid: t0 + q.due_s for q in reqs}
    i, n = 0, len(reqs)
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request

    while True:
        now = clock()
        if now >= end:
            break
        if traced and not sl.stopped and sl.prof is None and now >= t0 + s_from:
            sl.start()
            rec.on = True
        while i < n and due[reqs[i].rid] <= now:
            q = reqs[i]
            with span("submit", traced):
                eng.submit(Request(rid=q.rid, prompt=q.prompt, max_new_tokens=q.max_new))
            late.append(clock() - due[q.rid])
            i += 1
        if eng.idle:
            nxt = due[reqs[i].rid] if i < n else end
            with span("idle.wait", traced):
                time.sleep(max(0.0, min(nxt, end) - clock()))
            continue
        with span("engine.step", traced):
            for c in eng.step():
                comps[c.rid] = c
    elapsed = clock() - t0
    counters = sv.serving_counters(eng, before)
    queued = len(eng.queue) + (n - i)
    if sl.active:
        rec.on = False
        sl.stop()
    for q in reqs[i:]:                      # due in the window, not yet sent
        eng.submit(Request(rid=q.rid, prompt=q.prompt, max_new_tokens=q.max_new))
        late.append(clock() - due[q.rid])
    return {"t0": t0, "elapsed": elapsed, "tokens": counters["tokens_out"],
            "comps": comps, "due": due, "late": late, "counters": counters,
            "queued_at_close": queued, "slice": sl,
            "clean_until_s": s_from if traced else elapsed}


def run(ctx: Ctx, rate: float = 0.0, check: bool = True) -> Outcome:
    tcfg = sv.port_config(ctx)
    vocab = ctx.port["vocab_size"]
    params = sv.program_weights(ctx, tcfg)
    eng = sv.make_engine(ctx, tcfg, params)
    sv.warm_up(ctx, eng, vocab)
    rec = Recorder()
    if ctx.trace:
        rec.install()
        Slice.warm()
    rate = rate or ctx.cell.workload["load"]["rate_per_s"]
    reqs = tr.open_loop(ctx.cell.traffic, rate, ctx.seconds, ctx.seed, vocab)
    sv.settle()
    setup_s = clock() - ctx.t_start
    try:
        w = window(ctx, eng, reqs, rec)
        comps = w["comps"]
        gave_up = sv.drain(ctx, eng, comps, len(reqs),
                           float(ctx.cell.workload.get("drain_limit_s", 60)))
        peak = sv.memory_peak()
    finally:
        rec.uninstall()
    rows, failed = sv.books(reqs, w["due"], comps, gave_up, w["t0"])
    e2e = {"serve_tokens_per_s": w["tokens"] / w["elapsed"], **sv.tails(rows)}
    c = w["counters"]
    records = Records(
        cell=ctx.cell.name, port=ctx.port, peaks={}, window_s=w["elapsed"],
        trace=w["slice"].finish(), requests=rows,
        serving={"slot_occupancy": c["active_slot_steps"]
                 / max(1, c["steps"] * eng.n_slots),
                 "prefix_hit_rate": c["prefix_hit_tokens"]
                 / max(1, c["prefix_lookup_tokens"]),
                 "clean_until_s": w["clean_until_s"]},
        decode_contexts=rec.decode_contexts(), prefills=list(rec.prefill),
        chunks=list(rec.chunks))
    del eng, params
    sv.free()
    t_ref = clock()
    checks, program = sv.check_served(ctx, reqs, comps) if check else ({}, {})
    extra = {"reference_s": clock() - t_ref, **sv.medians(rows),
             "ttft_p90_ms": e2e["ttft_p90_ms"],
             "generator_late_p90_ms": (p90(w["late"]) or 0.0) * 1e3,
             "queued_at_close": w["queued_at_close"], "rate_per_s": rate,
             "requests": len(reqs)}
    if program:
        extra["program_check_readings"] = program
    return Outcome(e2e=e2e, records=records, attempted=len(reqs), failed=failed,
                   checks=checks, memory_peak_bytes=peak, extra=extra,
                   setup_s=setup_s)
