"""Closed loop: ``clients`` callers, each sending its next request the
moment its last one is answered (an offline batch job's workers). The
loop runs through set-up until it is steady, then the window counts the
tokens served in it; the requests sent in the window are drained after
it and a sample of them checked against the reference."""

from __future__ import annotations

from typing import Dict, List

from gpubench.harness import serving as sv
from gpubench.harness import traffic as tr
from gpubench.harness.context import Ctx, Outcome
from gpubench.harness.profiling import Slice, span
from gpubench.harness.recorder import Recorder
from gpubench.harness.records import Records

clock = sv.clock

#: Seconds the loop runs before the window opens, so that the clients'
#: requests are staggered as in a steady state (counted in set-up).
LEAD_IN_S = 5.0


def run(ctx: Ctx) -> Outcome:
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request

    tcfg = sv.port_config(ctx)
    vocab = ctx.port["vocab_size"]
    params = sv.program_weights(ctx, tcfg)
    eng = sv.make_engine(ctx, tcfg, params)
    sv.warm_up(ctx, eng, vocab)
    rec = Recorder()
    if ctx.trace:
        rec.install()
        Slice.warm()
    stream = tr.closed_loop(ctx.cell.traffic, ctx.seed, vocab)
    clients = int(ctx.cell.workload["load"]["clients"])
    traced = ctx.trace
    sl = Slice()
    ts = min(float(ctx.cell.workload.get("trace_slice_s", 5)), ctx.seconds)
    s_from = ctx.seconds - ts
    comps: Dict = {}
    sent: List[tr.Req] = []
    in_window: List[tr.Req] = []
    due: Dict[int, float] = {}
    state = {"open": False, "closed": False}

    def send() -> None:
        q = next(stream)
        with span("submit", traced):
            eng.submit(Request(rid=q.rid, prompt=q.prompt, max_new_tokens=q.max_new))
        due[q.rid] = clock()
        sent.append(q)
        if state["open"]:
            in_window.append(q)

    def step() -> None:
        with span("engine.step", traced):
            done = eng.step()
        for c in done:
            comps[c.rid] = c
            if not state["closed"]:
                send()

    try:
        for _ in range(clients):
            send()
        lead_end = clock() + LEAD_IN_S
        while clock() < lead_end:
            step()
        sv.settle()
        setup_s = clock() - ctx.t_start
        before = sv.serving_counters(eng)
        state["open"] = True
        t0 = clock()
        end = t0 + ctx.seconds
        while clock() < end:
            now = clock()
            if traced and not sl.stopped and sl.prof is None and now >= t0 + s_from:
                sl.start()
                rec.on = True
            step()
        elapsed = clock() - t0
        counters = sv.serving_counters(eng, before)
        state["open"], state["closed"] = False, True
        if sl.active:
            rec.on = False
            sl.stop()
        want = {q.rid for q in sent}
        end_drain = clock() + float(ctx.cell.workload.get("drain_limit_s", 60))
        while not want <= set(comps) and clock() < end_drain and not eng.idle:
            step()
        gave_up = clock()
        peak = sv.memory_peak()
    finally:
        rec.uninstall()
    rows, _ = sv.books(in_window, due, comps, gave_up, t0)
    # A caller whose request is never answered stops sending: every
    # request sent, in the lead-in too, has to come back in full.
    _, failed = sv.books(sent, due, comps, gave_up, t0)
    e2e = {"serve_tokens_per_s": counters["tokens_out"] / elapsed}
    records = Records(
        cell=ctx.cell.name, port=ctx.port, peaks={}, window_s=elapsed,
        trace=sl.finish(), requests=rows,
        serving={"slot_occupancy": counters["active_slot_steps"]
                 / max(1, counters["steps"] * eng.n_slots),
                 "clean_until_s": s_from if traced else elapsed},
        decode_contexts=rec.decode_contexts(), prefills=list(rec.prefill),
        chunks=list(rec.chunks))
    del eng, params
    sv.free()
    t_ref = clock()
    checks, program = sv.check_served(ctx, in_window, comps)
    extra = {"clients": clients, "requests": len(in_window),
             "reference_s": clock() - t_ref}
    if program:
        extra["program_check_readings"] = program
    return Outcome(e2e=e2e, records=records, attempted=len(sent),
                   failed=failed, checks=checks, memory_peak_bytes=peak,
                   extra=extra, setup_s=setup_s)
