"""The port's QueryServer against the JAX package's, on the CPU.

Each scenario runs the same seeded traffic, with the same fault script
(``FaultInjector.script`` or a seeded ``FaultInjector.random``) and a
``FakeClock``, through both packages' servers over twin indexes built from
the same numpy parts.  Ticket statuses, values (bitmaps by container kinds
and values, similarity lists with float32 scores as bits), telemetry,
``ServerStats`` and the clock's sleeps must be equal: the tolerance is 0.
The port's results must also equal its own single-query calls.  These are
the scenarios of ``tests/serve/test_query_server.py`` and
``tests/serve/test_faults.py`` and the arena revalidation of
``tests/core/test_arena.py`` that need no mesh.
"""

import dataclasses

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.core import BitmapArena as JArena
from repro.core import aggregate as jagg
from repro.data.index import InvertedIndex as JIndex
from repro_torch import convert
from repro_torch.core import BitmapArena
from repro_torch.core import aggregate as tagg
from repro_torch.serve.faults import SITES, AllocPressure, DispatchFault

VOCAB = [f"t{i}" for i in range(40)]
METRICS = ("jaccard", "cosine", "containment")


def _twins(seed=42, n_docs=1500, arena=False):
    rng = np.random.default_rng(seed)
    docs = [[VOCAB[j] for j in rng.choice(len(VOCAB),
                                          size=int(rng.integers(3, 10)),
                                          replace=False)]
            for _ in range(n_docs)]
    jx = JIndex().build(docs)
    parts = {t: convert.bitmap_to_parts(b) for t, b in jx.postings.items()}
    jx = JIndex.from_postings(jx.postings, jx.n_docs,
                              arena=JArena() if arena else None)
    tx = convert.index_from_parts(
        parts, jx.n_docs, arena=BitmapArena(device="cpu") if arena else None,
        device=None if arena else "cpu")
    return jx, tx


@pytest.fixture(scope="module")
def twins():
    return _twins()


def _query(serve, spec):
    kind, terms = spec[0], tuple(spec[1])
    if kind == "threshold":
        return serve.Query.threshold(terms, spec[2], spec[3])
    if kind == "similar":
        return serve.Query.similar(terms[0], k=spec[2], metric=spec[3])
    return serve.Query(kind, terms, *spec[2:])


def mixed(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ["and", "or", "xor", "andnot", "threshold",
                "similar"][int(rng.integers(6))]
        terms = [VOCAB[j] for j in rng.choice(
            len(VOCAB), size=int(rng.integers(2, 6)), replace=False)]
        if kind == "threshold":
            w = None if i % 2 else [int(x) for x in
                                    rng.integers(1, 4, len(terms))]
            out.append(("threshold", terms,
                        int(rng.integers(1, len(terms) + 1)), w))
        elif kind == "similar":
            out.append(("similar", terms[:1], int(rng.integers(1, 8)),
                        METRICS[i % 3]))
        else:
            out.append((kind, terms))
    return out


def _norm(v):
    if v is None:
        return None
    if hasattr(v, "to_array"):
        return (tuple(int(k) for k in v.keys),
                tuple(c.kind for c in v.containers), v.to_array().tobytes())
    return [(t, int(np.float32(s).view(np.int32))) for t, s in v]


def _serve(serve, index, specs, *, script=None, faults=None,
           deadlines=None, advance=0.0, ticks=None, **kw):
    clock = serve.FakeClock()
    srv = serve.QueryServer(
        index, backend="ref", clock=clock,
        faults=faults if faults is not None
        else serve.FaultInjector.script(script or {}), **kw)
    tickets = [srv.submit(_query(serve, s),
                          deadline_s=None if deadlines is None
                          else deadlines[i])
               for i, s in enumerate(specs)]
    clock.advance(advance)
    if ticks is None:
        srv.run_until_idle()
    else:
        for _ in range(ticks):
            srv.step()
    return srv, clock, tickets


def _outcome(srv, clock, tickets):
    return dict(
        status=[t.result.status if t.done else None for t in tickets],
        value=[_norm(t.result.value) if t.done else None for t in tickets],
        error=[bool(t.result.error) if t.done else None for t in tickets],
        telemetry=[dataclasses.astuple(t.telemetry) for t in tickets],
        stats=srv.stats().as_dict(), sleeps=list(clock.sleeps))


def both(twins, specs, **kw):
    """Serve ``specs`` through both packages; require equal outcomes and
    return the port's (server, clock, tickets)."""
    jx, tx = twins
    jkw = dict(kw)
    if "faults" in kw:                      # a factory: one injector each
        jkw["faults"] = kw["faults"](jserve)
        kw = dict(kw, faults=kw["faults"](tserve))
    want = _outcome(*_serve(jserve, jx, specs, **jkw))
    port = _serve(tserve, tx, specs, **kw)
    got = _outcome(*port)
    for key in want:
        assert got[key] == want[key], key
    return port


def direct(ix, spec):
    kind, terms = spec[0], spec[1]
    if kind == "and":
        return ix.query_and(*terms)
    if kind == "or":
        return ix.query_or(*terms)
    if kind == "xor":
        return ix.query_xor(*terms)
    if kind == "andnot":
        return ix.query_andnot(terms[0], *terms[1:])
    if kind == "threshold":
        return ix.query_threshold(list(terms), spec[2], weights=spec[3])
    return ix.similar(terms[0], spec[2], spec[3])


def _matches_direct(twins, tickets, specs):
    for t, s in zip(tickets, specs):
        assert t.result.status == tserve.OK
        assert _norm(t.result.value) == _norm(direct(twins[1], s)), s


# ------------------------------------------------------------ serving
def test_coalesced_batch_bit_identical(twins):
    specs = mixed(24, seed=1)
    srv, _, tickets = both(twins, specs, ticks=1)
    st = srv.stats()
    assert st.batches == 1 and st.max_batch == len(specs)
    _matches_direct(twins, tickets, specs)
    assert all(t.telemetry.batch_size == 24 and not t.telemetry.degraded
               for t in tickets)


def test_single_query_tick(twins):
    srv, _, (t,) = both(twins, [("and", ["t1", "t2", "t3"])])
    _matches_direct(twins, [t], [("and", ["t1", "t2", "t3"])])


def test_unknown_terms_resolve_empty(twins):
    specs = [("or", ["nope", "also-nope"]), ("similar", ["nope"], 3,
                                              "jaccard")]
    _, _, tickets = both(twins, specs)
    assert tickets[0].result.value.cardinality == 0
    _matches_direct(twins, tickets, specs)


def test_invalid_queries_rejected_at_admission(twins):
    specs = [("threshold", ["t1"], 0, None),
             ("threshold", ["t1", "t2"], 1, [1]),
             ("nonsense", ["t1"]), ("similar", ["t1"], 3, "not-a-metric")]
    srv, _, tickets = both(twins, specs)
    assert all(t.result.status == tserve.INVALID and t.result.error
               for t in tickets)
    assert srv.pending == 0 and srv.stats().rejected_invalid == 4


def test_overload_shedding_is_structured(twins):
    srv, _, tickets = both(twins, [("or", ["t1"])] * 6, max_queue=3)
    assert [t.result.status for t in tickets] == \
        [tserve.OK] * 3 + [tserve.OVERLOADED] * 3
    assert srv.stats().rejected_overloaded == 3


def test_deadline_at_admission_and_in_queue(twins):
    specs = [("or", ["t1"]), ("or", ["t1"]), ("or", ["t2"])]
    srv, _, tickets = both(twins, specs, deadlines=[-0.5, 1.0, 50.0],
                           advance=2.0)
    assert [t.result.status for t in tickets] == \
        [tserve.DEADLINE, tserve.DEADLINE, tserve.OK]
    assert srv.stats().deadline_expired == 2


def test_max_batch_splits_ticks(twins):
    specs = mixed(10, seed=2)
    srv, _, tickets = both(twins, specs, max_batch=4)
    st = srv.stats()
    assert st.batches == 3 and st.max_batch == 4
    _matches_direct(twins, tickets, specs)


def test_max_bytes_policy_admits_at_least_one():
    """Dense postings (> 4096 docs) are bitset containers, so each OR plan
    carries one 2-row segment = 16 KiB of the batch budget."""
    jx = JIndex().build([["a", "b"]] * 5000)
    parts = {t: convert.bitmap_to_parts(b) for t, b in jx.postings.items()}
    tx = convert.index_from_parts(parts, jx.n_docs, device="cpu")
    srv, _, tickets = both((jx, tx), [("or", ["a", "b"])] * 3,
                           max_batch_bytes=16384)
    assert tickets[0]._plan.slab_bytes() == 16384
    assert srv.stats().batches == 3
    assert all(t.result.value.cardinality == 5000 for t in tickets)


def test_telemetry_uses_the_injected_clock(twins):
    _, tx = twins
    clock = tserve.FakeClock(start=100.0)
    srv = tserve.QueryServer(tx, backend="ref", clock=clock)
    t = srv.submit(tserve.Query.or_("t1"))
    clock.advance(3.0)
    srv.step()
    assert t.telemetry.submitted_at == 100.0
    assert t.telemetry.dispatched_at == 103.0
    assert t.telemetry.queue_time == pytest.approx(3.0)
    assert t.telemetry.latency >= 3.0
    snap = srv.stats()
    srv.submit(tserve.Query.or_("t2"))
    assert snap.submitted == 1 and srv.stats().submitted == 2


def test_similarity_groups_by_k_and_metric(twins):
    specs = [("similar", ["t1"], 3, "jaccard"),
             ("similar", ["t2"], 3, "jaccard"),
             ("similar", ["t3"], 7, "cosine"),
             ("similar", ["t4"], 3, "containment")]
    _, _, tickets = both(twins, specs, ticks=1)
    _matches_direct(twins, tickets, specs)


# ----------------------------------------------------- fault harness
def test_injector_scripted_always_and_unknown_site():
    inj = tserve.FaultInjector.script({"dispatch_raise": [True, False,
                                                          True]})
    assert [inj.fire("dispatch_raise") for _ in range(5)] == \
        [True, False, True, False, False]
    assert inj.fired == ["dispatch_raise", "dispatch_raise"]
    inj = tserve.FaultInjector.script({"alloc_pressure": "always"})
    assert all(inj.fire("alloc_pressure") for _ in range(10))
    assert not inj.fire("dispatch_raise")
    with pytest.raises(ValueError, match="unknown fault site"):
        tserve.FaultInjector.script({"not-a-site": [True]})
    assert SITES == jserve.faults.SITES


def test_injector_seeded_random_matches_jax():
    a = tserve.FaultInjector.random(123, {"dispatch_raise": 0.5})
    b = jserve.FaultInjector.random(123, {"dispatch_raise": 0.5})
    seq = [bool(a.fire("dispatch_raise")) for _ in range(50)]
    assert seq == [bool(b.fire("dispatch_raise")) for _ in range(50)]
    assert any(seq) and not all(seq)
    clk = tserve.FakeClock(start=5.0)
    clk.sleep(1.5)
    clk.sleep(0.25)
    assert clk.now() == 6.75 and clk.sleeps == [1.5, 0.25]
    assert issubclass(DispatchFault, tserve.FaultError)
    assert issubclass(AllocPressure, tserve.FaultError)


def test_fail_once_then_succeed_retries_on_kernel(twins):
    srv, clock, (t,) = both(twins, [("and", ["t1", "t2"])],
                            script={"dispatch_raise": [True]})
    assert t.telemetry.retries == 1 and not t.telemetry.degraded
    assert srv.stats().dispatch_retries == 1
    assert srv.stats().host_fallbacks == 0
    assert clock.sleeps == [srv.backoff_s]


def test_backoff_is_exponential(twins):
    srv, clock, (t,) = both(twins, [("or", ["t1"])],
                            script={"dispatch_raise": [True, True]},
                            max_retries=3)
    assert t.result.status == tserve.OK and t.telemetry.retries == 2
    assert clock.sleeps == [srv.backoff_s, 2 * srv.backoff_s]


def test_fail_always_degrades_to_host_bit_identical(twins):
    specs = [("and", ["t1", "t2"]), ("or", ["t3", "t4", "t5"]),
             ("xor", ["t6", "t7"]), ("andnot", ["t1", "t8"]),
             ("threshold", ["t1", "t2", "t3"], 2, None),
             ("threshold", ["t1", "t2", "t3"], 3, [1, 2, 3]),
             ("similar", ["t2"], 5, "jaccard"),
             ("similar", ["t3"], 4, "cosine")]
    srv, _, tickets = both(twins, specs, script={"dispatch_raise":
                                                 "always"})
    _matches_direct(twins, tickets, specs)
    assert all(t.telemetry.degraded and
               t.telemetry.retries == srv.max_retries for t in tickets)
    st = srv.stats()
    assert st.host_fallbacks == 1 and st.resolved_ok == len(specs)


def test_hang_overruns_deadline_structured(twins):
    srv, _, (doomed, patient) = both(
        twins, [("or", ["t1"]), ("or", ["t2"])],
        script={"dispatch_hang": [10.0]}, deadlines=[2.0, None])
    assert doomed.result.status == tserve.DEADLINE
    assert "overrun" in doomed.result.error
    assert patient.result.status == tserve.OK


def test_hang_without_deadline_just_slows(twins):
    _, _, (t,) = both(twins, [("or", ["t1"])],
                      script={"dispatch_hang": [60.0]})
    assert t.result.status == tserve.OK and t.telemetry.latency >= 60.0


def test_alloc_pressure_splits_then_degrades(twins):
    specs = [("or", [v]) for v in VOCAB[:8]]
    srv, _, tickets = both(twins, specs, script={"alloc_pressure": [True]})
    assert srv.stats().batch_splits == 1
    assert srv.stats().host_fallbacks == 0
    assert all(t.telemetry.splits == 1 for t in tickets)
    srv, _, tickets = both(twins, specs[:4],
                           script={"alloc_pressure": "always"})
    assert srv.stats().host_fallbacks == 4
    assert all(t.telemetry.degraded for t in tickets)
    _matches_direct(twins, tickets, specs[:4])


def test_slab_mismatch_replans_and_succeeds(twins):
    specs = [("and", ["t1", "t2"]), ("similar", ["t1"], 3, "jaccard")]
    srv, _, tickets = both(twins, specs, script={"slab_mismatch": [True]})
    _matches_direct(twins, tickets, specs)
    assert srv.stats().replans == 1
    assert all(t.telemetry.replans == 1 for t in tickets)


def test_zero_lost_tickets_under_random_fault_storm(twins):
    """Seeded random faults at every site, mixed traffic, deadlines on
    half the tickets: every ticket resolves, with a value equal to the
    single-query call or a structured status -- the same ones in both
    packages."""
    rng = np.random.default_rng(99)
    specs, deadlines = [], []
    for _ in range(60):
        if rng.random() < 0.3:
            specs.append(("similar", [VOCAB[int(rng.integers(40))]],
                          int(rng.integers(1, 6)), "jaccard"))
        else:
            specs.append((["and", "or", "xor"][int(rng.integers(3))],
                          [VOCAB[j] for j in rng.choice(40, 3,
                                                        replace=False)]))
        deadlines.append(float(rng.uniform(0.1, 3.0))
                         if rng.random() < 0.5 else None)
    srv, _, tickets = both(
        twins, specs, deadlines=deadlines, max_batch=8, max_retries=1,
        max_queue=64, faults=lambda serve: serve.FaultInjector.random(
            4242, {s: 0.3 for s in SITES}, hang_s=0.5))
    assert all(t.done for t in tickets)
    assert srv.stats().resolved_error == 0
    ok = [(t, s) for t, s in zip(tickets, specs)
          if t.result.status == tserve.OK]
    assert ok and srv.stats().host_fallbacks > 0
    _matches_direct(twins, *zip(*ok))


def test_step_never_raises_on_an_unexpected_error(twins, monkeypatch):
    """An exception that is not an injected fault resolves the ticket
    ``ERROR`` with its text.  Unlike the JAX package, the port neither
    retries it nor reroutes it to the host planner (a kernel that fails
    must not be hidden), so only the port's server runs here."""
    host = []
    def boom(*a, **k):
        raise RuntimeError("real bug")
    monkeypatch.setattr(tagg, "execute_plans", boom)
    monkeypatch.setattr(tagg, "execute_plan_host",
                        lambda *a, **k: host.append(a))
    srv, _, (t,) = _serve(tserve, twins[1], [("or", ["t1"])],
                          max_retries=0)
    assert t.result.status == tserve.ERROR
    assert "real bug" in t.result.error
    assert srv.stats().resolved_error == 1
    assert srv.stats().host_fallbacks == 0 and host == []


@pytest.mark.parametrize("kind", ["boolean", "similar"])
def test_kernel_failure_is_not_served_from_the_host(twins, monkeypatch,
                                                    kind):
    """A kernel wrapper that raises (a failed build, launch or trap)
    resolves the whole batch ``ERROR``: no retry, no host fallback,
    nothing flagged degraded, and the host routes are never called."""
    from repro_torch.core.pairwise import SimilarityEngine
    from repro_torch.kernels import ops as tops
    host = []
    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")
    target = ((tagg, "execute_plans") if kind == "boolean"
              else (tops, "similarity_topk"))
    monkeypatch.setattr(*target, boom)
    monkeypatch.setattr(tagg, "execute_plan_host",
                        lambda *a, **k: host.append(a))
    monkeypatch.setattr(SimilarityEngine, "_topk_host",
                        lambda *a, **k: host.append(a))
    specs = [("and", ["t1", "t2"]), ("similar", ["t2"], 5, "jaccard"),
             ("or", ["t3", "t4"]), ("similar", ["t5"], 3, "cosine")]
    srv, clock, tickets = _serve(tserve, twins[1], specs)
    assert [t.result.status for t in tickets] == [tserve.ERROR] * 4
    assert all("kernel launch failed" in t.result.error and
               t.result.value is None and not t.telemetry.degraded and
               t.telemetry.retries == 0 for t in tickets)
    st = srv.stats()
    assert st.host_fallbacks == 0 and st.dispatch_retries == 0
    assert st.resolved_error == 4 and host == [] and clock.sleeps == []


def test_device_out_of_memory_splits_the_batch(twins, monkeypatch):
    """The card's out-of-memory error takes the allocator-pressure rung:
    the batch halves and each half runs on the kernel route."""
    import torch
    real = tagg.execute_plans
    calls = []
    def oom_once(*a, **k):
        calls.append(len(a[0]))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **k)
    monkeypatch.setattr(tagg, "execute_plans", oom_once)
    specs = [("or", [v]) for v in VOCAB[:8]]
    srv, _, tickets = _serve(tserve, twins[1], specs)
    assert calls == [8, 4, 4]
    st = srv.stats()
    assert st.batch_splits == 1 and st.host_fallbacks == 0
    assert all(t.telemetry.splits == 1 and not t.telemetry.degraded
               for t in tickets)
    _matches_direct(twins, tickets, specs)


# ----------------------------------------------- arena revalidation
def test_slab_mismatch_repatches_only_edited_rows():
    """With an arena the replan rung revalidates generations: the rows of
    a concurrent edit repatch, the similarity engine refreshes in place,
    and every answer equals a fault-free server's on a cold index."""
    jx, tx = _twins(11, 4000, arena=True)
    _, cold = _twins(11, 4000)
    specs = [("and", ["t1", "t2"]), ("or", ["t3", "t4", "t5"]),
             ("threshold", ["t1", "t2", "t3"], 2, None),
             ("similar", ["t2"], 5, "jaccard")]
    outs = []
    for serve, ix in ((jserve, jx), (tserve, tx)):
        clock = serve.FakeClock()
        srv = serve.QueryServer(ix, backend="ref", clock=clock,
                                faults=serve.FaultInjector.script(
                                    {"slab_mismatch": [True]}))
        assert srv.arena is ix.arena
        tickets = [srv.submit(_query(serve, s)) for s in specs]
        eng = ix._sim_engine()[1]
        ix.postings["t1"].add(4999)             # edit between admission
        srv.run_until_idle()                    # ... and dispatch
        assert ix._sim_engine()[1] is eng       # never dropped
        outs.append(_outcome(srv, clock, tickets))
    assert outs[0] == outs[1]
    st = outs[1]["stats"]
    assert st["replans"] == 1 and st["host_fallbacks"] == 0
    assert st["rows_repatched"] == 1            # the one edited container
    cold.postings["t1"].add(4999)
    srv, _, want = _serve(tserve, cold, specs)
    assert outs[1]["value"] == [_norm(t.result.value) for t in want]


def test_slab_mismatch_without_arena_drops_the_engine(twins):
    _, tx = _twins(12)
    srv = tserve.QueryServer(tx, backend="ref", clock=tserve.FakeClock(),
                             faults=tserve.FaultInjector.script(
                                 {"slab_mismatch": [True]}))
    t = srv.submit(tserve.Query.similar("t1", 3))
    before = tx._sim_engine()[1]
    srv.run_until_idle()
    assert t.result.ok and tx._sim[2] is not before
    assert srv.stats().replans == 1 and srv.stats().rows_repatched == 0
