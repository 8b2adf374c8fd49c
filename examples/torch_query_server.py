"""Continuous query serving on the PyTorch/CUDA port: a warm
``QueryServer`` coalescing a mixed boolean + similarity workload into
per-op-class slab launches, with admission control, deadlines, and
fault-injected degradation to the bit-identical host planner.

    PYTHONPATH=src python examples/torch_query_server.py            # the card
    PYTHONPATH=src python examples/torch_query_server.py --device cpu

The same walk-through as ``examples/query_server.py``, through
``repro_torch``.  The servers take the route of the index's device: the
CUDA kernels on the card, their plain PyTorch versions on the CPU (the JAX
example serves ``backend="ref"``, its jnp oracle, since Pallas kernels only
interpret on a CPU).  Every route gives the same bits.
"""

import argparse

import numpy as np

from repro_torch.data.index import InvertedIndex
from repro_torch.serve import OK, FaultInjector, Query, QueryServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--docs", type=int, default=5_000)
    ap.add_argument("--terms", type=int, default=48)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(3)
    n_terms = args.terms
    vocab = [f"t{i}" for i in range(n_terms)]
    docs = [[vocab[j] for j in
             rng.choice(n_terms, size=int(rng.integers(3, 12)),
                        replace=False)]
            for _ in range(args.docs)]
    ix = InvertedIndex(device=args.device).build(docs)
    print(f"indexed {ix.n_docs} docs / {len(ix.postings)} terms")

    # -- a healthy tick: 32 mixed queries coalesce into one batch -------
    srv = QueryServer(ix)
    queries = []
    for i in range(32):
        kind = ("and", "or", "xor", "threshold")[i % 4]
        terms = tuple(vocab[j] for j in rng.choice(n_terms, 3,
                                                   replace=False))
        if i % 8 == 7:
            queries.append(Query.similar(terms[0], k=5))
        elif kind == "threshold":
            queries.append(Query.threshold(terms, 2))
        else:
            queries.append(Query(kind, terms))
    tickets = [srv.submit(q) for q in queries]
    srv.run_until_idle()
    st = srv.stats()
    assert all(t.result.status == OK for t in tickets)
    lat = max(t.telemetry.latency for t in tickets)
    print(f"served {st.resolved_ok} queries in {st.batches} batch(es), "
          f"max latency {lat * 1e3:.1f} ms")

    # the coalesced results are bit-identical to direct execution
    probe = tickets[1]
    assert probe.result.value == ix.query_or(*probe.query.terms)
    print("spot check vs direct execution: identical")

    # -- admission control: queries past their deadline never dispatch --
    tight = QueryServer(ix, max_queue=4)
    late = tight.submit(Query.or_(vocab[0]), deadline_s=-1.0)
    shed = [tight.submit(Query.or_(v)) for v in vocab[:8]]
    tight.run_until_idle()
    n_shed = sum(t.result.status == "overloaded" for t in shed)
    print(f"deadline at admission -> {late.result.status}; "
          f"queue of 4 shed {n_shed} of 8 submits")

    # -- scripted faults: dispatch fails once, retry succeeds; a second
    # server fails always and degrades to the host planner -------------
    flaky = QueryServer(ix, faults=FaultInjector.script(
        {"dispatch_raise": [True]}))
    once = flaky.submit(Query.and_(vocab[0], vocab[1]))
    flaky.run_until_idle()
    print(f"fail-once: status={once.result.status} "
          f"retries={once.telemetry.retries} "
          f"degraded={once.telemetry.degraded}")

    broken = QueryServer(ix, faults=FaultInjector.script(
        {"dispatch_raise": "always"}))
    always = broken.submit(Query.and_(vocab[0], vocab[1]))
    broken.run_until_idle()
    assert always.result.value == ix.query_and(vocab[0], vocab[1])
    print(f"fail-always: status={always.result.status} "
          f"degraded={always.telemetry.degraded} "
          "(host result bit-identical)")
    return {"n_docs": ix.n_docs, "terms": len(ix.postings),
            "answers": [t.result.value for t in tickets],
            "resolved_ok": st.resolved_ok, "batches": st.batches,
            "late": late.result.status, "shed": n_shed,
            "once": (once.result.status, once.telemetry.retries,
                     once.telemetry.degraded),
            "always": (always.result.status, always.telemetry.degraded)}


if __name__ == "__main__":
    main()
