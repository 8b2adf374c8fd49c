"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), on the CPU through the plain versions.

* ``torch_quickstart`` and ``torch_query_server`` run at their default
  sizes, as the JAX examples do (they take no size flags): both print the
  same lines, a timing field aside.
* ``torch_analytics_index`` (2,000 documents over 40 terms),
  ``torch_constrained_serve`` (4 new tokens) and ``torch_train_tiny_lm``
  (3 steps of 4 x 32 tokens) run small, and their values are held against
  the JAX package's functions on the same seeded inputs: query answers,
  Jaccard and similarity scores, archive bytes and the Table-3 union; the
  constraint's size and the paged KV accounting; the parameter count, the
  pipeline's documents and each step's learning rate.  The model's
  weights are each package's own random draws, so tokens and losses are
  not compared here (``tests/test_torch_train_bf16.py`` holds training).
* With no ``--device`` every example asks for the card, so here it raises.
"""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TIMING = re.compile(r"\d+\.\d+ ?m?s\b|in \d+ ms")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    return [TIMING.sub("<t>", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "query_server"])
def test_prints_the_jax_examples_lines(capsys, name):
    _load(name).main()
    want = capsys.readouterr().out
    out = _load(f"torch_{name}").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert out                              # the values it printed


def test_quickstart_values():
    from repro.core import RoaringBitmap as JBitmap
    out = _load("torch_quickstart").main(
        ["--device", "cpu", "--values", "20000", "--batch-values", "3000"])
    rng = np.random.default_rng(0)
    a = JBitmap.from_values(rng.integers(0, 1 << 24, 20000))
    b = JBitmap.from_range(1 << 20, (1 << 20) + 2_000_000).run_optimize()
    assert (out["a"], out["b"]) == (a.cardinality, b.cardinality)
    assert out["and_card"] == a.and_card(b)
    assert out["jaccard"] == a.jaccard(b)
    u = a | b
    assert out["union"] == u.cardinality
    assert out["bits_per_value"] == u.bits_per_value()


def test_query_server_answers():
    from repro.data.index import InvertedIndex as JIndex
    out = _load("torch_query_server").main(
        ["--device", "cpu", "--docs", "400", "--terms", "20"])
    rng = np.random.default_rng(3)
    vocab = [f"t{i}" for i in range(20)]
    docs = [[vocab[j] for j in rng.choice(20, size=int(rng.integers(3, 12)),
                                          replace=False)]
            for _ in range(400)]
    ix = JIndex().build(docs)
    assert (out["n_docs"], out["terms"]) == (ix.n_docs, len(ix.postings))
    # the first tick's queries, drawn as the example draws them
    for i, got in enumerate(out["answers"]):
        terms = tuple(vocab[j] for j in rng.choice(20, 3, replace=False))
        if i % 8 == 7:
            want = [t for t, _ in ix.similar(terms[0], top_k=5)]
            assert [t for t, _ in got] == want
            continue
        kind = ("and", "or", "xor", "threshold")[i % 4]
        want = ix.query_threshold(terms, 2) if kind == "threshold" else \
            getattr(ix, f"query_{kind}")(*terms)
        assert np.array_equal(got.to_array(), want.to_array())
    assert (out["resolved_ok"], out["batches"], out["late"], out["shed"],
            out["once"], out["always"]) == \
        (32, 1, "deadline", 4, ("ok", 1, False), ("ok", True))


def test_analytics_index_against_jax(tmp_path):
    from repro.core import RoaringBitmap as JBitmap
    from repro.core.arena import BitmapArena as JArena
    from repro.data.index import InvertedIndex as JIndex
    from repro.data.pipeline import StreamingIndexBuilder as JBuilder
    from repro.data.synth import TABLE3, generate_dataset
    mod = _load("torch_analytics_index")
    out = mod.main(["--device", "cpu", "--docs", "2000", "--terms", "40"])
    docs = mod.synthetic_docs(2000, 40)
    ix = JIndex().build(docs).optimize()
    q = ("t0", "t1", "t2")
    assert out["memory"] == ix.memory_bytes()

    def same(got, want):
        assert np.array_equal(got.to_array(), want.to_array())
    same(out["hits_and"], ix.query_and(*q))
    same(out["hits_or"], ix.query_or(*q))
    same(out["andnot"], ix.query_andnot("t0", "t1", "t2", "t3"))
    assert out["jaccard"] == ix.jaccard("t0", "t1")
    terms = [f"t{i}" for i in range(8)]
    for t_min, got in zip((2, 4, 6), out["threshold"], strict=True):
        same(got, ix.query_threshold(terms, t_min))
    same(out["weighted"], ix.query_threshold(
        terms, 6, weights=[3 if i >= 4 else 1 for i in range(8)]))
    assert out["similar"] == ix.similar("t0", top_k=5)
    assert out["cosine"] == [ix.similar(t, top_k=5, metric="cosine")
                             for t in ("t0", "t1", "t2", "t3")]
    warm = JIndex(arena=JArena()).build(docs).optimize()
    warm.arena.adopt_many(warm.postings.values())
    warm.query_or(*q)
    assert out["arena_rows"] == warm.arena.n_rows
    assert out["warm_moved"] == (0, 0)
    warm.add_document(2000, ["t0", "t5"])
    warm.query_or(*q)
    assert out["patched"] == warm.arena.stats.rows_patched
    ix.add_document(2000, ["t0", "t5"])
    same(out["edited"], ix.query_or(*q))
    assert out["sharded"] == ix.similar("t0", top_k=5)
    path = str(tmp_path / "a.snap")
    builder = JBuilder(path, segment_bytes=1 << 20)
    for doc_id, doc_terms in enumerate(docs):
        builder.add_document(doc_id, doc_terms)
    builder.finalize()
    assert out["archive_bytes"] == Path(path).stat().st_size
    assert out["cold_rows"] == out["arena_rows"]
    wide = JBitmap.or_many([JBitmap.from_values(s).run_optimize() for s in
                            generate_dataset(TABLE3[0], seed=0)[:50]])
    same(out["census"], wide)
    assert out["census"].bits_per_value() == wide.bits_per_value()


def test_analytics_index_shards_on_one_device(capsys):
    out = _load("torch_analytics_index").main(
        ["--device", "cpu", "--docs", "500", "--terms", "40",
         "--shards", "3"])
    text = capsys.readouterr().out
    assert "sharded similar() over 3 shards: warm re-query moved 0" in text
    assert [t for t, _ in out["sharded"]] == [t for t, _ in out["similar"]]


def test_constrained_serve_against_jax():
    from repro.serve.constrained import lexicon_constraint
    from repro.serve.kv_cache import PagedKVAllocator
    new = 4
    out = _load("torch_constrained_serve").main(
        ["--device", "cpu", "--new-tokens", str(new)])
    lexicons = {"digits": np.arange(16, dtype=np.uint32),
                "ops": np.arange(100, 110, dtype=np.uint32)}
    c = lexicon_constraint(512, lexicons, ["digits", "ops"])
    assert (out["n_allowed"], out["containers"]) == \
        (c.n_allowed(), len(c.allowed.containers)) == (26, 1)
    assert out["tokens"].shape == (4, new)
    assert set(out["tokens"].ravel().tolist()) <= \
        set(range(16)) | set(range(100, 110))
    # the JAX engine's page accounting for 4 prompts of 16 and the new
    # tokens in a cache of 512 positions
    alloc = PagedKVAllocator(n_pages=max(64, 4 * 512 // 128), page_size=128)
    for i in range(4):
        alloc.extend(i, 16)
    for t in range(new):
        for i in range(4):
            alloc.extend(i, 16 + t + 1)
    assert (out["pages_in_use"], out["n_pages"], out["fragmentation"]) == \
        (alloc.n_pages - alloc.n_free, alloc.n_pages, alloc.fragmentation())
    for sid in list(alloc.tables):
        alloc.release(sid)
    assert out["free"] == alloc.n_free == alloc.n_pages


def test_train_tiny_lm_against_jax(tmp_path):
    import repro.configs as JC
    from repro.data.pipeline import RoaringDataPipeline as JPipe
    from repro.data.pipeline import quality_filter as jquality
    from repro.optim.adamw import AdamWConfig, lr_at
    steps = 3
    out = _load("torch_train_tiny_lm").main(
        ["--device", "cpu", "--steps", str(steps), "--seq-len", "32",
         "--batch-size", "4", "--ckpt-dir", str(tmp_path)])
    cfg = dataclasses.replace(JC.get_config("qwen2_5_3b", reduced=True),
                              d_model=256, n_layers=4, d_ff=1024, vocab=2048,
                              n_heads=8, n_kv_heads=2)
    assert out["params"] == cfg.params_count()
    scores = np.random.default_rng(0).random(4096)
    pipe = JPipe(n_docs=4096, seq_len=32, batch_size=4, vocab=cfg.vocab,
                 seed=0, filters={"quality": jquality(scores, 0.2)})
    assert out["kept"] == pipe.keep.cardinality
    for _ in range(steps):
        pipe.next_batch()
    assert out["steps"] == steps
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps,
                      weight_decay=0.01)
    for h in out["history"]:
        assert h["lr"] == pytest.approx(float(lr_at(opt, h["step"])),
                                        rel=1e-6)
        assert np.isfinite(h["loss"])
    assert out["pipeline_seen"] == sorted(pipe.seen.to_array().tolist())


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_query_server",
                                  "torch_analytics_index",
                                  "torch_constrained_serve",
                                  "torch_train_tiny_lm"])
def test_default_device_is_the_card(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
